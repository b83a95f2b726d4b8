"""What decides `correct`: the outputs that the timed calls produced,
judged against the plain reference (`reference/`) on the same frames and
weights, and each number beside its limit from the cell's workload file.

The numbers, over every judged frame:
  regret_max     the model stage. At each frame pixel outside the burr
                 mask the class that the program set stands for a model
                 class at the nearest model pixel. Its regret is how far
                 the reference's logit of that class lies below the
                 reference's best logit there. A sound lower-precision
                 forward flips only near-ties; a coarser one flips pixels
                 whose regret is large. (The burr mask overwrites any
                 class: its pixels have no regret.)
  regret_mean    the mean regret over the pixels whose regret is above 0:
                 the scale of the program's logit error, steadier from
                 seed to seed than the widest gap, and blind to how many
                 near-ties a seed's frames hold.
  flip_share     the share of the ROI's pixels whose regret is above 0.
  burr_diff      the burr stage (the edges, with B1 in Canny's
                 hysteresis, morphology, the CC filter with B1) and what
                 feeds it (the enhance stage with B2, in a preset that has
                 one): the pixels where the
                 program's burr mask differs from the reference's burr
                 stage, as a share of the reference's burr pixels (of one
                 pixel where it has none). The reference's stage runs on
                 its own conditioned frame and on the program's cable mask
                 as the class map shows it; where the burr mask hides the
                 class, the reference's own cable mask stands in. A burr
                 mask that floods the band reads far above 1, one that is
                 dropped reads 1.
  count_diff     the counts: |burr_px - burr pixels of the class map| +
                 how far cable_px and tape_px each lie outside [their
                 pixels, their pixels + burr pixels] (the burr mask
                 overwrites either) + how far cable_px + tape_px exceeds
                 the three classes' pixels (cable and tape exclude each
                 other).
  roi_px         cable or tape pixels outside the ROI.
  missing        judged frames planned less judged frames received.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from .reference import image as ref_image
from .reference import pipeline as ref_pipeline

NUMBERS = ("regret_max", "regret_mean", "flip_share", "burr_diff", "count_diff", "roi_px", "missing")


class Judged(NamedTuple):
    """One frame's input and what the program returned for it."""
    frame: torch.Tensor        # (H, W, 3) uint8
    class_map: torch.Tensor    # (H', W') uint8
    counts: torch.Tensor       # (3,) int: cable_px, tape_px, burr_px


def _regret(logits: torch.Tensor, cm: torch.Tensor, pc: dict):
    """Per-pixel regret (B, H, W) of the program's classes `cm` against the
    reference logits (B, C, h, w), and the ROI mask."""
    B, H, W = cm.shape
    h, w = logits.shape[-2:]
    rows = torch.from_numpy(ref_image._nearest_indices(H, h)[0]).to(cm.device)
    cols = torch.from_numpy(ref_image._nearest_indices(W, w)[0]).to(cm.device)
    lf = logits.index_select(2, rows).index_select(3, cols)
    best = lf.amax(dim=1)
    cls = torch.where(cm == 3, 0, cm).long().clamp(max=lf.shape[1] - 1)
    chosen = torch.where(cm == 3, best, lf.gather(1, cls[:, None]).squeeze(1))
    y1, y2, x1, x2 = ref_pipeline.roi_box(pc, (H, W))
    roi = torch.zeros((H, W), dtype=torch.bool, device=cm.device)
    roi[max(y1, 0):min(y2, H), max(x1, 0):min(x2, W)] = True
    return torch.where(roi, best - chosen, 0.0), roi


def _burr(ref, cm: torch.Tensor, pc: dict):
    """(pixels where the program's burr and the reference's differ, the
    reference's burr pixels) over a block."""
    H, W = cm.shape[-2:]
    ref_cable = ref_pipeline.masks_to_frame(torch.argmax(ref.logits, dim=1), (H, W), pc)[0]
    cable = (cm == 1) | ((cm == 3) & ref_cable)
    with torch.inference_mode():
        want = ref_pipeline.burr(ref.gray, cable, pc)
    return int((want != (cm == 3)).sum()), int(want.sum())


def judge(items: Sequence[Judged], sd: Dict[str, torch.Tensor], pc: dict, planned: int,
          block: int = 8) -> Dict[str, float]:
    """The numbers of `items`, the reference run in blocks of `block`
    frames on the frames' device."""
    out = dict.fromkeys(NUMBERS, 0.0)
    out["missing"] = float(max(planned - len(items), 0))
    flips = roi_total = burr_diff = burr_ref = 0
    regret_sum = 0.0
    for s in range(0, len(items), block):
        part = items[s:s + block]
        frames = torch.stack([j.frame for j in part])
        cm = torch.stack([j.class_map for j in part]).to(frames.device)
        counts = torch.stack([j.counts for j in part]).to(frames.device).long()
        ref = ref_pipeline.run(frames, sd, pc)
        if cm.shape != ref.class_map.shape:
            raise ValueError(f"class maps {tuple(cm.shape)}, "
                             f"reference {tuple(ref.class_map.shape)}")
        regret, roi = _regret(ref.logits, cm, pc)
        out["regret_max"] = max(out["regret_max"], float(regret.max()))
        flips += int((regret > 0).sum())
        regret_sum += float(regret.sum())
        roi_total += int(roi.sum()) * len(part)
        d, r = _burr(ref, cm, pc)
        burr_diff, burr_ref = burr_diff + d, burr_ref + r
        n = [(cm == k).sum(dim=(1, 2)) for k in range(4)]
        outside = lambda v, lo, hi: (lo - v).clamp(min=0) + (v - hi).clamp(min=0)
        excess = (counts[:, 0] + counts[:, 1] - n[1] - n[2] - n[3]).clamp(min=0)
        out["count_diff"] += float(((counts[:, 2] - n[3]).abs()
                                    + outside(counts[:, 0], n[1], n[1] + n[3])
                                    + outside(counts[:, 1], n[2], n[2] + n[3]) + excess).sum())
        out["roi_px"] += float((((cm == 1) | (cm == 2)) & ~roi).sum())
    out["flip_share"] = flips / roi_total if roi_total else 0.0
    out["regret_mean"] = regret_sum / flips if flips else 0.0
    out["burr_diff"] = burr_diff / max(burr_ref, 1)
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, Optional[float]]) -> bool:
    """Every number at or under its limit; a limit of None is a number
    reported and not compared (it has no control reading to lie under)."""
    return all(limits[k] is None or numbers[k] <= limits[k] for k in NUMBERS)


def lines(numbers: Dict[str, float], limits: Dict[str, Optional[float]]) -> List[str]:
    """`name value limit` for each number, for the end of standard error."""
    return [f"check {k} {numbers[k]!r} limit "
            f"{'none (not compared)' if limits[k] is None else repr(limits[k])}"
            for k in NUMBERS]
