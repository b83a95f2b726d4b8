"""Checkpoints of training (counterpart of unet_tpu/core/checkpoint.py:22-60):
one torch file per name with the whole train state, and the JAX package's
JSON sidecar.

`{ckpt_dir}/{name}.pth` holds {"model": the model's state dict, "optimizer",
"scheduler", "step", "accum": MultiSteps' accumulator, "rng": the host
generators of the data (so that a resumed run draws what an unbroken one
would)}; `{ckpt_dir}/{name}.meta.json` holds {"epoch", "best_miou",
"config"}, as the JAX package writes it. Its "model" entry is the
reference's container, so `cli infer`/`cli evaluate --model {name}.pth`
(models.convert.load_pth) and the JAX package's .pth loader read the
weights. The JAX package's orbax directories are read through
`convert_orbax.py` at the repository's root, which runs where the JAX
package runs and writes such a .pth with its sidecar: orbax, tensorstore
and its zstd-compressed nodes are not on the card's machine.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch


def checkpoint_path(ckpt_dir: str, name: str) -> Path:
    return Path(ckpt_dir) / f"{name}.pth"


def save_checkpoint(ckpt_dir: str, state, *, epoch: int, best_miou: float,
                    config: Optional[dict] = None, name: str = "best",
                    rng: Optional[dict] = None) -> str:
    """Write `state` (train.trainer.TrainState) and its sidecar; returns the
    .pth path."""
    path = checkpoint_path(ckpt_dir, name)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".pth.tmp")
    torch.save({**state.state_dict(), "rng": rng or {}}, tmp)
    tmp.replace(path)
    meta = {"epoch": epoch, "best_miou": best_miou, "config": config or {}}
    (Path(ckpt_dir) / f"{name}.meta.json").write_text(json.dumps(meta, indent=2))
    return str(path)


def restore_checkpoint(ckpt_dir: str, state, name: str = "best"
                       ) -> Tuple[Any, Dict[str, Any]]:
    """Load `{ckpt_dir}/{name}.pth` into `state` (in place); returns (state,
    meta), meta the sidecar's content plus "rng", the saved host
    generators' states."""
    path = checkpoint_path(ckpt_dir, name)
    if not path.is_file():
        raise FileNotFoundError(f"no checkpoint {path}")
    sd = torch.load(path, map_location=state.params[0].device, weights_only=False)
    state.load_state_dict(sd)
    meta_path = Path(ckpt_dir) / f"{name}.meta.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    meta["rng"] = sd.get("rng", {})
    return state, meta


def read_meta(pth: str) -> Dict[str, Any]:
    """The sidecar beside a checkpoint file (`best.pth` -> `best.meta.json`),
    or {} where there is none."""
    p = Path(pth)
    meta = p.with_name(p.name[:-len(p.suffix)] + ".meta.json") if p.suffix else None
    if meta is None or not meta.is_file():
        return {}
    return json.loads(meta.read_text())
