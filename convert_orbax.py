"""Turn an orbax checkpoint directory of the JAX package (unet_tpu) into a
.pth that the PyTorch port (unet_tpu_torch) loads.

    python convert_orbax.py CKPT_DIR OUT.pth [--arch ARCH]

CKPT_DIR is a directory written by `unet_tpu.core.checkpoint.save_variables`
(inference variables) or `save_checkpoint` (a train state, whose parameters
and BatchNorm statistics are kept). OUT.pth holds {"model": state dict},
the reference's container, and OUT.meta.json beside it holds {"config":
{"arch", "num_classes"}}, so that `python -m unet_tpu_torch.cli
infer|evaluate|export --model OUT.pth` builds the model of its family.
ARCH is a family as `cli --arch` names it (nested_unet,
nested_unet_resnet50, simple_unet, lightweight:<encoder>); without it the
family is found for the first three, by which of them takes every array
of the checkpoint.

The script runs where the JAX package runs (jax, flax, orbax). The port
never imports it: orbax and tensorstore are not on the card's machine, and
the directory's OCDBT nodes are zstd-compressed.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

FAMILIES = ("nested_unet", "nested_unet_resnet50", "simple_unet")


def _size(tree) -> int:
    if isinstance(tree, dict):
        return sum(_size(v) for v in tree.values())
    return int(np.asarray(tree).size)


def detect_arch(variables: Dict[str, Any]) -> str:
    """The one reference family whose conversion takes every array of
    `variables`."""
    from unet_tpu_torch.models import convert

    want = _size({k: variables[k] for k in ("params", "batch_stats") if k in variables})
    hits = [a for a in FAMILIES
            if sum(t.numel() for k, t in convert.state_dict_from_flax(variables, a).items()
                   if not k.endswith("num_batches_tracked")) == want]
    if len(hits) != 1:
        raise SystemExit(f"cannot tell the model family ({hits or 'none'} of "
                         f"{', '.join(FAMILIES)} fits); pass --arch")
    return hits[0]


def convert(ckpt_dir: str, out: str, arch: Optional[str] = None) -> Dict[str, Any]:
    """Write `out` (.pth) and its sidecar from the orbax directory
    `ckpt_dir`; returns the sidecar's config."""
    from unet_tpu.core.checkpoint import load_model_variables
    from unet_tpu_torch.models import convert as port_convert

    import torch

    if not Path(ckpt_dir).is_dir():
        raise SystemExit(f"{ckpt_dir}: not an orbax checkpoint directory")
    variables, _ = load_model_variables(ckpt_dir)
    arch = arch or detect_arch(variables)
    sd = port_convert.state_dict_from_flax(variables, arch)
    if "final.weight" not in sd:
        raise SystemExit(f"{ckpt_dir}: no final layer for arch {arch!r}")
    config = {"arch": arch, "num_classes": port_convert.infer_num_classes(sd)}
    path = Path(out)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model": sd}, path)
    meta = path.with_name(path.name[:-len(path.suffix)] + ".meta.json")
    meta.write_text(json.dumps({"config": config}, indent=2))
    return config


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ckpt_dir")
    ap.add_argument("out")
    ap.add_argument("--arch", default=None)
    args = ap.parse_args(argv)
    config = convert(args.ckpt_dir, args.out, args.arch)
    print(f"{args.ckpt_dir} -> {args.out} ({config['arch']}, {config['num_classes']} classes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
