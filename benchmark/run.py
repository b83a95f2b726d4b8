"""Run one cell of the benchmark once, on the card this process finds.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints one JSON line last on standard output
(`correct`, `attempted`, `failed`, `metrics`, `device`, with `--trace 1`
`breakdown`, and `checks` last: each number compared with its limit), and
the same checks as the last lines of standard error. Without a card, or
with fewer cards than the cell asks for, it exits with 2 and prints no
result; it never falls back to the CPU. If the process has loaded JAX, flax
or the JAX package by the time the window has closed, it exits with 3 and
prints no result.
"""
import time

T0 = time.perf_counter()   # set-up counts from the process's start

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "unet_tpu", "bench")   # top-level module names
FORBIDDEN_MODULES = ("unet_tpu_torch.bench",)


def _caches_in_checkout() -> None:
    """Every kernel cache the program or its libraries may write, at fixed
    paths inside the checkout (the port's own nvcc builds go to
    build/kernels/ by themselves)."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(ROOT / "build" / "inductor")


def forbidden_loaded() -> list:
    """The loaded modules whose top-level name (the part before the first
    dot, compared whole) is JAX's, flax's or the JAX package's, and the
    port's own bench module."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN or m in FORBIDDEN_MODULES)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches_in_checkout()

    from benchmark import cell, spec

    sp = spec.load(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < sp.cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: cell {args.workload} needs {sp.cell['chips']} CUDA card(s), this "
              f"process finds {found}; no result (no CPU fallback)", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result = cell.run(sp, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    bad = forbidden_loaded()
    if bad:
        print(f"benchmark: the process loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    check_lines = result.pop("check_lines")
    print(result.pop("card_line"), file=sys.stderr)
    print(json.dumps(result), flush=True)
    print("\n".join(check_lines), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
