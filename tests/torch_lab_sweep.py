"""The port's CIELAB transform against the JAX package's over all 2**24 BGR
colours, on the CPU: the numbers behind the Lab tolerance of
tests/test_torch_enhance.py and the choice of cube root in
unet_tpu_torch/ops/color.py.

    python tests/torch_lab_sweep.py          # about 2 minutes on 8 cores

Prints one line per cube-root form (the port's float32 `pow`, and a
correctly rounded root for comparison): the max |dL|, |da|, |db| and the
number of colours whose round(L) differs, with the largest distance of such
an L from a .5 tie. The other float differences are printed by the parity
tests themselves (`python -m pytest tests/test_torch_*.py -q -s`).
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from unet_tpu.ops import color as jcolor  # noqa: E402
from unet_tpu_torch.ops import color  # noqa: E402

CBRT_FORMS = {
    "float32 pow(t, 1/3) (the port's)": lambda t: torch.pow(t, 1.0 / 3.0),
    "float64 root rounded to float32": lambda t: torch.pow(t.double(), 1.0 / 3.0).float(),
}


def _maxabs(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def main() -> None:
    lab = jax.jit(jcolor.bgr2lab)
    port_cbrt = color._cbrt
    stats = {name: dict(err=[0.0, 0.0, 0.0], flips=0, tie=0.0) for name in CBRT_FORMS}
    n = 1 << 24
    try:
        for s in range(0, n, 1 << 20):
            i = np.arange(s, s + (1 << 20), dtype=np.int64)
            bgr = np.stack([(i >> 16) & 255, (i >> 8) & 255, i & 255], -1).astype(np.float32)
            want = [np.asarray(v) for v in lab(jnp.asarray(bgr))]
            for name, form in CBRT_FORMS.items():
                color._cbrt = form
                got = [v.numpy() for v in color.bgr2lab(torch.from_numpy(bgr))]
                st = stats[name]
                st["err"] = [max(e, _maxabs(g, w)) for e, g, w in zip(st["err"], got, want)]
                d = np.round(got[0]) != np.round(want[0])
                st["flips"] += int(d.sum())
                if d.any():
                    f = want[0][d]
                    st["tie"] = max(st["tie"], float(np.abs(np.abs(f - np.floor(f)) - 0.5).max()))
    finally:
        color._cbrt = port_cbrt
    for name, st in stats.items():
        e = st["err"]
        print(f"bgr2lab with {name}, all 2**24 colours: max |dL| {e[0]:.3g}, |da| {e[1]:.3g}, "
              f"|db| {e[2]:.3g}; round(L) differs for {st['flips']} colours, each within "
              f"{st['tie']:.2g} of a .5 tie")


if __name__ == "__main__":
    main()
