"""Parity of the port's CC propagation (unet_tpu_torch.ops.cc_kernels) and
its consumers with the JAX package, bit-identical, including truncated runs:
the plain version follows the reference's schedule, so it equals the JAX
loop at every `max_iters`, not only at the fixpoint."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from unet_tpu.ops import cc as jcc
from unet_tpu.ops import edges as jedges
from unet_tpu_torch.ops import cc, cc_kernels, edges


def _masks(rng):
    """The masks of tests/test_cc_pallas.py::_masks."""
    H, W = 64, 128
    noise = rng.random((2, H, W)) < 0.35          # dense worst-case
    snake = np.zeros((1, H, W), bool)             # long snaking contour
    snake[0, 10:12, 5:100] = True
    snake[0, 12:40, 98:100] = True
    snake[0, 40:42, 20:100] = True
    blobs = np.zeros((1, H, W), bool)             # separated blobs + border
    blobs[0, 5:15, 5:25] = True
    blobs[0, 30:34, 60:90] = True
    blobs[0, 0:3, 125:128] = True
    empty = np.zeros((1, H, W), bool)
    return [noise, snake, blobs, empty]


def _serpentine(H=64, W=128):
    """A one-pixel-wide boustrophedon: needs many iterations to converge."""
    m = np.zeros((1, H, W), bool)
    for i, r in enumerate(range(1, H - 1, 4)):
        m[0, r, 1:W - 1] = True
        c = W - 2 if i % 2 == 0 else 1
        m[0, r:r + 4, c] = True
    return m


@pytest.mark.parametrize("max_iters", [1, 2, 3, 64])
@pytest.mark.parametrize("case", range(5))
def test_propagate_plain_matches_cc_bbox(rng, case, max_iters):
    mask = (_masks(rng) + [_serpentine()])[case]
    fg = torch.from_numpy(mask)
    out = cc_kernels.propagate_plain(cc._bbox_seed_state(fg), fg, pool_iters=4,
                                     max_iters=max_iters).numpy()
    for i in range(mask.shape[0]):
        lab, mnr, mxr, mnc, mxc, _ = jcc._cc_bbox_single(jnp.asarray(mask[i]),
                                                         max_iters)
        f = mask[i]
        assert np.array_equal(np.where(f, out[i, 0], -1), np.asarray(lab))
        assert np.array_equal(np.where(f, -out[i, 1], 0), np.where(f, mxr, 0))
        assert np.array_equal(np.where(f, out[i, 2], 0), np.where(f, mnc, 0))
        assert np.array_equal(np.where(f, -out[i, 3], 0), np.where(f, mxc, 0))
        # background keeps its seeds
        seed = cc._bbox_seed_state(fg).numpy()[i]
        assert np.array_equal(np.where(f, 0, out[i]), np.where(f, 0, seed))


@pytest.mark.parametrize("connectivity", [4, 8])
def test_propagate_plain_labels_match_connected_components(rng, connectivity):
    mask = _masks(rng)[0]
    B, H, W = mask.shape
    fg = torch.from_numpy(mask)
    state0 = cc._label_seed(H, W)[None, None].expand(B, 1, H, W).contiguous()
    out = cc_kernels.propagate(state0, fg, pool_iters=16, max_iters=64,
                               connectivity=connectivity).numpy()
    ref = np.asarray(jcc.connected_components(jnp.asarray(mask),
                                              connectivity=connectivity))
    assert np.array_equal(np.where(mask, out[:, 0], -1), ref)


def _hysteresis_cases(rng):
    """The cases of tests/test_cc_pallas.py::test_hysteresis_pallas_path_matches."""
    H, W = 64, 128
    noise_strong = rng.random((2, H, W)) < 0.05
    noise_weak = np.logical_and(rng.random((2, H, W)) < 0.25,
                                np.logical_not(noise_strong))
    snake_weak = np.zeros((1, H, W), bool)
    snake_weak[0, 10:12, 5:100] = True
    snake_weak[0, 12:40, 98:100] = True
    snake_weak[0, 40:42, 20:100] = True
    snake_strong = np.zeros((1, H, W), bool)
    snake_strong[0, 10, 5] = True
    serp = _serpentine()
    serp_strong = np.zeros_like(serp)
    serp_strong[0, 1, 1] = True
    only_strong = np.zeros((1, H, W), bool)
    only_strong[0, 5:8, 5:50] = True
    none = np.zeros((1, H, W), bool)
    return [(noise_strong, noise_weak), (snake_strong, snake_weak),
            (serp_strong, serp & ~serp_strong), (only_strong, none),
            (none, snake_weak)]


@pytest.mark.parametrize("cc_iters", [1, 2, 3, 64])
@pytest.mark.parametrize("case", range(5))
def test_hysteresis_matches(rng, case, cc_iters):
    strong, weak = _hysteresis_cases(rng)[case]
    got = edges.hysteresis(torch.from_numpy(strong), torch.from_numpy(weak),
                           cc_iters=cc_iters).numpy()
    want = np.asarray(jedges.hysteresis(jnp.asarray(strong), jnp.asarray(weak),
                                        cc_iters=cc_iters))
    assert np.array_equal(got, want)


def _gate_mask(rng):
    mask = rng.random((3, 64, 128)) < 0.2
    mask[1] = False
    mask[1, 5:10, 5:10] = True       # area 25 < 30: dropped
    mask[1, 20:26, 20:28] = True     # 48: kept
    mask[1, 40:44, 20:50] = True     # aspect 7.5: dropped
    mask[1, 5:25, 60:90] = True      # 600: kept
    mask[1, 30:60, 95:125] = True    # 900 > 800: dropped
    mask[1, 50:52, 5:8] = True       # 2 rows: height not > 3, dropped
    mask[2] = False
    return mask


@pytest.mark.parametrize("no_onehot", ["0", "1"])
def test_filter_components_two_stage_gates(rng, monkeypatch, no_onehot):
    mask = _gate_mask(rng)
    args = dict(min_area=30, max_area=800, max_aspect=5.0, min_w=3, min_h=3,
                strict_min_wh=False)
    monkeypatch.setenv("UNET_TPU_CC_NO_ONEHOT", no_onehot)
    want = np.asarray(jcc.filter_components_by_geometry(jnp.asarray(mask), **args))
    got = cc.filter_components_by_geometry(torch.from_numpy(mask), **args).numpy()
    assert np.array_equal(got, want)
    assert got[1].any() and not got[2].any()


def test_filter_components_strict_gates(rng):
    mask = _gate_mask(rng)
    args = dict(min_area=5, max_area=200, max_aspect=6.0, min_w=2, min_h=2,
                strict_min_wh=True)
    want = np.asarray(jcc.filter_components_by_geometry(jnp.asarray(mask), **args))
    got = cc.filter_components_by_geometry(torch.from_numpy(mask), **args).numpy()
    assert np.array_equal(got, want)


def test_propagate_dispatch_and_checks(rng):
    mask = torch.from_numpy(_masks(rng)[1])
    state0 = cc._bbox_seed_state(mask)
    before = cc_kernels.launches
    out = cc_kernels.propagate(state0, mask, pool_iters=4, max_iters=64)
    assert cc_kernels.launches == before      # CPU: plain version, no launch
    assert torch.equal(out, cc_kernels.propagate_plain(
        state0, mask, pool_iters=4, max_iters=64))
    with pytest.raises(ValueError):
        cc_kernels.propagate(state0.to(torch.int64), mask, pool_iters=4, max_iters=2)
    with pytest.raises(ValueError):
        cc_kernels.propagate(state0, mask[:, :-1], pool_iters=4, max_iters=2)
    with pytest.raises(ValueError):
        cc_kernels.propagate(state0, mask, pool_iters=4, max_iters=2,
                             connectivity=6)
    with pytest.raises(ValueError):
        cc_kernels.propagate(state0.to("meta"), mask.to("meta"), pool_iters=4,
                             max_iters=2)


@pytest.mark.parametrize("H,W,want", [
    (448, 384, ("cluster", 8)),       # two_stage crop
    (448, 512, ("cluster", 8)),       # enhanced crop
    (445, 383, ("cluster", 8)),       # short last stripe, W not a multiple of 32
    (449, 512, ("cluster", 8)),
    (64, 128, ("cluster", 8)),        # the tests' masks
    (5, 40, ("cluster", 8)),          # fewer rows than CTAs
    (448, 800, ("cluster", 16)),      # frame-sized labels: 56 rows a thread are too many
    (1024, 1024, ("global", None)),   # over the shared-memory and register budget
    (2048, 2448, ("global", None)),
])
def test_route_by_plane_shape(H, W, want):
    assert cc_kernels.route(H, W) == want


def test_cluster_shared_memory_budget():
    """The budget csrc/cc_propagate.cu's header reckons, and every plane the
    cluster route takes fits a CTA's shared memory."""
    assert cc_kernels.cluster_smem_bytes(448, 384, 8) == 99944
    assert cc_kernels.cluster_smem_bytes(448, 512, 8) == 133096
    assert cc_kernels.cluster_smem_bytes(448, 800, 16) == 115064
    for H, W in ((448, 384), (448, 512), (448, 800), (512, 1024), (1024, 512)):
        which, K = cc_kernels.route(H, W)
        assert which == "cluster"
        assert cc_kernels.cluster_smem_bytes(H, W, K) <= cc_kernels.SMEM_LIMIT
    assert not cc_kernels.cluster_fits(448, 800, 8)


def _column_combine(v, f, stripes):
    """numpy model of the cluster kernel's column run-min across stripes.
    v: (H, W) values with background at INT32_MAX; f: (H, W) mask. Each of
    `stripes` stripes of ceil(H / stripes) rows scans its own rows, publishes
    per column the min of the run touching its top row, of the run touching
    its bottom row, and whether it is all foreground; then chains the other
    stripes' summaries into the minimum carried in at each end, and applies
    it to the runs that touch its ends."""
    INF = cc_kernels.INT32_MAX
    H, W = v.shape
    S = -(-H // stripes)
    segs, sums = [], []
    for k in range(stripes):
        r0 = min(k * S, H)
        R = min(S, H - r0)
        x, m = v[r0:r0 + R].copy(), f[r0:r0 + R]
        for order in (range(R), reversed(range(R))):
            run = np.full(W, INF, np.int64)
            for i in order:
                run = np.where(m[i], np.minimum(run, x[i]), INF)
                x[i] = run
        inf = np.full(W, INF, np.int64)
        sums.append((x[0] if R else inf, x[R - 1] if R else inf, m.all(0)))
        segs.append((r0, R, x, m))
    out = v.copy()
    for k, (r0, R, x, m) in enumerate(segs):
        if R == 0:        # a trailing stripe past the last row
            continue
        carried = []
        for js, end in ((range(k - 1, -1, -1), 1), (range(k + 1, stripes), 0)):
            c = np.full(W, INF, np.int64)
            open_ = np.ones(W, bool)
            for j in js:
                c = np.where(open_, np.minimum(c, sums[j][end]), c)
                open_ &= sums[j][2]
            carried.append(c)
        rows = np.arange(R)[:, None]
        gap = ~m
        head = np.where(gap.any(0), gap.argmax(0), R)                  # rows [0, head)
        tail = np.where(gap.any(0), R - 1 - gap[::-1].argmax(0), -1)   # rows (tail, R)
        x = np.where(rows < head, np.minimum(x, carried[0]), x)
        x = np.where(rows > tail, np.minimum(x, carried[1]), x)
        out[r0:r0 + R] = x
    return out


@pytest.mark.parametrize("density", [0.3, 0.7, 0.95])
@pytest.mark.parametrize("stripes", [1, 2, 8, 16])
def test_column_combine_model_matches_run_min(rng, stripes, density):
    """The cross-stripe column combine equals one segmented run-min along
    whole columns, on random masks whose 70 rows leave the last stripes
    short (or, at 16, empty), plus stripes forced all foreground or all
    background."""
    H, W = 70, 33
    f = rng.random((H, W)) < density
    f[10:15] = True
    f[40:45, ::2] = False
    v = rng.integers(0, 1000, (H, W)).astype(np.int64)
    got = _column_combine(np.where(f, v, cc_kernels.INT32_MAX), f, stripes)
    want = cc_kernels._run_min(torch.from_numpy(v), torch.from_numpy(f), -2).numpy()
    assert np.array_equal(np.where(f, got, v), want)


@pytest.mark.cuda
def test_propagate_kernel_matches_plain_on_card(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    for mask in _masks(rng) + [_serpentine()]:
        fg = torch.from_numpy(mask).cuda()
        state0 = cc._bbox_seed_state(fg)
        for max_iters in (1, 2, 64):
            got = cc_kernels.propagate(state0, fg, pool_iters=4, max_iters=max_iters)
            want = cc_kernels.propagate_plain(state0, fg, pool_iters=4,
                                              max_iters=max_iters)
            assert torch.equal(got, want)
