"""The spatial axis of the mesh: H stripes of the NestedUNet's activations
and the row transport between the ranks of a spatial group (the conv halo
exchanges that GSPMD inserts in the JAX package,
unet_tpu/parallel/mesh.py:8-13, placed by hand).

Layout. A spatial group of n ranks splits the model input's H rows into n
stripes whose bounds fall on multiples of UNIT = 16 rows (the NestedUNet's
four 2x2 pools), as even as that allows, the longer ones first
(`stripe_bounds`). Rank i holds rows [start_i, end_i) of every activation;
at level l of the encoder, rows [start_i >> l, end_i >> l) (`Stripes.down`).

Transport, on `all_gather_into_tensor` alone (NCCL takes it, and gloo takes
it for CUDA tensors too). Tensors travel as their bytes, so every dtype
does, and several tensors share one collective:
  * `exchange`: each rank gets the global rows it asks for, where every
    rank's request is known to all (a halo, an upsample's taps); each rank
    sends only the rows of its stripe that another rank asks for
  * `fetch_rows(x, lo, hi)`: the same where each rank knows only its own
    request (the requests are gathered first)
  * `halo(op, xs, stripes, r)`: `op`, unchanged, on the slab [start - r,
    end + r) clipped to [0, H), cropped back to [start, end): the op's own
    padding then applies only at the global top and bottom, as in the
    unsharded run
  * `up2x`: the rows of this rank's stripe of a x2 align-corners upsample,
    from the source rows that its taps read
  * the inspection step's two re-splits, `frames_to_stripes` (this rank's
    whole frames -> the H stripe of every frame of the slice) and
    `stripes_to_frames` (back), and `gather_frames`, every rank's outputs
    for its frames on every rank, in frame order
Each of them is a collective of the spatial group: every rank of it calls
it, with the same layout.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Any, Callable, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

UNIT = 16
Bounds = Tuple[Tuple[int, int], ...]


def stripe_bounds(height: int, n: int) -> Bounds:
    """[start, end) of each of n stripes of `height` model-input rows: on
    multiples of UNIT rows, as even as that allows, the longer stripes first
    (the last one may be shorter). ValueError where a rank would hold fewer
    than UNIT rows."""
    units, rest = divmod(height, UNIT)
    if n < 1 or rest or units < n:
        raise ValueError(
            f"{height} rows over {n} spatial ranks: stripe boundaries fall on multiples of "
            f"{UNIT} model-input rows (the NestedUNet's four 2x2 pools), and every rank "
            f"needs at least {UNIT} rows")
    q, r = divmod(units, n)
    bounds, s = [], 0
    for i in range(n):
        e = s + (q + (i < r)) * UNIT
        bounds.append((s, e))
        s = e
    return tuple(bounds)


def frame_split(b: int, n: int) -> Bounds:
    """(first frame, count) of each of n ranks over b frames: contiguous,
    as even as possible, the larger counts first; a rank may get none."""
    q, r = divmod(b, n)
    out, s = [], 0
    for i in range(n):
        c = q + (i < r)
        out.append((s, c))
        s += c
    return tuple(out)


@dataclass(frozen=True)
class Stripes:
    """The H layout of one activation over a spatial group: `bounds[i]` the
    rows of rank i, `index` this rank's, `group` the process group (None
    for one rank)."""
    bounds: Bounds
    index: int
    group: Any = None

    @property
    def n(self) -> int:
        return len(self.bounds)

    @property
    def start(self) -> int:
        return self.bounds[self.index][0]

    @property
    def end(self) -> int:
        return self.bounds[self.index][1]

    @property
    def rows(self) -> int:
        return self.end - self.start

    @property
    def height(self) -> int:
        return self.bounds[-1][1]

    def down(self, levels: int) -> "Stripes":
        """The layout after `levels` 2x2 pools."""
        k = 1 << levels
        if any(s % k or e % k for s, e in self.bounds):
            raise ValueError(f"stripes {self.bounds} do not pool {levels} times")
        return replace(self, bounds=tuple((s // k, e // k) for s, e in self.bounds))

    def at(self, rows: int) -> "Stripes":
        """The layout of the level (0 to 4) where this rank holds `rows`
        rows (distinct at every level: a stripe has at least UNIT rows)."""
        for level in range(5):
            if self.rows >> level == rows:
                return self.down(level)
        raise ValueError(f"no level of stripe {self.bounds[self.index]} holds {rows} rows")


# ---------------------------------------------------------------------------
# bytes
# ---------------------------------------------------------------------------

def _nbytes(shape: Sequence[int], dtype: torch.dtype) -> int:
    return int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()


def _to_bytes(t: torch.Tensor) -> torch.Tensor:
    """(m, ...) -> (m, bytes of one row) uint8."""
    return t.contiguous().view(torch.uint8).reshape(t.shape[0], _nbytes(t.shape[1:], t.dtype))


def _from_bytes(b: torch.Tensor, dtype: torch.dtype, shape: Sequence[int]) -> torch.Tensor:
    """(m, bytes) uint8 -> (m, *shape) of `dtype`."""
    return b.contiguous().view(dtype).reshape((b.shape[0],) + tuple(shape))


def pack(tree):
    """(spec, buffer) of a tree of (b, ...) tensors (NamedTuples nested,
    None kept): the buffer holds each sample's bytes in one (b, bytes)
    uint8 row (None without a tensor); `unpack` undoes it."""
    leaves = []

    def flatten(t):
        if t is None:
            return None
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t), [flatten(v) for v in t]
        leaves.append(t)
        return len(leaves) - 1

    structure = flatten(tree)
    spec = (structure, tuple((t.dtype, tuple(t.shape[1:])) for t in leaves))
    return spec, (torch.cat([_to_bytes(t) for t in leaves], 1) if leaves else None)


def unpack(spec, buf: torch.Tensor):
    """The tree of `pack`'s spec from a (b, bytes) buffer."""
    structure, metas = spec
    out, col = [], 0
    for dtype, shape in metas:
        nb = _nbytes(shape, dtype)
        out.append(_from_bytes(buf[:, col:col + nb], dtype, shape))
        col += nb

    def build(node):
        if node is None:
            return None
        if isinstance(node, int):
            return out[node]
        cls, kids = node
        return cls(*(build(k) for k in kids))

    return build(structure)


def all_gather(buf: torch.Tensor, group, n: int) -> torch.Tensor:
    """(n, *buf.shape): every rank's `buf` (the same shape on all) in rank
    order, in one `all_gather_into_tensor`."""
    if n == 1:
        return buf[None]
    out = buf.new_empty((n * buf.shape[0],) + tuple(buf.shape[1:]))
    if buf.numel():
        dist.all_gather_into_tensor(out, buf.contiguous(), group=group)
    return out.view((n,) + tuple(buf.shape))


# ---------------------------------------------------------------------------
# rows between the ranks
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1024)
def _plan(bounds: Bounds, wants: Bounds, index: int):
    """What `exchange` sends and picks: m, the most rows a rank sends; the
    rows (stripe-local) this rank sends; and the positions, in the gathered
    (n * m) rows, of the rows this rank asks for above and below its
    stripe."""
    send = []
    for i, (s, e) in enumerate(bounds):
        rows = set()
        for j, (lo, hi) in enumerate(wants):
            if j != i:
                rows.update(range(max(lo, s), min(hi, e)))
        send.append(sorted(rows))
    m = max(len(r) for r in send)
    where = {r: i * m + k for i, rows in enumerate(send) for k, r in enumerate(rows)}
    s, e = bounds[index]
    lo, hi = wants[index]
    mine = [r - s for r in send[index]] + [0] * (m - len(send[index]))
    return (m, tuple(mine), tuple(where[r] for r in range(lo, min(s, hi))),
            tuple(where[r] for r in range(max(e, lo), hi)))


@functools.lru_cache(maxsize=1024)
def _index(rows: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.tensor(rows, dtype=torch.int64, device=device)


def exchange(xs: Sequence[torch.Tensor], stripes: Stripes, wants: Bounds,
             axis: int) -> List[torch.Tensor]:
    """For each striped tensor of `xs` (this rank's rows along `axis`), the
    global rows [lo, hi) = wants[stripes.index], contiguous; `wants` holds
    every rank's request. One collective for all of `xs` (none where no rank
    asks for another's rows)."""
    s, e = stripes.start, stripes.end
    lo, hi = wants[stripes.index]
    m, mine, above, below = _plan(stripes.bounds, tuple(wants), stripes.index)
    a, b = max(lo, s), min(hi, e)
    own = [x.narrow(axis, a - s, b - a) if b > a else x.narrow(axis, 0, 0) for x in xs]
    if m == 0:
        return [o.contiguous() for o in own]
    dev = xs[0].device
    sel = _index(mine, dev)
    bufs = [_to_bytes(x.index_select(axis, sel).movedim(axis, 0)) for x in xs]
    got = all_gather(torch.cat(bufs, 1), stripes.group, stripes.n).flatten(0, 1)
    out, col = [], 0
    for x, o, buf in zip(xs, own, bufs):
        part = got[:, col:col + buf.shape[1]]
        col += buf.shape[1]
        rest = x.movedim(axis, 0).shape[1:]
        pieces = [o]
        if above:
            pieces.insert(0, _from_bytes(part[_index(above, dev)], x.dtype, rest).movedim(0, axis))
        if below:
            pieces.append(_from_bytes(part[_index(below, dev)], x.dtype, rest).movedim(0, axis))
        out.append(torch.cat(pieces, axis))
    return out


def fetch_rows(x: torch.Tensor, lo: int, hi: int, stripes: Stripes, axis: int) -> torch.Tensor:
    """The global rows [lo, hi) along `axis` of the striped tensor `x`, where
    each rank names its own rows (they are gathered first, one small
    collective)."""
    req = torch.tensor([[lo, hi]], dtype=torch.int64, device=x.device)
    wants = tuple(tuple(r) for r in all_gather(req, stripes.group, stripes.n)
                  .reshape(stripes.n, 2).tolist())
    return exchange([x], stripes, wants, axis)[0]


def halo(op: Callable[..., torch.Tensor], xs: Sequence[torch.Tensor], stripes: Stripes,
         r: int, axis: int) -> torch.Tensor:
    """`op(*slabs)` cropped to this rank's rows, the slabs being `xs`' rows
    [start - r, end + r) clipped to [0, H): for an op whose output row
    reads input rows within r of it (a same-padded conv: r per 3x3 conv),
    the unsharded op's rows [start, end)."""
    H = stripes.height
    wants = tuple((max(s - r, 0), min(e + r, H)) for s, e in stripes.bounds)
    y = op(*exchange(xs, stripes, wants, axis))
    return y.narrow(axis, stripes.start - wants[stripes.index][0], stripes.rows).contiguous()


def up_source_rows(n: int, s: int, e: int, margin: int = 1) -> Tuple[int, int]:
    """The rows of an n-row plane that output rows [s, e) of its 2n-row
    align-corners upsample read (src = o * (n - 1) / (2n - 1), its floor and
    the next row), widened by `margin` rows, clipped to [0, n)."""
    if n == 1:
        return 0, 1
    lo = s * (n - 1) // (2 * n - 1)
    hi = (e - 1) * (n - 1) // (2 * n - 1) + 2
    return max(lo - margin, 0), min(hi + margin, n)


def up2x(x: torch.Tensor, src: Stripes, axis: int,
         interp: Callable[[torch.Tensor, int, int, Tuple[int, int]], torch.Tensor]
         ) -> torch.Tensor:
    """This rank's rows [2 start, 2 end) of the x2 align-corners upsample of
    the striped `x` (layout `src`): `interp(slab, lo, n, (s, e))` computes
    output rows [s, e) of the upsample of the n-row plane whose global rows
    [lo, ...) the slab holds."""
    n = src.height
    wants = tuple(up_source_rows(n, 2 * s, 2 * e) for s, e in src.bounds)
    slab = exchange([x], src, wants, axis)[0]
    return interp(slab, wants[src.index][0], n, (2 * src.start, 2 * src.end))


# ---------------------------------------------------------------------------
# the inspection step's re-splits
# ---------------------------------------------------------------------------

def frames_to_stripes(x: torch.Tensor, counts: Bounds, stripes: Stripes,
                      axis: int) -> torch.Tensor:
    """This rank's frames `x` (counts[index] of them, whole) -> rows [start,
    end) along `axis` of every frame of the slice, in frame order."""
    if stripes.n == 1:
        return x
    kmax = max(c for _, c in counts)
    pad = x
    if x.shape[0] < kmax:
        pad = x.new_zeros((kmax,) + tuple(x.shape[1:]))
        pad[:x.shape[0]] = x
    got = all_gather(_to_bytes(pad), stripes.group, stripes.n)
    return torch.cat([_from_bytes(got[i, :c], x.dtype, x.shape[1:])
                      .narrow(axis, stripes.start, stripes.rows)
                      for i, (_, c) in enumerate(counts) if c])


def stripes_to_frames(y: torch.Tensor, counts: Bounds, stripes: Stripes,
                      axis: int) -> torch.Tensor:
    """The H stripes `y` (rows [start, end) along `axis`) of every frame of
    the slice -> this rank's frames (counts[index] of them), whole."""
    if stripes.n == 1:
        return y
    rmax = max(e - s for s, e in stripes.bounds)
    shape = list(y.shape)
    shape[axis] = rmax
    pad = y.new_zeros(shape)
    pad.narrow(axis, 0, stripes.rows).copy_(y)
    got = all_gather(_to_bytes(pad), stripes.group, stripes.n)
    f0, k = counts[stripes.index]
    return torch.cat([_from_bytes(got[i, f0:f0 + k], y.dtype, shape[1:]).narrow(axis, 0, e - s)
                      for i, (s, e) in enumerate(stripes.bounds)], axis)


def gather_frames(tree, counts: Bounds, stripes: Stripes, device: torch.device):
    """Every rank's outputs for its frames (a tree of (k, ...) tensors, None
    on a rank without frames) -> the tree of the slice's frames in order,
    on every rank. A rank without frames learns the trees' layout from the
    group's first rank (which holds frames)."""
    if stripes.n == 1:
        return tree
    spec, buf = pack(tree) if tree is not None else (None, None)
    if any(c == 0 for _, c in counts):
        box = [spec]
        dist.broadcast_object_list(box, src=dist.get_global_rank(stripes.group, 0),
                                   group=stripes.group)
        spec = box[0]
    nbytes = sum(_nbytes(shape, dtype) for dtype, shape in spec[1])
    kmax = max(c for _, c in counts)
    pad = torch.zeros((kmax, nbytes), dtype=torch.uint8, device=device)
    if buf is not None:
        pad[:buf.shape[0]] = buf
    got = all_gather(pad, stripes.group, stripes.n)
    return unpack(spec, torch.cat([got[i, :c] for i, (_, c) in enumerate(counts)]))


def stripes_of(rows: int, index: int, group, n: int, device) -> Stripes:
    """The layout of a tensor striped by `stripe_bounds` (as
    `mesh.put_batch(spatial=True)` stripes it), from each rank's row count
    (gathered: one small collective)."""
    got = all_gather(torch.tensor([rows], dtype=torch.int64, device=device), group, n)
    sizes = [int(v) for v in got.reshape(n).tolist()]
    bounds = stripe_bounds(sum(sizes), n)
    if [e - s for s, e in bounds] != sizes:
        raise ValueError(f"stripes of {sizes} rows are not stripe_bounds({sum(sizes)}, {n})")
    return Stripes(bounds, index, group)

