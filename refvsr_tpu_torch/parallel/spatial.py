"""H-sharded execution of the 8K stream over the ranks of a process group;
counterpart of ``refvsr_tpu/parallel/spatial.py``.

Every rank holds a band of rows of each image-like tensor: rows
``mesh.part(H)`` of a tensor of H rows (an even split whenever the rank
count divides H), and runs the network on its bands. The JAX package
leaves the convolutions, resizes and elementwise ops to GSPMD and gives
five gathers a shard-local form; here every op has a rule of its own,
consulted while a ``spatial_sharding`` context is active:

- (a) every ``blocks.Conv2d``: the rows its output band reads, fetched from
  the neighbours (zeros past the image, its own zero padding), then the
  convolution with no H padding; strided ones too, at any band start;
  where a hand-written kernel takes those rows as it takes a whole image
  on one rank (``blocks.routed_kernel``: K3, K6), that kernel, cropped;
- (b) the integer-ratio resizes (bicubic x2, x0.5, x scale, nearest x0.5)
  and ``pixel_shuffle``: the input rows the output band's taps read,
  within the image (the resize clamps where the image ends, as the whole
  image's), then the resize of that band and a crop;
- (c) replication where a resize has no integer ratio: SPyNet's pyramid
  (and the 2x flow upsampling, align_corners=True), EDVR on the IR net,
  and the matching's feature pyramid, which run on rows gathered from
  every rank inside ``replicated()`` and keep this rank's rows;

and the shard-local ops, with the JAX package's semantics:

- ``sharded_warp`` (``sharded_bilinear_sample``, ``:102-156``): the halo
  exchange and the banded K1 kernel; global clamp, then localise, so that
  an interior band clamps into its halo (a read past the halo
  border-extends) and only the first and last bands see the zero ring;
  bit-identical to the whole-image warp while |flow_y| stays within the
  halo;
- ``sharded_affine_fold`` (``:176-278``): AlignedConv2d's clamped-corner
  gather and fold on the band of canvas rows its taps can reach (the
  static bound ``min_halo``), exact while the taps stay within it;
- ``sharded_patch_warp`` (``:294-427``): the patch table is gathered whole
  (one ``all_gather`` of the value in place of the JAX ring rotation,
  which trades the same bytes for TPU memory) and the band's output patches
  read it by the gathered index map; exact for any index map;
- ``sharded_strided_conv_small`` (``:431-495``): the strided affine-head
  conv on the band's grid rows, gathered whole (its output is the small
  affine grid, which the code after it uses whole);
- the matching's argmax (``sharded_argmax_matmul``, ``:498-529``): kernel
  K2 itself, on the band's LR patch rows against the whole ref table
  (``models/matching.py``); its global indices address the gathered patch
  table directly.

The exchanges use ``all_gather`` only (``fetch_rows``): every rank hands
in its first and last E rows, E the most any rank needs from the others,
so the code that runs on one card under gloo is the code NCCL would run.
``spatial_sharding`` also learns the heights the net's tensors take
(powers of two times the LR and ref heights), so that an op can tell a
band's whole height from its own row count; a geometry where two of them
give one rank the same row count raises at set-up. A tensor gathered
whole (``gather_rows``) carries a mark, and an op that takes it for a
band raises."""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.nn.functional as F

from refvsr_tpu_torch.parallel import mesh


@dataclass
class SpatialCtx:
    world: int
    rank: int
    halo: int
    heights: dict = field(default_factory=dict)  # band rows -> whole rows
    exchanges: int = 0        # collectives issued
    bytes_moved: int = 0      # bytes each rank handed to them

    def part(self, n: int, index: Optional[int] = None):
        return mesh.part(n, self.world, self.rank if index is None
                         else index)

    def whole(self, x: torch.Tensor, dim: int = 1) -> int:
        """The whole height of `x`, this rank's band along `dim`. A tensor
        that ``gather_rows`` gathered whole is no band: it raises, as does
        a row count that matches none of the geometry's bands."""
        if getattr(x, GATHERED, False):
            raise ValueError(
                f"spatial sharding: a tensor of {tuple(x.shape)} gathered "
                "whole is used as a band; whole tensors are used inside "
                "replicated()")
        rows = x.shape[dim]
        if rows not in self.heights:
            raise ValueError(
                f"spatial sharding: a band of {rows} rows on rank "
                f"{self.rank} matches none of the heights "
                f"{sorted(set(self.heights.values()))} of the geometry")
        return self.heights[rows]


# the attribute ``gather_rows`` sets on the whole tensors it returns
GATHERED = "_spatial_gathered"

_CTX: Optional[SpatialCtx] = None
_SUSPENDED = False


def band_heights(world: int, heights) -> dict:
    """{band rows on rank r: whole rows} for every rank, checked: a
    geometry where two heights give one rank the same band raises."""
    tables = []
    for r in range(world):
        table = {}
        for h in sorted(set(int(h) for h in heights)):
            a, b = mesh.part(h, world, r)
            if b - a in table and table[b - a] != h:
                raise ValueError(
                    f"spatial sharding over {world} ranks: heights "
                    f"{table[b - a]} and {h} both give rank {r} a band of "
                    f"{b - a} rows")
            table[b - a] = h
        tables.append(table)
    return tables


@contextlib.contextmanager
def spatial_sharding(halo: int, heights):
    """Activate the H-sharded rules for the process group's ranks.
    `heights`: the whole heights the net's sharded tensors take."""
    global _CTX
    world = mesh.world_size()
    tables = band_heights(world, heights)
    prev = _CTX
    _CTX = SpatialCtx(world, mesh.rank(), halo, tables[mesh.rank()])
    try:
        yield _CTX
    finally:
        _CTX = prev


def active() -> Optional[SpatialCtx]:
    """The context, when it is active, has more than one rank and is not
    suspended by ``replicated()``."""
    if _CTX is None or _SUSPENDED or _CTX.world < 2:
        return None
    return _CTX


def refuse(op: str, x: torch.Tensor):
    """Raise when `op`, which has no rule for a band of rows, is called
    under an active context."""
    if active() is not None:
        raise ValueError(f"{op} of {tuple(x.shape)}: no spatial rule; it "
                         "runs on whole tensors inside replicated()")


@contextlib.contextmanager
def replicated():
    """Run the ops inside on whole tensors (rule (c)): the sharded rules
    are off until it exits."""
    global _SUSPENDED
    prev = _SUSPENDED
    _SUSPENDED = True
    try:
        yield
    finally:
        _SUSPENDED = prev


# ---------------------------------------------------------------------------
# row exchanges
# ---------------------------------------------------------------------------

def _source_row(r: int, n: int, fill: str):
    """The image row that row `r` of an `n`-row image stands for under
    `fill` past its edges (None: a zero row)."""
    if 0 <= r < n:
        return r
    if fill == "zeros":
        return None
    if fill == "replicate":
        return min(max(r, 0), n - 1)
    if fill == "reflect":
        return -r if r < 0 else 2 * (n - 1) - r
    raise ValueError(fill)


def fetch_rows(ctx: SpatialCtx, x: torch.Tensor, n: int, span,
               fill="zeros"):
    """Rows ``span(rank)`` = [a, b) of the `n`-row tensor whose bands the
    ranks hold along dim 1 (`x` is this rank's), rows past the image as
    `fill` gives them ("zeros", "replicate" or "reflect"). `span` is
    called for every rank, so that all agree on the rows exchanged: each
    hands in its first and last E rows, E the most any rank needs from
    the others, in one all_gather (none when no rank needs any)."""
    world = ctx.world
    parts = [mesh.part(n, world, j) for j in range(world)]
    need = 0
    for j in range(world):
        a, b = span(j)
        s, e = parts[j]
        rows = [_source_row(r, n, fill) for r in range(a, b)]
        rows = [r for r in rows if r is not None]
        if rows:
            need = max(need, s - min(rows), max(rows) + 1 - e)
    need = min(need, max(e - s for s, e in parts))
    a, b = span(ctx.rank)
    s0, e0 = parts[ctx.rank]
    pieces = [x]
    where = {r: ("own", r - s0) for r in range(s0, e0)}
    if need > 0:
        top = x[:, :need]
        bot = x[:, max(0, x.shape[1] - need):]
        pad = [x.shape[0], need - top.shape[1], *x.shape[2:]]
        edge = torch.cat([top, x.new_zeros(pad), bot, x.new_zeros(pad)], 1)
        ctx.exchanges += 1
        ctx.bytes_moved += edge.numel() * edge.element_size()
        edges = mesh.all_gather_rows(edge, 1)
        pieces.append(edges)
        for j, (s, e) in enumerate(parts):
            if j == ctx.rank:
                continue
            k = min(need, e - s)
            for i in range(k):
                where.setdefault(s + i, ("edge", j * 2 * need + i))
                where.setdefault(e - k + i,
                                 ("edge", j * 2 * need + need + i))
    zero_at = sum(p.shape[1] for p in pieces)
    pieces.append(x.new_zeros((x.shape[0], 1, *x.shape[2:])))
    idx = []
    for r in range(a, b):
        src = _source_row(r, n, fill)
        if src is None:
            idx.append(zero_at)
            continue
        kind, i = where[src]
        idx.append(i if kind == "own" else x.shape[1] + i)
    if idx == list(range(x.shape[1])):
        return x
    pool = torch.cat(pieces, 1)
    return pool.index_select(1, torch.tensor(idx, device=x.device))


def halo_exchange_rows(x: torch.Tensor, halo: int,
                       ctx: Optional[SpatialCtx] = None):
    """x: (N, Hs, W, C), this rank's band -> (N, Hs + 2*halo, W, C) with the
    neighbours' rows, zero-filled past the image's edges."""
    ctx = ctx or _CTX
    n = ctx.whole(x)

    def span(j):
        s, e = mesh.part(n, ctx.world, j)
        return s - halo, e + halo
    return fetch_rows(ctx, x, n, span)


def gather_rows(x: torch.Tensor, n: int, dim: int = 1,
                ctx: Optional[SpatialCtx] = None):
    """The whole `n`-row tensor from the ranks' bands along `dim`."""
    ctx = ctx or _CTX
    sizes = [b - a for a, b in (mesh.part(n, ctx.world, j)
                                for j in range(ctx.world))]
    ctx.exchanges += 1
    ctx.bytes_moved += x.numel() * x.element_size()
    out = mesh.all_gather_rows(x, dim, sizes)
    setattr(out, GATHERED, True)
    return out


def band_of(x: torch.Tensor, n: int, dim: int = 1,
            ctx: Optional[SpatialCtx] = None):
    """This rank's band of the whole `n`-row tensor `x` along `dim`."""
    ctx = ctx or _CTX
    a, b = ctx.part(n)
    return x.narrow(dim, a, b - a)


# ---------------------------------------------------------------------------
# rule (a): convolutions
# ---------------------------------------------------------------------------

def conv2d(ctx: SpatialCtx, conv, x: torch.Tensor) -> torch.Tensor:
    """``blocks.Conv2d`` on this rank's band (N, Hs, W, C): the rows its
    output band reads (zeros past the image), then the convolution with
    no H padding; or, where ``blocks.routed_kernel`` sends those rows to a
    hand-written kernel, as on one rank, that kernel's SAME convolution of
    them, less its first and last p rows (the ones its zero padding
    reaches)."""
    k, s, p = conv.kernel_size[0], conv.stride[0], conv.padding[0]
    n = ctx.whole(x)
    no = (n + 2 * p - k) // s + 1

    def span(j):
        a, b = mesh.part(no, ctx.world, j)
        return a * s - p, (b - 1) * s - p + k
    band = fetch_rows(ctx, x, n, span)
    out = conv.routed(band)
    if out is not None:
        return out[:, p:out.shape[1] - p]
    out = F.conv2d(band.permute(0, 3, 1, 2), conv.weight, conv.bias,
                   conv.stride, (0, p))
    return out.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# rule (b): integer-ratio resizes and the pixel shuffle
# ---------------------------------------------------------------------------

def _denominator(f: float) -> int:
    """q of f = p / q, where f is an integer (q = 1) or its inverse."""
    if f >= 1:
        if f != int(f):
            raise ValueError(f"no integer ratio: {f}")
        return 1
    q = round(1 / f)
    if abs(1 / q - f) > 1e-12:
        raise ValueError(f"no integer ratio: {f}")
    return q


def _src_rows(d0: int, d1: int, f: float, mode: str):
    """The input rows output rows [d0, d1) read (unclipped)."""
    if mode == "nearest":
        return math.floor(d0 / f), math.floor((d1 - 1) / f) + 1
    lo = math.floor((d0 + 0.5) / f - 0.5)
    hi = math.floor((d1 - 1 + 0.5) / f - 0.5)
    if mode == "bicubic":
        return lo - 1, hi + 3
    return lo, hi + 2                       # bilinear


def resize(ctx: SpatialCtx, x: torch.Tensor, f: float, mode: str, resize_fn,
           n: Optional[int] = None) -> torch.Tensor:
    """``ops.resize.resize(x, scale_factor=f, mode=mode)`` of the band
    (align_corners=False). The output band's input rows are fetched
    within the image, from a row where the scaled offset is whole, and
    resized on their own: the taps the kept rows read are the whole
    image's, and where the band meets the image's edge the resize clamps
    there as the whole one does."""
    n = ctx.whole(x, -3) if n is None else n
    q = _denominator(f)
    no = math.floor(n * f)

    def span(j):
        a, b = mesh.part(no, ctx.world, j)
        lo, hi = _src_rows(a, b, f, mode)
        lo = max(0, (lo - q) // q * q)
        return lo, min(n, hi + q)
    lead = x.shape[:-3]
    x4 = x.reshape(-1, *x.shape[-3:])
    band = fetch_rows(ctx, x4, n, span)
    out = resize_fn(band, scale_factor=f, mode=mode)
    a, b = ctx.part(no)
    off = a - round(span(ctx.rank)[0] * f)
    out = out[:, off:off + (b - a)]
    return out.reshape(*lead, *out.shape[1:])


def pixel_shuffle(ctx: SpatialCtx, x: torch.Tensor, r: int, shuffle_fn):
    """Depth-to-space of the band: the input rows holding the output
    band's rows, shuffled, cropped."""
    n = ctx.whole(x)
    no = n * r

    def span(j):
        a, b = mesh.part(no, ctx.world, j)
        return a // r, -(-b // r)
    band = fetch_rows(ctx, x, n, span)
    a, b = ctx.part(no)
    off = a - (a // r) * r
    return shuffle_fn(band, r)[:, off:off + (b - a)]


# ---------------------------------------------------------------------------
# the warp: halo exchange and the banded K1 kernel
# ---------------------------------------------------------------------------

def sharded_warp(x: torch.Tensor, flow: torch.Tensor,
                 ctx: Optional[SpatialCtx] = None) -> torch.Tensor:
    """RefVSR's propagation warp of the band: x (N, Hs, W, C) this rank's
    rows of an H-row source, flow (N, Hos, Wo, 2) its rows of the Ho-row
    grid; the output takes the flow's band. The source band is extended by
    ``ctx.halo`` rows a side (zeros past the image) and sampled by the
    banded K1 kernel with the JAX sampler's clamps (module docstring)."""
    from refvsr_tpu_torch.ops.kernels.warp_sample import warp_sample_banded
    ctx = ctx or _CTX
    h = ctx.whole(x)
    ho = ctx.whole(flow)
    xe = halo_exchange_rows(x, ctx.halo, ctx)
    s, _ = ctx.part(h)
    oy0, _ = ctx.part(ho)
    lo = -1 if ctx.rank == 0 else 0
    return warp_sample_banded(xe.contiguous(), flow.contiguous(), h, ho,
                              oy0, s - ctx.halo, lo, xe.shape[1] - 1)


# ---------------------------------------------------------------------------
# AlignedConv2d's affine gather and fold
# ---------------------------------------------------------------------------

def sharded_affine_fold(x: torch.Tensor, pad: int, p_row, p_col, ks: int,
                        min_halo: int, ctx: Optional[SpatialCtx] = None):
    """AlignedConv2d's sampler and fold on the band: x (N, Hs, Wx, C) this
    rank's rows of the Hx-row canvas (Hx = gh * ks); p_row/p_col
    (N, gh, gw, ks*ks) the whole grid's f32 coords into the
    reflection-padded canvas (pad rows a side). The band's grid rows read
    padded rows within `min_halo` of their anchors (AlignedConv2d's static
    bound); those are fetched (the reflected rows at the image's edges
    included), the corners are clamped as the whole canvas's are and
    localised, and the fold is cropped to the band. Returns
    (N, Hs, gw*ks, C)."""
    from refvsr_tpu_torch.models.matching import affine_bilinear_gather
    ctx = ctx or _CTX
    hx = ctx.whole(x)
    gh = p_row.shape[1]
    if gh * ks != hx:
        raise ValueError(f"affine fold: {gh} grid rows of {ks} do not make "
                         f"the canvas's {hx} rows")
    hp = hx + 2 * pad

    def grid_span(j):
        a, b = mesh.part(hx, ctx.world, j)
        return a // ks, -(-b // ks)

    def span(j):   # canvas rows (padded row - pad) the grid rows reach
        g0, g1 = grid_span(j)
        p0 = max(0, 1 + g0 * ks - min_halo)
        p1 = min(hp, 1 + (g1 - 1) * ks + ks + min_halo + 1)
        return p0 - pad, p1 - pad
    band = fetch_rows(ctx, x, hx, span, fill="reflect")
    band = F.pad(band.permute(0, 3, 1, 2), (pad, pad, 0, 0),
                 mode="reflect").permute(0, 2, 3, 1)
    g0, g1 = grid_span(ctx.rank)
    row0 = span(ctx.rank)[0] + pad
    pr, pc = p_row[:, g0:g1], p_col[:, g0:g1]
    o = affine_bilinear_gather(band, pr, pc, row0=row0, hp=hp)
    nb, c = x.shape[0], x.shape[-1]
    gw = pr.shape[2]
    o = o.reshape(nb, g1 - g0, gw, ks, ks, c).permute(0, 1, 3, 2, 4, 5)
    o = o.reshape(nb, (g1 - g0) * ks, gw * ks, c)
    a, b = ctx.part(hx)
    return o[:, a - g0 * ks:b - g0 * ks]


# ---------------------------------------------------------------------------
# AlignedAttention's patch warp
# ---------------------------------------------------------------------------

def sharded_patch_warp(value: torch.Tensor, index: torch.Tensor, ks: int,
                       out_hw, ctx: Optional[SpatialCtx] = None):
    """Unfold -> index gather -> fold of the band (kernel == stride == ks):
    value (N, Hvs, Wv, C) this rank's rows of the Hv-row value; index
    (N, Ls) its part of the flattened H-major index map over the output's
    (Ho/ks, Wo/ks) patch grid; out_hw the whole output's size. The value
    and the index map are gathered whole, the output band's patch rows
    read the table by it, and the fold is cropped to the band. Returns
    (N, Hos, Wo, C)."""
    from refvsr_tpu_torch.ops.patches import (extract_patches,
                                              fold_non_overlapping,
                                              gather_patches)
    ctx = ctx or _CTX
    hv = ctx.whole(value)
    ho, wo = out_hw
    gwo = wo // ks
    full_v = gather_rows(value, hv, 1, ctx)
    full_i = gather_rows(index, (ho // ks) * gwo, 1, ctx)
    a, b = ctx.part(ho)
    g0, g1 = a // ks, -(-b // ks)
    with replicated():
        table = extract_patches(full_v, ks, ks, "same")
    rows = gather_patches(table, full_i[:, g0 * gwo:g1 * gwo])
    img = fold_non_overlapping(rows, ((g1 - g0) * ks, wo), ks,
                               value.shape[-1])
    return img[:, a - g0 * ks:b - g0 * ks]


# ---------------------------------------------------------------------------
# AlignedConv2d's strided affine-head conv
# ---------------------------------------------------------------------------

def sharded_strided_conv_small(x: torch.Tensor, weight, bias, stride: int,
                               pad: int, ctx: Optional[SpatialCtx] = None):
    """k x k / stride-s conv (zero padding `pad`) of the band x
    (N, Hs, W, C) with the WHOLE output (N, gh, gw, O) on every rank: each
    rank computes its part of the grid rows from the input rows they read
    and the parts are gathered (the affine grid is small)."""
    ctx = ctx or _CTX
    n = ctx.whole(x)
    kh = weight.shape[-2]
    gh = (n + 2 * pad - kh) // stride + 1

    def span(j):
        a, b = mesh.part(gh, ctx.world, j)
        return a * stride - pad, (b - 1) * stride - pad + kh
    band = fetch_rows(ctx, x, n, span)
    out = F.conv2d(band.permute(0, 3, 1, 2), weight, bias, stride, (0, pad))
    return gather_rows(out.permute(0, 2, 3, 1), gh, 1, ctx)



def heights_of(h: int, ref_h: int, scale: int):
    """The whole heights a RefVSR stream's sharded tensors take at LR
    height `h` and ref height `ref_h`."""
    out = {h, 2 * h, scale * h, ref_h, 2 * ref_h}
    for v in (h, ref_h):
        if v % 2 == 0:
            out.add(v // 2)
    return sorted(out)


def index_part(index_rows: torch.Tensor, n_rows: int, width: int,
               ctx: Optional[SpatialCtx] = None):
    """An index map held by grid rows (this rank's ``part(n_rows)`` rows
    of `width` entries, flattened) as this rank's part of the flattened
    axis (``leaf_sharding``'s placement of ``index_tail``)."""
    ctx = ctx or _CTX
    full = gather_rows(index_rows.reshape(index_rows.shape[0], -1, width),
                       n_rows, 1, ctx).reshape(index_rows.shape[0], -1)
    return band_of(full, n_rows * width, 1, ctx)

