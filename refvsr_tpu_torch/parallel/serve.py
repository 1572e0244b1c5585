"""Spatial serving of the streaming eval: each frame's H axis split over
the ranks of the process group; counterpart of
``refvsr_tpu/parallel/serve.py``.

The JAX package compiles ``forward_first``/``forward_stream`` over a
(data=1, spatial=N) mesh inside its trace-scoped context. Here every rank
runs the net eagerly on its band of rows under ``spatial.spatial_sharding``
(``parallel/spatial.py``), and ``spatial_eval_fns`` returns the two
functions ``StreamRunner`` calls instead of the net's.

- ``place_input``: this rank's rows of an (N, T, H, W, 3) window;
- the state stays on the ranks where the net leaves it, by ``leaf_rows``,
  the rule of ``leaf_sharding`` (``:44-53``): a tensor of ndim >= 4 is
  split along H at ndim-3 (features (N, h, w, C), flows (N, T-1, h, w,
  2), the ring caches and ``conf_tail`` (N, TT, h, w, C)); ``index_tail``
  (N, TT, L) along its flattened H-major L axis; ``tail_base`` is an int,
  the same on every rank (``gather_state`` puts a state back together);
- the SR frame and the confidence maps are gathered whole on every rank
  (rank 0 scores and writes them);
- ``validate_spatial_shapes`` and ``check_geometry`` refuse, before the
  net runs, a geometry that a rule cannot serve, naming the op and the
  shapes."""

from __future__ import annotations

from typing import Optional

import torch

from refvsr_tpu_torch.parallel import mesh, spatial


def leaf_rows(ndim: int) -> Optional[int]:
    """The axis a state tensor of `ndim` dims is split along: H at ndim-3
    (ndim >= 4), the flattened L axis 2 of an (N, TT, L) index map, else
    None (replicated)."""
    if ndim >= 4:
        return ndim - 3
    if ndim == 3:
        return 2
    return None


def validate_spatial_shapes(h: int, w: int, n_spatial: int, halo: int):
    """The JAX package's set-up refusals, with its messages."""
    if h % n_spatial:
        raise SystemExit(
            f"--spatial_devices {n_spatial}: input height {h} is not "
            f"divisible by the spatial mesh; crop/pad the input height")
    if h // n_spatial < halo:
        raise SystemExit(
            f"--spatial_devices {n_spatial}: shard height {h // n_spatial} "
            f"< halo {halo}; lower --spatial_halo or use fewer devices")
    if (h * w) % n_spatial:
        raise SystemExit(
            f"--spatial_devices {n_spatial}: H*W {h * w} not divisible by "
            f"the spatial mesh")


def check_geometry(h: int, w: int, ref_h: int, n_spatial: int, halo: int,
                   scale: int, matching_ksize: int, flag_HD_in: bool):
    """Each rule's conditions at an (h, w) LR frame and ref height `ref_h`
    over `n_spatial` ranks, checked once at set-up without running the
    net; raises ValueError naming the op and the shapes."""
    validate_spatial_shapes(h, w, n_spatial, halo)
    heights = spatial.heights_of(h, ref_h, scale)
    spatial.band_heights(n_spatial, heights)
    small = [hh for hh in heights if hh // n_spatial < 1]
    if small:
        raise ValueError(f"spatial sharding over {n_spatial} ranks: "
                         f"heights {small} leave a rank no row")
    # the warps: source and grid rows at 1x and 2x, each band >= halo
    for rows in (h, 2 * h):
        if rows // n_spatial < halo:
            raise ValueError(
                f"warp of {rows} rows over {n_spatial} ranks: band of "
                f"{rows // n_spatial} rows < halo {halo}")
    # the patch warps and the folds: whole patches on both canvases (aa2:
    # k x k on 2h x 2w; aa1: k/2 x k/2 on h x w from the half-size LR)
    for k, rows, cols in ((matching_ksize, 2 * h, 2 * w),
                          (max(1, matching_ksize // 2), h, w)):
        if rows % k or cols % k:
            raise ValueError(
                f"patch warp of {k}x{k} patches on a {rows}x{cols} canvas: "
                "not a whole number of patches")
    # the matching's grids: integer ratios of the LR and ref rows
    near = scale // 2 if flag_HD_in else 1
    pool = 2 if (flag_HD_in or scale != 4) else 1
    for name, rows, ratio in (("lr", h, near * pool),
                              ("ref", ref_h, near * 2 * pool)):
        if rows % ratio:
            raise ValueError(
                f"matching: {name} rows {rows} are not a multiple of its "
                f"patch grid's ratio {ratio}")


def gather_state(state):
    """The whole stream state from every rank's, under an active spatial
    context: each tensor gathered along its ``leaf_rows`` axis
    (``index_tail`` by the parts of its flattened L axis)."""
    import dataclasses

    import torch.distributed as dist
    ctx = spatial.active()

    def whole(t):
        axis = leaf_rows(t.dim()) if torch.is_tensor(t) else None
        if axis is None:
            return t
        if t.dim() == 3:        # the index map: L is the parts' sum
            n = t.new_tensor([t.shape[axis]], dtype=torch.int64)
            dist.all_reduce(n)
            return spatial.gather_rows(t, int(n), axis, ctx)
        return spatial.gather_rows(t, ctx.whole(t, axis), axis, ctx)
    return dataclasses.replace(state, **{
        f.name: whole(getattr(state, f.name))
        for f in dataclasses.fields(state)})


class SpatialFns:
    """``first``/``stream`` for ``StreamRunner``: place the window's rows,
    run the given net's entry point under the spatial context and gather
    the outputs; ``place_input`` is the first step alone. ``exchanges`` and
    ``bytes_moved`` count the collectives of the windows run so far."""

    def __init__(self, scale: int, halo: int, h: int, ref_h: int, device,
                 compute_dtype):
        self.scale, self.halo, self.h, self.ref_h = scale, halo, h, ref_h
        self.device, self.dtype = device, compute_dtype
        self.heights = spatial.heights_of(h, ref_h, scale)
        self.exchanges = 0
        self.bytes_moved = 0

    def place_input(self, x):
        """This rank's rows of an (N, T, H, W, 3) window, on the device
        in the compute dtype."""
        return mesh.shard_rows(torch.as_tensor(x), 2).to(
            device=self.device, dtype=self.dtype)

    def _run(self, fn, lrs, refs, *rest):
        with spatial.spatial_sharding(self.halo, self.heights) as ctx:
            out, state, conf = fn(self.place_input(lrs),
                                  self.place_input(refs), *rest)
            out = spatial.gather_rows(out, self.scale * self.h, 1, ctx)
            conf = tuple(spatial.gather_rows(c, self.h, c.dim() - 3, ctx)
                         for c in conf)
        self.exchanges += ctx.exchanges
        self.bytes_moved += ctx.bytes_moved
        return out, state, conf

    def first(self, net, lrs, refs, *kf):
        return self._run(net.forward_first, lrs, refs, *kf)

    def stream(self, net, lrs, refs, state, *kf):
        return self._run(net.forward_stream, lrs, refs, state, *kf)


def spatial_eval_fns(net, halo: int, lrs_shape, refs_shape,
                     compute_dtype=torch.bfloat16,
                     device="cuda") -> SpatialFns:
    """The spatial functions of `net` over the process group's ranks for
    windows of `lrs_shape`/`refs_shape` (N, T, H, W, 3), after the set-up
    checks (``check_geometry``). The net must run the plain stream."""
    if getattr(net, "pipeline_lanes", 0) > 1:
        raise ValueError("the spatial stream runs without pipelining")
    n_spatial = mesh.world_size()
    h, w = lrs_shape[2], lrs_shape[3]
    check_geometry(h, w, refs_shape[2], n_spatial, halo, net.scale,
                   net.matching_ksize, net.flag_HD_in)
    return SpatialFns(net.scale, halo, h, refs_shape[2], device,
                      compute_dtype)
