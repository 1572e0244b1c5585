"""K1: RefVSR's propagation flow warp, as CUDA kernels and their plain
versions, forward and backward.

Replaces the Pallas kernel ``refvsr_tpu/ops/pallas/warp_select.py``
(``_select_kernel``, called from ``_exec`` and reached through
``refvsr_tpu/ops/warp.py:_bilinear_sample``) and its custom VJP (``_bwd``,
the pullback of ``_bilinear_sample_lean``). The kernel source is
``refvsr_tpu_torch/csrc/warp_sample.cu``; it fuses ``warp_coords`` (flow ->
source coordinates) and gathers the four bilinear corners directly, so the
TPU's band plan, anchors and fallback have no counterpart here. Its forward
kernel gives each thread 16 bytes of one output pixel's channels: four
16-byte corner loads and one 16-byte store where C is a multiple of 8 (bf16)
or 4 (f32), one channel at a time otherwise.

Semantics (``grid_sample`` align_corners=False, zeros padding, as
``refvsr_tpu/ops/warp.py:_bilinear_sample_lean``): anchors ``floor(s)``;
corners outside the image read 0; a point whose anchor lies outside
``[-1, S-1]`` on either axis, or whose coordinate is NaN, is dead and gives
exact 0. The plain version weights the corners in f32, casts the weights to
the source dtype and sums in the source dtype, like the JAX sampler; the
kernel sums in f32 and rounds once, which is why the card compares them
within 2**-6 * max|x| in bf16 and 1e-5 * max|x| in f32.

Gradients: ``warp_sample`` is a ``torch.autograd.Function`` when x or the
flow requires grad. ``dx`` scatters each live point's four weights times g
into its inside corners; ``dflow`` (computed only when the flow requires
grad, and only then is x kept for the backward pass) is the sum over C of g
times the weights' derivatives, times ``w/(w-1)`` and ``h/(h-1)``; each is
computed only when its input requires grad. A dead point gives exact zeros
to both, NaN coordinates included (the JAX pullback lets a NaN weight leak
into dx through 0 * NaN; the port does not). The plain backward is autograd
through ``warp_sample_plain``. The backward kernel sums each thread's
corner contributions to a 2 x 2 window of source pixels in registers
before it reduces them into an f32 dx; that buffer has a pitch of C
rounded up to 4 floats (``dx_pitch``), so that it takes float4 reductions,
and dx is the view of its first C channels (f32) or that view cast to x's
dtype once (bf16).

Under a profiler session every forward call (``warp_sample`` without
gradients, ``_WarpSample.forward``, ``warp_sample_banded``) is the span
``refvsr.k1`` (``utils/trace.py``), on either path.
"""

from __future__ import annotations

import ctypes

import torch

from refvsr_tpu_torch.ops.kernels import build
from refvsr_tpu_torch.utils import trace

# the C launchers' arguments before the stream
_FORWARD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
_BACKWARD_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
_BANDED_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_C = {torch.float32: 1024, torch.bfloat16: 2048}


def dx_pitch(c: int) -> int:
    """Floats per source pixel of the backward kernel's f32 dx buffer: C
    rounded up to 4, so that every pixel's row takes float4 reductions."""
    return -(-c // 4) * 4


def warp_coords(in_hw, flow: torch.Tensor, out_h: int | None = None,
                row0: int = 0):
    """Source pixel coords (sx, sy), each (N, Ho, Wo) f32, of RefVSR's
    propagation warp: base grid linspace(-1, 1) over the FLOW's grid, flow
    normalised by the INPUT's half extent, unnormalised align_corners=False
    against the input extent. The kernel evaluates the same expression in
    the same order. A band of the flow's rows: `out_h` is the whole grid's
    height and `row0` the band's first row (the banded kernel's)."""
    h, w = in_hw
    ho, wo = flow.shape[1], flow.shape[2]
    gy = torch.arange(row0, row0 + ho, dtype=torch.float32,
                      device=flow.device)[:, None]
    ho = ho if out_h is None else out_h
    gx = torch.arange(wo, dtype=torch.float32, device=flow.device)[None, :]
    fx = flow[..., 0].float()
    fy = flow[..., 1].float()
    xn = gx * (2.0 / max(wo - 1, 1)) + fx * (2.0 / max(w - 1, 1)) - 1.0
    yn = gy * (2.0 / max(ho - 1, 1)) + fy * (2.0 / max(h - 1, 1)) - 1.0
    return ((xn + 1.0) * w - 1.0) * 0.5, ((yn + 1.0) * h - 1.0) * 0.5


def bilinear_sample(x: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                    padding: str = "zeros") -> torch.Tensor:
    """Plain bilinear sample of x (N, H, W, C) at f32 pixel coords sx/sy
    (N, Ho, Wo): a transcription of ``_bilinear_sample_lean`` ('zeros' or
    'border' padding). Four corner gathers, f32 weights cast to x.dtype."""
    n, h, w, c = x.shape
    sx = sx.float()
    sy = sy.float()
    if padding == "border":
        sx = sx.clamp(0.0, w - 1.0)
        sy = sy.clamp(0.0, h - 1.0)
    flat = x.reshape(n, h * w, c)
    dt = x.dtype
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    tx = sx - x0
    ty = sy - y0
    if padding == "zeros":
        valid = (y0 >= -1.0) & (y0 <= h - 1.0) & (x0 >= -1.0) & (x0 <= w - 1.0)
        # a dead point's fractions are zeroed too, so that a NaN coordinate
        # cannot reach either gradient through 0 * NaN
        tx = torch.where(valid, tx, 0.0)
        ty = torch.where(valid, ty, 0.0)
    # NaN/inf coordinates give garbage indices here; they are clipped for
    # the read and the point is zeroed by the final mask
    x0i = torch.nan_to_num(x0, 0.0).clamp(-2.0, w).long()
    y0i = torch.nan_to_num(y0, 0.0).clamp(-2.0, h).long()
    bidx = torch.arange(n, device=x.device)[:, None]

    def corner(yi, xi):
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        v = flat[bidx, idx.reshape(n, -1)].reshape(*yi.shape, c)
        if padding == "zeros":
            inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            v = torch.where(inside[..., None], v, torch.zeros((), dtype=dt,
                                                              device=x.device))
        return v

    out = (corner(y0i, x0i) * ((1 - ty) * (1 - tx))[..., None].to(dt)
           + corner(y0i, x0i + 1) * ((1 - ty) * tx)[..., None].to(dt)
           + corner(y0i + 1, x0i) * (ty * (1 - tx))[..., None].to(dt)
           + corner(y0i + 1, x0i + 1) * (ty * tx)[..., None].to(dt))
    if padding == "zeros":
        out = torch.where(valid[..., None], out,
                          torch.zeros((), dtype=dt, device=x.device))
    return out


def warp_sample_plain(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Plain version of the K1 kernel: warp_coords + the zeros sampler."""
    sx, sy = warp_coords(x.shape[1:3], flow)
    return bilinear_sample(x, sx, sy, "zeros")


def warp_sample_backward_plain(g: torch.Tensor, flow: torch.Tensor,
                               x_shape, x: torch.Tensor | None = None):
    """Plain backward of the K1 kernel: autograd through warp_sample_plain.
    Returns (dx, dflow or None); dflow is computed when x is given (dx does
    not depend on x's values, so without x a zero x stands in)."""
    with torch.enable_grad():
        xx = (torch.zeros(x_shape, dtype=g.dtype, device=g.device)
              if x is None else x.detach()).requires_grad_()
        ff = flow.detach().requires_grad_(x is not None)
        grads = torch.autograd.grad(warp_sample_plain(xx, ff),
                                    [xx] if x is None else [xx, ff], g)
    return grads[0], (None if x is None else grads[1])


def warp_sample_banded_plain(x: torch.Tensor, flow: torch.Tensor, h: int,
                             out_h: int, out_row0: int, in_row0: int,
                             lo: int, hi: int) -> torch.Tensor:
    """Plain version of the banded K1 kernel: the warp of a band of rows.

    x (N, Hb, W, C) holds rows [in_row0, in_row0 + Hb) of an (N, h, W, C)
    source (rows outside [0, h) are zeros); flow (N, Hob, Wo, 2) holds rows
    [out_row0, out_row0 + Hob) of an out_h-row flow. The coordinates are
    ``warp_coords`` of the whole grid; a point's liveness is the whole
    image's; its top anchor row, localised (``- in_row0``), is clamped into
    [lo, hi] (the JAX sharded sampler's rule, ``refvsr_tpu/parallel/
    spatial.py:137-141``: lo = -1 where the band starts at the image's top,
    else 0 so that a read past the band border-extends; hi = Hb - 1), and
    corners outside [0, Hb) read 0. With in_row0 = out_row0 = 0, h = Hb,
    out_h = Hob, lo = -1 and hi = h - 1 it is ``warp_sample_plain``."""
    n, hb, w, c = x.shape
    sx, sy = warp_coords((h, w), flow, out_h, out_row0)
    dt = x.dtype
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    tx = sx - x0
    ty = sy - y0
    valid = (y0 >= -1.0) & (y0 <= h - 1.0) & (x0 >= -1.0) & (x0 <= w - 1.0)
    tx = torch.where(valid, tx, 0.0)
    ty = torch.where(valid, ty, 0.0)
    x0i = torch.nan_to_num(x0, 0.0).clamp(-2.0, w).long()
    y0i = (torch.nan_to_num(y0, 0.0).clamp(-1.0, h - 1.0).long()
           - in_row0).clamp(lo, hi)
    flat = x.reshape(n, hb * w, c)
    bidx = torch.arange(n, device=x.device)[:, None]
    zero = torch.zeros((), dtype=dt, device=x.device)

    def corner(yi, xi):
        idx = yi.clamp(0, hb - 1) * w + xi.clamp(0, w - 1)
        v = flat[bidx, idx.reshape(n, -1)].reshape(*yi.shape, c)
        inside = (yi >= 0) & (yi < hb) & (xi >= 0) & (xi < w)
        return torch.where(inside[..., None], v, zero)

    out = (corner(y0i, x0i) * ((1 - ty) * (1 - tx))[..., None].to(dt)
           + corner(y0i, x0i + 1) * ((1 - ty) * tx)[..., None].to(dt)
           + corner(y0i + 1, x0i) * (ty * (1 - tx))[..., None].to(dt)
           + corner(y0i + 1, x0i + 1) * (ty * tx)[..., None].to(dt))
    return torch.where(valid[..., None], out, zero)


def warp_sample_banded(x: torch.Tensor, flow: torch.Tensor, h: int,
                       out_h: int, out_row0: int, in_row0: int, lo: int,
                       hi: int) -> torch.Tensor:
    """The banded K1 kernel (forward only; the spatial stream is
    inference): ``warp_sample_banded_plain``'s function. CPU tensors run
    the plain version; CUDA tensors run the kernel (its conditions as
    ``warp_sample``'s), or raise. ``warp_sample_banded.launches`` counts
    kernel launches."""
    with trace.span("refvsr.k1"):
        _check(x, flow)
        if x.device.type == "cpu":
            return warp_sample_banded_plain(x, flow, h, out_h, out_row0,
                                            in_row0, lo, hi)
        x, flow = x.contiguous(), flow.contiguous()
        _check_cuda(x, flow)
        n, hb, w, c = x.shape
        if c > _MAX_C[x.dtype]:
            raise ValueError(f"warp_sample_banded takes C up to "
                             f"{_MAX_C[x.dtype]} in {x.dtype}, got {c}")
        ho, wo = flow.shape[1], flow.shape[2]
        out = torch.empty((n, ho, wo, c), dtype=x.dtype, device=x.device)
        if out.numel() == 0:
            return out
        fn = build.function("warp_sample", "warp_sample_banded_launch",
                            _BANDED_ARGS)
        build.launch(fn, x.device, x.data_ptr(), flow.data_ptr(),
                     out.data_ptr(), n, hb, w, c, ho, wo, h, out_h, out_row0,
                     in_row0, lo, hi, _DTYPES[x.dtype])
        warp_sample_banded.launches += 1
        return out


def _check(x, flow):
    if x.dim() != 4 or flow.dim() != 4 or flow.shape[-1] != 2:
        raise ValueError(f"want x (N,H,W,C) and flow (N,Ho,Wo,2); got "
                         f"{tuple(x.shape)} and {tuple(flow.shape)}")
    if flow.shape[0] != x.shape[0]:
        raise ValueError("x and flow batch sizes differ")
    if flow.device != x.device:
        raise ValueError("x and flow are on different devices")


def _check_cuda(*ts):
    t0 = ts[0]
    if t0.device.type != "cuda":
        raise ValueError(f"unsupported device {t0.device}")
    if t0.dtype not in _DTYPES or any(t.dtype != t0.dtype for t in ts):
        raise TypeError(f"warp_sample takes its tensors all f32 or all bf16, "
                        f"got {[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("warp_sample needs contiguous tensors")


def _forward(x, flow):
    with trace.span("refvsr.k1"):
        if x.device.type == "cpu":
            return warp_sample_plain(x, flow)
        _check_cuda(x, flow)
        n, h, w, c = x.shape
        if c > _MAX_C[x.dtype]:
            # one thread per 16 bytes of a pixel's channels, and a pixel's
            # threads in one block of at most 256
            raise ValueError(f"warp_sample takes C up to "
                             f"{_MAX_C[x.dtype]} in {x.dtype}, got {c}")
        ho, wo = flow.shape[1], flow.shape[2]
        out = torch.empty((n, ho, wo, c), dtype=x.dtype, device=x.device)
        if out.numel() == 0:
            return out
        fn = build.function("warp_sample", "warp_sample_launch",
                            _FORWARD_ARGS)
        build.launch(fn, x.device, x.data_ptr(), flow.data_ptr(),
                     out.data_ptr(), n, h, w, c, ho, wo, _DTYPES[x.dtype])
        warp_sample.launches += 1
        return out


def warp_sample_backward(g: torch.Tensor, flow: torch.Tensor, x_shape,
                         x: torch.Tensor | None = None, need_dx: bool = True):
    """Gradients of warp_sample(x, flow) given the output's gradient g:
    (dx or None, dflow or None), dx when `need_dx`, dflow when x is given.
    CPU tensors run the plain backward; CUDA tensors run the backward kernel
    (anything else raises). ``warp_sample_backward.launches`` counts kernel
    launches."""
    if g.device.type == "cpu":
        dx, dflow = warp_sample_backward_plain(g, flow, x_shape, x)
        return (dx if need_dx else None), dflow
    g = g.contiguous()
    _check_cuda(flow, g, *(() if x is None else (x,)))
    n, h, w, c = x_shape
    ho, wo = flow.shape[1], flow.shape[2]
    ldx = dx_pitch(c)
    # the launcher clears dx on the stream before the kernel
    dx = (g.new_empty((n, h, w, ldx), dtype=torch.float32) if need_dx
          else None)
    dflow = None if x is None else torch.empty_like(flow)
    if not g.numel():
        for t in (dx, dflow):
            if t is not None:
                t.zero_()
    elif dx is not None or dflow is not None:
        fn = build.function("warp_sample", "warp_sample_backward_launch",
                            _BACKWARD_ARGS)
        build.launch(fn, g.device, None if x is None else x.data_ptr(),
                     flow.data_ptr(), g.data_ptr(),
                     None if dx is None else dx.data_ptr(),
                     None if dflow is None else dflow.data_ptr(), n, h, w, c,
                     ho, wo, ldx, _DTYPES[g.dtype])
        warp_sample_backward.launches += 1
    if dx is not None:
        if ldx != c:
            dx = dx[..., :c]
        if g.dtype != torch.float32:
            dx = dx.to(g.dtype)
    return dx, dflow


class _WarpSample(torch.autograd.Function):
    """warp_sample with its backward pass: the plain version for CPU
    tensors, the kernels for CUDA tensors. x is saved only when the flow's
    gradient is asked for; dx needs only the flow. Each gradient is computed
    only when its input requires grad (None otherwise)."""

    @staticmethod
    def forward(ctx, x, flow):
        need_dflow = ctx.needs_input_grad[1]
        ctx.x_shape = tuple(x.shape)
        ctx.save_for_backward(flow, x if need_dflow else None)
        return _forward(x, flow)

    @staticmethod
    def backward(ctx, g):
        flow, x = ctx.saved_tensors
        return warp_sample_backward(g, flow, ctx.x_shape, x,
                                    need_dx=ctx.needs_input_grad[0])


def warp_sample(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp x (N, H, W, C) by flow (N, Ho, Wo, 2) onto the flow's grid.

    CPU tensors run the plain version. CUDA tensors run the kernel, which
    takes x and flow contiguous, both f32 or both bf16, C up to 1024 (f32)
    or 2048 (bf16); anything else raises. With gradients on and x or the
    flow requiring grad, the call is recorded for autograd
    (``_WarpSample``). ``warp_sample.launches`` counts forward kernel
    launches."""
    _check(x, flow)
    if torch.is_grad_enabled() and (x.requires_grad or flow.requires_grad):
        return _WarpSample.apply(x, flow)
    return _forward(x, flow)


warp_sample.launches = 0
warp_sample_backward.launches = 0
warp_sample_banded.launches = 0
