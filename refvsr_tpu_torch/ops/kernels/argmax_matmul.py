"""K2: streaming max/argmax of patch similarities, as a CUDA kernel and its
plain version.

Replaces the Pallas kernel ``refvsr_tpu/ops/pallas/matching_kernel.py``
(``_kernel``, launched by ``pallas_argmax_matmul``) that
``refvsr_tpu/models/matching.py:FeatureMatching`` calls. The kernel source is
``refvsr_tpu_torch/csrc/argmax_matmul.cu``.

For each L2-normalised LR patch row it returns the max of its dot products
with all ref patch rows (f32) and the first index attaining it (int32): ties
go to the lowest ref index, as ``torch.max`` and the TPU kernel resolve them.
On the card, bf16 inputs run on ``wgmma`` (bf16 products, f32 sums) and f32
inputs on TF32 tensor cores in three products per product (3xTF32: each
operand split into a TF32 high part and a TF32 remainder), which keeps f32
parity; both take the argmax from the accumulator registers.
The plain version is a transcription of ``tiled_argmax_matmul``
(``refvsr_tpu/models/matching.py:71-111``): f32 products over ref tiles with
a running (max, argmax) and a strict '>' across tiles.

Gradients follow the custom VJP ``_pallas_argmax_bwd``
(``matching_kernel.py:118-126``): conf is the dot product with the picked
ref row only, so ``d lr_p = g * ref_p[idx]`` and ``d ref_p`` is the
scatter-add of ``g * lr_p`` at ``idx``, both in f32 and cast to the input
dtype; the int32 index has no gradient. With gradients on and either input
requiring grad, ``argmax_matmul`` is recorded for autograd
(``_ArgmaxMatmul``); its backward is the plain version (a gather and
``index_add_``) for CPU tensors and a CUDA kernel for CUDA tensors.

Under a profiler session every forward call is the span ``refvsr.k2``
(``utils/trace.py``), on either path.
"""

from __future__ import annotations

import ctypes

import torch

from refvsr_tpu_torch.ops.kernels import build
from refvsr_tpu_torch.utils import trace

# the C launchers' arguments before the stream
_FORWARD_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
_BACKWARD_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the bf16 kernel holds its LR rows' A fragments in registers (D <= 144);
# the f32 kernel keeps 64 LR rows and two 64-row ref tiles of D + 4 floats
# in one block's shared memory
_MAX_D = {torch.float32: 288, torch.bfloat16: 144}


def argmax_matmul_plain(ref_p: torch.Tensor, lr_p: torch.Tensor,
                        tile: int | None = None):
    """ref_p (N, L_ref, D), lr_p (N, L_lr, D) -> (conf (N, L_lr) f32,
    index (N, L_lr) int32). The similarity matrix exists one ref tile at a
    time; products are f32 whatever the input dtype."""
    n, l_ref, _ = ref_p.shape
    l_lr = lr_p.shape[1]
    if tile is None:
        # each f32 similarity tile under ~256 MB, as the JAX version sizes it
        tile = max(256, min(4096, (256 << 20) // (4 * max(n * l_lr, 1))))
    tile = max(1, min(tile, l_ref))
    lr32 = lr_p.float()
    best = torch.full((n, l_lr), float("-inf"), device=lr_p.device)
    best_i = torch.zeros((n, l_lr), dtype=torch.int32, device=lr_p.device)
    for j0 in range(0, l_ref, tile):
        sim = torch.einsum("nrd,nld->nrl", ref_p[:, j0:j0 + tile].float(),
                           lr32)
        tile_max, tile_arg = sim.max(dim=1)
        upd = tile_max > best
        best = torch.where(upd, tile_max, best)
        best_i = torch.where(upd, tile_arg.to(torch.int32) + j0, best_i)
    return best, best_i


def argmax_matmul_backward_plain(ref_p: torch.Tensor, lr_p: torch.Tensor,
                                index: torch.Tensor, g: torch.Tensor):
    """Plain backward: (d ref_p, d lr_p) given conf's gradient g (N, L_lr),
    a transcription of ``_pallas_argmax_bwd``."""
    n, l_ref, d = ref_p.shape
    g32 = g.float()[..., None]
    idx = index.long()
    bidx = torch.arange(n, device=ref_p.device)[:, None]
    d_lr = (g32 * ref_p[bidx, idx].float()).to(lr_p.dtype)
    rows = (idx + bidx * l_ref).reshape(-1)
    d_ref = torch.zeros((n * l_ref, d), dtype=torch.float32,
                        device=ref_p.device)
    d_ref.index_add_(0, rows, (g32 * lr_p.float()).reshape(-1, d))
    return d_ref.reshape(ref_p.shape).to(ref_p.dtype), d_lr


def _forward(ref_p, lr_p):
    with trace.span("refvsr.k2"):
        if ref_p.device.type == "cpu":
            return argmax_matmul_plain(ref_p, lr_p)
        if ref_p.device.type != "cuda":
            raise ValueError(f"unsupported device {ref_p.device}")
        if ref_p.dtype not in _DTYPES:
            raise TypeError(f"argmax_matmul takes f32/bf16, got "
                            f"{ref_p.dtype}")
        n, l_ref, d = ref_p.shape
        l_lr = lr_p.shape[1]
        if l_ref == 0:
            raise ValueError("argmax_matmul needs at least one ref row")
        if d % 16 or d > _MAX_D[ref_p.dtype]:
            # the path's patch vectors are 3x3x16 = 144 wide
            raise ValueError(f"argmax_matmul needs D a multiple of 16 up "
                             f"to {_MAX_D[ref_p.dtype]} in {ref_p.dtype}, "
                             f"got {d}")
        for t in (ref_p, lr_p):
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError("argmax_matmul needs contiguous, 16-byte "
                                 "aligned inputs")
        conf = torch.empty((n, l_lr), dtype=torch.float32,
                           device=lr_p.device)
        index = torch.empty((n, l_lr), dtype=torch.int32,
                            device=lr_p.device)
        if conf.numel() == 0:
            return conf, index
        fn = build.function("argmax_matmul", "argmax_matmul_launch",
                            _FORWARD_ARGS)
        build.launch(fn, lr_p.device, ref_p.data_ptr(), lr_p.data_ptr(),
                     conf.data_ptr(), index.data_ptr(), n, l_ref, l_lr, d,
                     _DTYPES[ref_p.dtype])
        argmax_matmul.launches += 1
        return conf, index


def argmax_matmul_backward(ref_p: torch.Tensor, lr_p: torch.Tensor,
                           index: torch.Tensor, g: torch.Tensor,
                           needs=(True, True)):
    """(d ref_p, d lr_p) of argmax_matmul given conf's gradient g; each only
    where `needs` (for ref_p, lr_p) asks for it, else None. CPU tensors run
    the plain backward; CUDA tensors run the backward kernel (contiguous,
    16-byte aligned, D a multiple of 16; anything else raises).
    ``argmax_matmul_backward.launches`` counts kernel launches."""
    need_ref, need_lr = needs
    if ref_p.device.type == "cpu":
        d_ref, d_lr = argmax_matmul_backward_plain(ref_p, lr_p, index, g)
        return (d_ref if need_ref else None), (d_lr if need_lr else None)
    if ref_p.device.type != "cuda" or ref_p.dtype not in _DTYPES:
        raise ValueError(f"unsupported tensors {ref_p.device} {ref_p.dtype}")
    n, l_ref, d = ref_p.shape
    l_lr = lr_p.shape[1]
    if g.dtype != torch.float32:
        g = g.float()
    if not (ref_p.is_contiguous() and lr_p.is_contiguous()
            and index.is_contiguous() and g.is_contiguous()):
        raise ValueError("argmax_matmul_backward needs contiguous inputs")
    if index.dtype != torch.int32 or g.shape != (n, l_lr) \
            or index.shape != (n, l_lr):
        raise ValueError("argmax_matmul_backward: bad index or gradient")
    # what the forward takes, so every tensor it saves for autograd passes
    if d % 16 or ref_p.data_ptr() % 16 or lr_p.data_ptr() % 16:
        raise ValueError(f"argmax_matmul_backward needs D a multiple of 16 "
                         f"and 16-byte aligned inputs, got D {d}")
    # the launcher clears d_ref on the stream before the kernel
    d_ref = (torch.empty_like(ref_p, dtype=torch.float32) if need_ref
             else None)
    d_lr = torch.empty_like(lr_p) if need_lr else None
    if not lr_p.numel():
        if d_ref is not None:
            d_ref.zero_()
    elif need_ref or need_lr:
        fn = build.function("argmax_matmul", "argmax_matmul_backward_launch",
                            _BACKWARD_ARGS)
        build.launch(fn, ref_p.device, ref_p.data_ptr(), lr_p.data_ptr(),
                     index.data_ptr(), g.data_ptr(),
                     None if d_ref is None else d_ref.data_ptr(),
                     None if d_lr is None else d_lr.data_ptr(), n, l_ref,
                     l_lr, d, _DTYPES[ref_p.dtype])
        argmax_matmul_backward.launches += 1
    if d_ref is not None and ref_p.dtype != torch.float32:
        d_ref = d_ref.to(ref_p.dtype)
    return d_ref, d_lr


class _ArgmaxMatmul(torch.autograd.Function):
    """argmax_matmul with its backward pass; saves (ref_p, lr_p, index) as
    ``_pallas_argmax_fwd`` does. Each input's gradient is computed only when
    it requires grad (None otherwise)."""

    @staticmethod
    def forward(ctx, ref_p, lr_p):
        conf, index = _forward(ref_p, lr_p)
        ctx.save_for_backward(ref_p, lr_p, index)
        ctx.mark_non_differentiable(index)
        return conf, index

    @staticmethod
    def backward(ctx, g_conf, _g_index):
        return argmax_matmul_backward(*ctx.saved_tensors, g_conf,
                                      needs=ctx.needs_input_grad)


def argmax_matmul(ref_p: torch.Tensor, lr_p: torch.Tensor):
    """conf (N, L_lr) f32 and index (N, L_lr) int32 of
    max_r <ref_p[:, r], lr_p[:, l]>.

    CPU tensors run the plain version. CUDA tensors run the kernel (bf16 or
    f32, contiguous, 16-byte aligned, D a multiple of 16 up to 144 in bf16
    and 288 in f32); anything else raises. With gradients on and an input
    requiring grad, the call is recorded for autograd (``_ArgmaxMatmul``).
    ``argmax_matmul.launches`` counts forward kernel launches."""
    if ref_p.dim() != 3 or lr_p.dim() != 3 or ref_p.shape[0] != lr_p.shape[0] \
            or ref_p.shape[2] != lr_p.shape[2]:
        raise ValueError(f"want ref_p (N,L_ref,D) and lr_p (N,L_lr,D); got "
                         f"{tuple(ref_p.shape)} and {tuple(lr_p.shape)}")
    if ref_p.device != lr_p.device or ref_p.dtype != lr_p.dtype:
        raise ValueError("ref_p and lr_p differ in device or dtype")
    if torch.is_grad_enabled() and (ref_p.requires_grad or lr_p.requires_grad):
        return _ArgmaxMatmul.apply(ref_p, lr_p)
    return _forward(ref_p, lr_p)


argmax_matmul.launches = 0
argmax_matmul_backward.launches = 0
