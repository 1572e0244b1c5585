"""K4: gather rows of a table, as a CUDA kernel and its plain version.

Replaces the Pallas kernels of ``scripts/microbench_pallas_gather.py``
(``_take_kernel``, ``_scalar_kernel`` and ``_onehot_kernel``, launched by
``make_pallas_gather``), whose only caller is that microbenchmark
(``refvsr_tpu_torch.bench.microbench_gather`` here). The script's four
variants are four TPU formulations of one function, ported once. The
kernel source is ``refvsr_tpu_torch/csrc/gather_rows.cu``.

``out[p] = tab[idx[p]]``, with indices out of range clamped to [0, R - 1].
At or above R this is what the script's XLA reference
(``take_along_axis``, ``mode="clip"``) does; below 0 the reference first
wraps an index in [-R, 0) to R + index, numpy's rule, where the port takes
row 0 (``tests/test_torch_microbench.py`` pins both).
"""

from __future__ import annotations

import ctypes

import torch

from refvsr_tpu_torch.ops.kernels import build

# the C launchers' arguments before the stream
_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_longlong]

_DTYPES = (torch.float32, torch.bfloat16)


def gather_rows_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: ``tab[clamp(idx, 0, R - 1)]``, (P, L)."""
    return tab[idx.reshape(-1).long().clamp(0, tab.shape[0] - 1)]


def gather_rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(P, L) rows of tab (R, L) at idx (P, 1) or (P,) int32, each index
    clamped to [0, R - 1].

    tab is bf16 or f32, contiguous and 16-byte aligned, with rows of a
    multiple of 16 bytes (L * itemsize % 16 == 0); anything else raises.
    CPU tensors run the plain version; CUDA tensors run the kernel.
    ``gather_rows.launches`` counts kernel launches."""
    if tab.dim() != 2 or tab.shape[0] == 0:
        raise ValueError(f"want a table (R, L) with R > 0, got "
                         f"{tuple(tab.shape)}")
    if idx.dim() not in (1, 2) or (idx.dim() == 2 and idx.shape[1] != 1):
        raise ValueError(f"want idx (P, 1) or (P,), got {tuple(idx.shape)}")
    if tab.dtype not in _DTYPES or idx.dtype != torch.int32:
        raise TypeError(f"gather_rows takes a bf16/f32 table and int32 "
                        f"indices, got {tab.dtype} and {idx.dtype}")
    rows, lanes = tab.shape
    row_bytes = lanes * tab.element_size()
    if row_bytes % 16:
        raise ValueError(f"gather_rows needs rows of a multiple of 16 bytes, "
                         f"got {row_bytes}")
    if not tab.is_contiguous() or tab.data_ptr() % 16:
        raise ValueError("gather_rows needs a contiguous, 16-byte aligned "
                         "table")
    if idx.device != tab.device:
        raise ValueError("tab and idx differ in device")
    if tab.device.type == "cpu":
        return gather_rows_plain(tab, idx)
    if tab.device.type != "cuda":
        raise ValueError(f"unsupported device {tab.device}")
    idx = idx.reshape(-1).contiguous()
    out = torch.empty((idx.numel(), lanes), dtype=tab.dtype,
                      device=tab.device)
    if out.numel() == 0:
        return out
    fn = build.function("gather_rows", "gather_rows_launch", _ARGS)
    build.launch(fn, tab.device, tab.data_ptr(), idx.data_ptr(),
                 out.data_ptr(), rows, row_bytes, idx.numel())
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
