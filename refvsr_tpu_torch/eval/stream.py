"""Streaming video inference runtime; counterpart of
``refvsr_tpu/eval/stream.py``.

Owns the reference's branch reset (RefVSR.py:100-101,167-170,291-295): after
``reset_branch`` streamed windows the recurrence is re-anchored by running
``forward_first`` again.

Pipelined mode (``pipeline_lanes`` L > 1, ``models/refvsr.py``): outputs
come out L - 1 windows late, so the runner has a submit/flush interface.
``submit(window)`` returns zero, one or (around a reset or a new video) two
finished outputs, each with the caller's ``meta``; ``flush()`` drains the
chains in flight at a video's end on windows made by repeating the last
frame (the dataset's end-of-clip clamp, so the drained outputs equal the
plain stream's). In plain mode ``submit`` returns the window's own output
and ``flush`` returns nothing, so callers use one code path for both.

RefVSR-IR (``keyframe_stride`` set): each window gets a sliding keyframe
mask (``models/refvsr_ir.sliding_keyframe_mask``), whose first keyframe
carries over from window to window and starts again with the branch; the
IR net streams without pipelining.

Spatial sharding (``spatial``, from ``parallel/serve.spatial_eval_fns``):
every rank of the group runs the runner on the same windows; the windows
go through the spatial functions, which place each rank's rows, run the
net under the shard-local ops and gather the SR frame and the confidence
maps on every rank. Plain mode only, as in the JAX package.

Spans (``utils/trace.py``): under a profiler session every net call of
the runner is one frame, a device span named ``refvsr.runner.first`` (a
clip's first window), ``refvsr.runner.reanchor`` (``forward_first`` again
after ``reset_branch`` windows) or ``refvsr.runner.stream`` (a streamed,
priming or flushing dispatch); the network's stage spans nest inside it."""

from __future__ import annotations

import copy
import functools
from typing import Optional

import numpy as np
import torch

from refvsr_tpu_torch import resolve_device
from refvsr_tpu_torch.utils import trace


class StreamRunner:
    """Runs a RefVSRNet over consecutive windows of a video.

    The net runs on `device` (the card unless the caller asks for the CPU)
    in `compute_dtype`. The runner never changes the caller's net: it runs
    the net itself when its parameters already lie there in that dtype,
    else a copy moved and cast there (a trainer's f32 net validated in
    bf16 keeps its f32 parameters, and its training mode). `pipeline_lanes`
    must be the net's own (0 or 1 for the plain stream).
    `keyframe_stride`: the IR net's keyframe stride (None for RefVSR).
    `spatial`: the spatial functions (``parallel/serve.SpatialFns``) that
    run each window H-sharded over the group's ranks."""

    def __init__(self, net, reset_branch: Optional[int], device="cuda",
                 compute_dtype=torch.float32, pipeline_lanes: int = 0,
                 keyframe_stride: Optional[int] = None, spatial=None):
        self.device = resolve_device(device)
        if spatial is not None and pipeline_lanes > 1:
            raise ValueError("the spatial stream runs without pipelining: "
                             "pipeline_lanes must be 0")
        self.spatial = spatial
        if keyframe_stride is not None and pipeline_lanes > 1:
            raise ValueError("the IR net (keyframe_stride set) streams "
                             "without pipelining: pipeline_lanes must be 0")
        if max(pipeline_lanes, 1) != max(net.pipeline_lanes, 1):
            raise ValueError(f"pipeline_lanes={pipeline_lanes}, but the net "
                             f"was built with {net.pipeline_lanes}")
        if pipeline_lanes > 2 and reset_branch is not None:
            # a re-anchor mid-video would need one true window for each
            # chain in flight; only the single chain of L = 2 has it
            raise NotImplementedError(
                "pipeline_lanes > 2 with reset_branch set needs window "
                "lookahead; use pipeline_lanes=2 or reset_branch=None")
        self.compute_dtype = compute_dtype
        p = next(net.parameters())
        if p.dtype == compute_dtype and p.device.type == self.device.type \
                and self.device.index in (None, p.device.index):
            self.net = net
        else:
            self.net = copy.deepcopy(net).to(device=self.device,
                                             dtype=compute_dtype).eval()
        self.reset_branch = reset_branch
        self.pipeline_lanes = pipeline_lanes
        self.keyframe_stride = keyframe_stride
        self.kf_first: Optional[int] = None
        self.state = None
        self.count = 0
        self._pending = []        # metas of the outputs still in flight
        self._primes_left = 0     # priming dispatches before steady ones
        self._last_win = None     # (lrs, refs) of the last true window

    def _as_input(self, a):
        return torch.as_tensor(a).to(device=self.device,
                                     dtype=self.compute_dtype)

    # ---------------- plain per-window interface ----------------

    def process_device(self, lrs, refs, is_first: bool):
        """lrs/refs: (N, T, H, W, 3) arrays or tensors. Returns (sr (N, 4H,
        4W, 3) tensor on the device, conf_vis tuple). Dispatches first,
        reset and stream windows. Plain mode only: use submit() when the
        runner is pipelined."""
        if self.pipeline_lanes > 1:
            raise RuntimeError("the runner is pipelined: use submit() and "
                               "flush()")
        kind = ("first" if is_first or self.state is None else
                "reanchor" if self.reset_branch is not None
                and self.count == self.reset_branch else "stream")
        lrs, refs = self._as_input(lrs), self._as_input(refs)
        first = kind != "stream"
        kf = ()
        if self.keyframe_stride is not None:
            from refvsr_tpu_torch.models.refvsr_ir import \
                sliding_keyframe_mask
            mask, self.kf_first = sliding_keyframe_mask(
                lrs.shape[1], self.keyframe_stride,
                None if first else self.kf_first)
            kf = (mask,)
        first_fn, stream_fn = ((self.net.forward_first,
                                self.net.forward_stream)
                               if self.spatial is None else
                               (functools.partial(self.spatial.first,
                                                  self.net),
                                functools.partial(self.spatial.stream,
                                                  self.net)))
        with torch.inference_mode(), trace.frame(kind, lrs):
            if first:
                out, self.state, conf = first_fn(lrs, refs, *kf)
                self.count = 0
            else:
                out, self.state, conf = stream_fn(lrs, refs, self.state,
                                                  *kf)
        self.count += 1
        return out, conf

    def process(self, lrs, refs, is_first: bool):
        """Like process_device, with the SR frame as float32 numpy."""
        out, conf = self.process_device(lrs, refs, is_first)
        return out.float().cpu().numpy().astype(np.float32), conf

    # ---------------- submit/flush (plain and pipelined) ----------------

    def submit(self, lrs, refs, is_first: bool, meta=None):
        """Feed one window; returns the finished (meta, sr_device,
        conf_vis) tuples, oldest first: the window's own in plain mode,
        zero to two when pipelined."""
        if self.pipeline_lanes <= 1:
            out, conf = self.process_device(lrs, refs, is_first)
            return [(meta, out, conf)]
        emitted = []
        if is_first and self._pending:
            emitted.extend(self.flush())    # the previous video's tail
        lrs, refs = self._as_input(lrs), self._as_input(refs)
        net = self.net
        first_kind = "first"
        with torch.inference_mode():
            if (not is_first and self.reset_branch is not None
                    and self.count == self.reset_branch):
                # re-anchor (L = 2): this true window finishes the one chain
                # in flight (its last steps read only frames this window
                # holds), then starts over in forward_first below, so the
                # window serves two outputs, each as the plain stream
                # computes it
                if self._pending:
                    with trace.frame("stream", lrs):
                        out, self.state, conf = net.forward_stream_pipelined(
                            lrs, refs, self.state)
                    emitted.append((self._pending.pop(0), out, conf))
                is_first = True
                first_kind = "reanchor"
            if is_first or self.state is None:
                with trace.frame(first_kind, lrs):
                    out, self.state, conf = net.forward_first(lrs, refs)
                emitted.append((meta, out, conf))
                self.count = 0
                self._primes_left = self.pipeline_lanes - 1
            elif self._primes_left > 0:
                with trace.frame("stream", lrs):
                    self.state = net.forward_stream_prime(lrs, refs,
                                                          self.state)
                self._pending.append(meta)
                self._primes_left -= 1
            else:
                with trace.frame("stream", lrs):
                    out, self.state, conf = net.forward_stream_pipelined(
                        lrs, refs, self.state)
                self._pending.append(meta)
                emitted.append((self._pending.pop(0), out, conf))
        self.count += 1
        self._last_win = (lrs, refs)
        return emitted

    def flush(self):
        """Drain the outputs in flight (a video's end) on windows that
        shift by one frame and repeat the last. Returns the finished
        (meta, sr_device, conf_vis) tuples; none in plain mode."""
        emitted = []
        if not self._pending:
            return emitted
        lrs, refs = self._last_win
        net = self.net
        with torch.inference_mode():
            while self._pending:
                lrs = torch.cat([lrs[:, 1:], lrs[:, -1:]], 1)
                refs = torch.cat([refs[:, 1:], refs[:, -1:]], 1)
                with trace.frame("stream", lrs):
                    out, self.state, conf = net.forward_stream_pipelined(
                        lrs, refs, self.state)
                emitted.append((self._pending.pop(0), out, conf))
                self.count += 1
        self._last_win = (lrs, refs)
        return emitted
