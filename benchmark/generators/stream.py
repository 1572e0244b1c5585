"""Generator ``stream``: one closed-loop video stream through the program's
``StreamRunner``, its windows of T frames sliding by one frame each.

A traffic file of this generator holds:

- ``lr_hw``, ``ref_hw``: the sizes of the LR and reference frames. A clip
  of ``clip_frames`` frames of each is drawn from the seed on the device,
  uniform in [0, 1), in the configuration's dtype; window w reads frames
  w .. w + T - 1 of it, modulo its length.
- ``warmup_windows``: windows run before the measured window (the first
  window included), a whole number of cycles. A cycle is the
  configuration's ``reset_branch`` windows (one re-anchor, then streamed
  windows), or one window without it.
- the measured window starts at a cycle's first window and runs whole
  cycles: after each, another starts only if one more cycle as long as the
  last still ends within ``--seconds``. Each frame is timed on the host
  from handing its window to the runner until its SR frame is synchronised.
- ``trace_cycles``: whole cycles run after the window under the profiler
  when the run is traced.
- ``compare``: which SR frames of the window, with the state each hands
  on, are compared with the reference besides the window's last:
  ``drawn`` ({kind: count}), frames of a kind ("stream" or "reanchor")
  drawn from the seed uniformly among the window's frames of that kind."""

from __future__ import annotations

import gc
import random
import time

import torch

from benchmark import compare
from benchmark.reference import refvsr as reference
from benchmark import weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def kind_of(w: int, reset_branch) -> str:
    """'first' for the clip's first window, 'reanchor' where the runner
    runs forward_first again (its count reaches reset_branch), else
    'stream'."""
    if w == 0:
        return "first"
    if reset_branch and w % reset_branch == 0:
        return "reanchor"
    return "stream"


class Clip:
    """The stream's frames on the device, (F, H, W, 3) each."""

    def __init__(self, traffic: dict, seed: int, dtype, device):
        gen = torch.Generator(device=device).manual_seed(seed)
        f = traffic["clip_frames"]
        self.lr, self.ref = (
            torch.rand((f, *hw, 3), generator=gen, device=device).to(dtype)
            for hw in (traffic["lr_hw"], traffic["ref_hw"]))
        self.frames = f

    def window(self, w: int, t: int):
        """(lrs, refs) of window w, each (1, T, H, W, 3)."""
        lo = w % self.frames
        if lo + t <= self.frames:
            return self.lr[None, lo:lo + t], self.ref[None, lo:lo + t]
        idx = torch.tensor([(w + j) % self.frames for j in range(t)],
                           device=self.lr.device)
        return (self.lr.index_select(0, idx)[None],
                self.ref.index_select(0, idx)[None])


class Keeper:
    """The window's frames to compare: the last, and per kind a reservoir
    sample drawn from the seed, so that only the kept SR frames stay on
    the device."""

    def __init__(self, seed: int, spec: dict):
        self.rng = random.Random(seed)
        self.want = dict(spec.get("drawn", {}))
        self.seen = {k: 0 for k in self.want}
        self.drawn = {}
        self.last = None

    def offer(self, w: int, kind: str, out):
        self.last = (w, out)
        if kind in self.want and self.want[kind] > 0:
            self.seen[kind] += 1
            slots = self.drawn.setdefault(kind, [])
            n = self.want[kind]
            if len(slots) < n:
                slots.append((w, out))
            else:
                j = self.rng.randrange(self.seen[kind])
                if j < n:
                    slots[j] = (w, out)

    def kept(self) -> dict:
        out = {}
        for slots in self.drawn.values():
            out.update(dict(slots))
        if self.last is not None:
            out[self.last[0]] = self.last[1]
        return out


def state_dict_shapes(net) -> dict:
    return {k: tuple(v.shape) for k, v in net.state_dict().items()}


def build_program(cfg: dict, sd: dict, dtype, device):
    """The program's network at the configuration's sizes with the
    benchmark's weights."""
    from refvsr_tpu_torch.models.refvsr import RefVSRNet
    with torch.device("meta"):
        net = _net(RefVSRNet, cfg)
    net = net.to_empty(device=device).to(dtype)
    net.load_state_dict(sd)
    return net.eval()


def _net(cls, cfg):
    return cls(scale=cfg["scale"], num_blocks=cfg["num_blocks"],
               mid_channels=cfg["mid_channels"],
               matching_ksize=cfg["matching_ksize"],
               flag_HD_in=cfg["flag_HD_in"])


def program_shapes(cfg: dict) -> dict:
    from refvsr_tpu_torch.models.refvsr import RefVSRNet
    with torch.device("meta"):
        return state_dict_shapes(_net(RefVSRNet, cfg))


def make_weights(cfg: dict, seed: int, device) -> dict:
    return weights.make(program_shapes(cfg), seed, DTYPES[cfg["dtype"]],
                        device)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Stream:
    """One run of the generator; the harness reads its fields."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.traffic = ctx.config, ctx.traffic
        self.dtype = DTYPES[self.cfg["dtype"]]
        self.device = ctx.device
        self.cycle = self.cfg["reset_branch"] or 1
        self.t = self.cfg["frame_num"]
        self.frames = []        # the window's frames: w, kind, ms
        self.trace = None
        self.memory_peak = None
        self.compared = self.failed = None
        self.reference_s = None
        self.clock = time.perf_counter

    # ------------------------------------------------------------ program

    def setup(self):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.sd = make_weights(self.cfg, self.ctx.seed, self.device)
        net = build_program(self.cfg, self.sd, self.dtype, self.device)
        self.runner = self.ctx.make_runner(net, self.cfg["reset_branch"],
                                           self.device, self.dtype)
        self.clip = Clip(self.traffic, self.ctx.seed, self.dtype,
                         self.device)
        self.keeper = Keeper(self.ctx.seed, self.traffic["compare"])
        self.w = 0
        warm = self.traffic["warmup_windows"]
        if warm < 1 or warm % self.cycle:
            raise ValueError(f"warmup_windows {warm} is not a whole number "
                             f"of {self.cycle}-window cycles")
        for _ in range(warm):
            self._frame()

    def _frame(self, keep=False):
        w = self.w
        kind = kind_of(w, self.cfg["reset_branch"])
        lrs, refs = self.clip.window(w, self.t)
        t0 = self.clock()
        out, _ = self.runner.process_device(lrs, refs, is_first=(w == 0))
        _sync(self.device)
        ms = (self.clock() - t0) * 1e3
        if keep:
            self.frames.append({"w": w, "kind": kind, "ms": ms})
            st = self.runner.state
            self.keeper.offer(w, kind, (out, {
                "feat_prop": st.feat_prop, "feat_prop_up": st.feat_prop_up}))
        self.w += 1

    def window(self, seconds: float):
        """Whole cycles within `seconds`; returns the window's seconds."""
        t0 = self.clock()
        while True:
            c0 = self.clock()
            for _ in range(self.cycle):
                self._frame(keep=True)
            end = self.clock()
            if (end - t0) + (end - c0) > seconds:
                break
        self.window_s = end - t0
        return self.window_s

    def traced_pass(self, ranges):
        from benchmark import tracing

        def cycles():
            n = self.traffic["trace_cycles"] * self.cycle
            for _ in range(n):
                self._frame()
            return n
        self.trace = tracing.traced(cycles, ranges)

    def release_program(self):
        self.kept = self.keeper.kept()
        self.keeper = None
        self.runner = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # ---------------------------------------------------------- reference

    def check(self, limits: dict):
        """Replay the kept frames' windows through the reference and judge
        the served frames."""
        t0 = time.perf_counter()
        per_frame = []
        for w, ref_out, ref_state, base in reference_frames(
                self.cfg, self.sd, self.clip, sorted(self.kept)):
            out, state = self.kept[w]
            per_frame.append(compare.frame_numbers(out, ref_out, state,
                                                   ref_state, base))
        self.compared, self.failed = compare.judge(per_frame, limits)
        self.reference_s = time.perf_counter() - t0


def reference_frames(cfg, sd, clip, wanted, precision="f32"):
    """Yield (w, SR frame (1, 3, 4H, 4W) f32, carried state, the bicubic
    upscale of the window's centre frame) of the reference for each window
    in `wanted` (sorted), replaying the stream
    from the last first or re-anchor window before the earliest one;
    windows between carry the state on without an output."""
    net = reference.Net(sd, cfg["num_blocks"], cfg["mid_channels"],
                        cfg["scale"], cfg["flag_HD_in"],
                        cfg["matching_ksize"], reference.Quant(precision))
    r = cfg["reset_branch"]
    start = 0 if not r else (wanted[0] // r) * r
    s = reference.Stream(net)
    t = cfg["frame_num"]
    todo = set(wanted)
    for w in range(start, wanted[-1] + 1):
        lrs, refs = (x.float().permute(0, 1, 4, 2, 3)
                     for x in clip.window(w, t))
        first = kind_of(w, r) != "stream" or w == start
        if w in todo:
            yield (w, s.window(lrs, refs, first), s.state(),
                   reference.bicubic(lrs[:, t // 2], cfg["scale"]))
        else:
            s.advance(lrs, refs, first)
