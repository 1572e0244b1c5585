"""The chip smoke's time bookkeeping, on synthetic profiler events and
stubbed phases (no card needed).

The backward launchers clear their f32 output (dx, d_ref) with a memset on
the stream just before the kernel, and a kernel's bound counts that output
written once, so ``chip_smoke.py`` counts the clear with the kernel: in a
traced training step the memset just before each launch on its stream
(``_clears``), and in a traced call every device operation the call issues
(``call_device_ms``). A pass that shows no kernel is fatal unless the
wrapper's launch count shows the kernel did run; a pass with no device
event at all is run again. A forward case gets the same "device (kernel)
/ call" split, with its library call's device time. Every phase of
``smoke()`` runs inside a clock of its own, and the closing lines report
the seconds of each."""

import json
from types import SimpleNamespace

import pytest
import torch

import chip_smoke

CUDA = torch.autograd.DeviceType.CUDA
TAG = "argmax_matmul_backward_kernel"


def _ev(name, start, end, stream=7, device_type=CUDA):
    return SimpleNamespace(
        name=name, device_type=device_type, device_resource_id=stream,
        time_range=SimpleNamespace(start=start, elapsed_us=lambda: end - start))


def _prof(events):
    return SimpleNamespace(events=lambda: events)


@pytest.mark.parametrize("events,want", [
    # clear then kernel, twice, listed out of time order
    ([_ev(f"void {TAG}<float>", 30, 40), _ev("Memset (Device)", 10, 14),
      _ev("Memset (Device)", 20, 26), _ev(f"void {TAG}<float>", 15, 19)],
     (0.010, 2)),
    # a memset on another stream, or with another kernel between, is not
    # this launch's clear
    ([_ev("Memset (Device)", 0, 5, stream=9), _ev(f"void {TAG}<float>", 6, 9),
      _ev("Memset (Device)", 10, 12), _ev("elementwise_kernel", 13, 14),
      _ev(f"void {TAG}<float>", 15, 20)], (0.0, 0)),
    # host events are not on any stream
    ([_ev("Memset (Device)", 0, 3), _ev("cudaLaunchKernel", 3, 4, stream=7,
                                        device_type="cpu"),
      _ev(f"void {TAG}<float>", 5, 9)], (0.003, 1)),
])
def test_clears_counts_the_memset_just_before_each_launch(events, want):
    ms, n = chip_smoke._clears(_prof(events), TAG)
    assert n == want[1]
    assert ms == pytest.approx(want[0])


def _wrapper(launch):
    def fn():
        if launch:
            fn.launches += 1
    fn.launches = 0
    return fn


def test_call_device_ms_counts_every_operation_of_the_call(monkeypatch):
    rows = [("Memset (Device)", 0.02, 10), (f"void {TAG}<float>", 0.09, 10),
            ("cast kernel", 0.01, 10)]
    monkeypatch.setattr(chip_smoke, "device_kernels",
                        lambda fn: (fn(), rows)[1])
    fn = _wrapper(True)
    dev, kernel = chip_smoke.call_device_ms(fn, fn, TAG, reps=10)
    assert fn.launches == 10
    assert dev == pytest.approx(0.012) and kernel == pytest.approx(0.009)


@pytest.mark.parametrize("launch", [True, False])
def test_call_device_ms_without_the_kernel(monkeypatch, launch):
    """A pass without the kernel: not measured if the wrapper launched it
    every call (the profiler lost it), fatal if it did not."""
    passes = []
    monkeypatch.setattr(chip_smoke, "device_kernels", lambda fn: (
        fn(), passes.append(1), [("Memset (Device)", 0.02, 10)])[2])
    fn = _wrapper(launch)
    if launch:
        assert chip_smoke.call_device_ms(fn, fn, TAG, reps=10,
                                         passes=3) == (None, None)
        assert len(passes) == 3 and fn.launches == 30
    else:
        with pytest.raises(SystemExit):
            chip_smoke.call_device_ms(fn, fn, TAG, reps=10, passes=3)
        assert len(passes) == 1


def test_forward_split_of_a_k1_case(monkeypatch):
    """A forward case gets the backward cases' "device (kernel) / call"
    split: every device operation of a traced call, the kernel's alone,
    and the library call's device time, beside the CUDA-event time of
    back-to-back calls (which at tiny shapes is the launcher's host time)."""
    rows = {"kernel": [("Memset (Device)", 0.01, 10),
                       ("void warp_sample_kernel<float, 1>", 0.06, 10)],
            "library": [("void grid_sampler_2d_kernel<float>", 0.12, 10),
                        ("elementwise_kernel", 0.02, 10)]}
    traced = []

    def device_kernels(fn):
        fn()
        traced.append("kernel" if not traced else "library")
        return rows[traced[-1]]
    monkeypatch.setattr(chip_smoke, "device_kernels", device_kernels)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, iters=10,
                        warmup=2: (fn(), 0.0353)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    gen = torch.Generator().manual_seed(0)
    x = torch.rand((2, 9, 11, 5), generator=gen)
    flow = chip_smoke._poison(chip_smoke._smooth_flow(gen, 2, 9, 11, 3.0,
                                                      "cpu"), gen)
    case = chip_smoke.k1_case("tiny f32", x, flow, 1e-5)
    assert traced == ["kernel", "library"]
    assert case["ms"] == 0.0353
    assert case["device_ms"] == pytest.approx(0.007)
    assert case["kernel_ms"] == pytest.approx(0.006)
    assert case["library_device_ms"] == pytest.approx(0.014)
    assert case["max_abs_err"] == 0.0


@pytest.mark.parametrize("empty,want", [(0, 0.014), (4, 0.014),
                                         (5, None)])
def test_a_pass_with_no_device_event_is_run_again(monkeypatch, empty, want):
    """A torch.profiler pass that holds no device event at all (the card
    loses whole passes in a long-lived process) is run again, up to
    PROFILER_PASSES passes; then the time is not measured, not zero."""
    passes = []

    def device_kernels(fn):
        fn()
        passes.append(1)
        return [] if len(passes) <= empty else [("grid_sampler", 0.14, 10)]
    monkeypatch.setattr(chip_smoke, "device_kernels", device_kernels)
    monkeypatch.setattr(chip_smoke, "PASSES", {"run": 0, "empty": 0})
    rows = chip_smoke.device_rows(lambda: None)
    got = sum(m for _, m, _ in rows) / 10 if rows else None
    assert got == (None if want is None else pytest.approx(want))
    assert chip_smoke.PROFILER_PASSES == 5
    assert chip_smoke.PASSES == {"run": min(empty + 1, 5),
                                 "empty": min(empty, 5)}


# what smoke() must clock, in order: every phase, the captured calls'
# moves to the host (summed) and their replay against the plain versions
PHASES = ["build", "k1", "k2", "k1_backward", "k2_backward", "microbench",
          "small_agreement", "small_training", "ir_small", "main_path",
          "serving", "pipelined", "spatial", "ddp", "training", "to_host",
          "bench_train", "train_entry", "ir_eval", "eval_cli_8k",
          "ir_train", "train_cli_ddp", "path_cases"]
# each function smoke() calls for a phase, with what it returns
STUBS = {
    "device_kernels": [], "phase_k1": [], "k1_host_pieces": {},
    "phase_k2": [],
    "phase_k1_backward": [], "phase_k2_backward": [],
    "phase_microbench": ({}, {"conv3x3_bias": ({}, [])}),
    "phase_small_agreement": None,
    "phase_small_training": None, "phase_ir_small": None,
    "phase_main_path": ({}, {}, {}, {}, {}, []),
    "phase_serving": ({}, {}, {}), "phase_pipelined": ({}, {}, {}),
    "phase_spatial": ({}, {}, {"argmax_matmul": [],
                               "warp_sample_banded": []}, []),
    "start_trees": None, "phase_ddp": ({}, {}),
    "phase_training": ({}, {}, {}, {}),
    "phase_bench_train": ({}, {}, {}),
    "phase_train_entry": ({}, {"amp": {"launches": {}}}, {}, {}),
    "phase_ir_eval": ({}, {}, {}), "phase_eval_cli_8k": ({}, {}, {}),
    "phase_ir_train": ({}, {}, {}), "phase_train_cli_ddp": {},
    "to_host": None, "path_cases": {"argmax_matmul": ([], [])},
    "kernels_line": []}


def _called_in_smoke():
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(chip_smoke.smoke))
    return {n.func.id for n in ast.walk(tree) if isinstance(n, ast.Call)
            and isinstance(n.func, ast.Name)
            and (n.func.id.startswith("phase_")
                 or n.func.id in STUBS)}


def test_phase_seconds_name_every_phase_of_smoke(monkeypatch, capsys):
    """smoke() with every phase stubbed: each phase runs inside a clock of
    its own, the phase_s map names them all in order, and the table at the
    end of the log lists each phase."""
    from refvsr_tpu_torch.ops.kernels import build
    assert _called_in_smoke() == set(STUBS)
    calls = []

    def stub(name):
        def f(*a, **k):
            calls.append((name, list(chip_smoke._OPEN)))
            return STUBS[name]
        return f
    for name in STUBS:
        monkeypatch.setattr(chip_smoke, name, stub(name))
    monkeypatch.setattr(chip_smoke, "SPANS", {})
    monkeypatch.setattr(chip_smoke, "card_line", lambda kind: "card, 700 W")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "card")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        torch.backends.cuda.matmul.allow_tf32)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                        torch.backends.cudnn.allow_tf32)
    monkeypatch.setattr(build.LIBS, "build_all", stub("build_all"))
    monkeypatch.setattr(build.LIBS, "seconds", 0.0)
    STUBS["build_all"] = None
    try:
        chip_smoke.smoke()
    finally:
        del STUBS["build_all"]
    assert list(chip_smoke.seconds_by_phase()) == PHASES
    # every stubbed call ran inside exactly one phase's clock; each phase
    # but to_host has one call (kernels_line shares path_cases')
    assert all(len(open_) == 1 for _, open_ in calls)
    by_phase = {}
    for name, open_ in calls:
        by_phase.setdefault(open_[0], []).append(name)
    assert set(by_phase) == set(PHASES)
    assert set(by_phase["to_host"]) == {"to_host"}
    assert set(by_phase["build"]) == {"build_all", "device_kernels"}
    assert by_phase["k1"] == ["phase_k1", "k1_host_pieces"]
    assert by_phase["ddp"] == ["start_trees", "phase_ddp"]
    assert by_phase["path_cases"] == ["path_cases", "kernels_line"]
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith('{"ok": true')
    closing = json.loads(next(ln for ln in out if ln.startswith(
        '{"main_path"')))
    assert list(closing["phase_s"]) == PHASES
    table = out[out.index(next(ln for ln in out if ln.startswith(
        "where the smoke's time goes"))) + 1:-2]
    assert [ln.split()[-1] for ln in table[1:-1]] == sorted(
        PHASES, key=lambda p: -closing["phase_s"][p])
