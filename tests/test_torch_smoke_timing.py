"""The chip smoke's phase clock, on stubbed phases (no card needed).

Every phase of ``smoke()`` runs inside a clock of its own, and the closing
lines report the seconds of each."""

import json

import torch

import chip_smoke


# what smoke() must clock, in order: every phase, the captured calls'
# moves to the host (summed) and their replay against the plain versions
PHASES = ["build", "k1", "k2", "k1_backward", "k2_backward",
          "bench_entries", "small_agreement", "small_training", "ir_small", "main_path",
          "serving", "pipelined", "mfid_f32", "spatial", "ddp", "training", "to_host",
          "bench_train", "train_entry", "ir_eval", "eval_cli_8k",
          "ir_train", "train_cli_ddp", "path_cases"]
# each function smoke() calls for a phase, with what it returns
STUBS = {
    "phase_k1": None, "phase_k2": None,
    "phase_k1_backward": None, "phase_k2_backward": None,
    "phase_bench_entries": None,
    "phase_small_agreement": None,
    "phase_small_training": None, "phase_ir_small": None,
    "phase_main_path": ({}, {}, {}),
    "phase_serving": ({}, {}), "phase_pipelined": ({}, {}),
    "phase_mfid_f32": {},
    "phase_spatial": {},
    "start_trees": None, "phase_ddp": {},
    "phase_training": ({}, {}),
    "phase_bench_train": ({}, {}),
    "phase_train_entry": ({}, {}, {}),
    "phase_ir_eval": ({}, {}), "phase_eval_cli_8k": ({}, {}),
    "phase_ir_train": ({}, {}), "phase_train_cli_ddp": {},
    "to_host": None, "path_cases": None}


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
    # but to_host has one call
    assert all(len(open_) == 1 for _, open_ in calls)
    by_phase = {}
    for name, open_ in calls:
        by_phase.setdefault(open_[0], []).append(name)
    assert set(by_phase) == set(PHASES)
    assert set(by_phase["to_host"]) == {"to_host"}
    assert by_phase["build"] == ["build_all"]
    assert by_phase["k1"] == ["phase_k1"]
    assert by_phase["ddp"] == ["start_trees", "phase_ddp"]
    assert by_phase["path_cases"] == ["path_cases"]
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith('{"ok": true')
    closing = json.loads(next(ln for ln in out if ln.startswith(
        '{"main_path"')))
    assert list(closing["phase_s"]) == PHASES
    table = out[out.index(next(ln for ln in out if ln.startswith(
        "where the smoke's time goes"))) + 1:-2]
    assert [ln.split()[-1] for ln in table[1:-1]] == sorted(
        PHASES, key=lambda p: -closing["phase_s"][p])
