"""BENCHMARK.json against the manifest's rules, and the harness finding every
piece by name: a configuration, a traffic mix and a metric added as files
run without an edit to any file the benchmark has."""

import json
import re
import textwrap

import pytest

from benchmark import core
from conftest import ROOT

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_manifest_keys_and_names():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert all(line(w) for w in MAN["command"])
    assert MAN["command"][1].startswith("benchmark/")
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["source"] == \
            c["source"]
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    pairs = set()
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and line(w["why"]) and w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "benchmark" / "traffic" /
                f"{w['traffic']}.json").exists()
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in
                                                 names)


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert (ROOT / "benchmark" / "end_to_end" /
                f"{m['name']}.py").exists()
    reg = core.Registry()
    for w in MAN["workloads"]:
        got, per = reg.metrics_of(w["name"])
        got = {m["name"] for m in got}
        assert "setup_s" in got and len(got) >= 2 and per


def test_per_layer_metrics_match_their_readers():
    reg = core.Registry()
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    layers = {}
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        rd = reg.reader("metrics", m["name"])
        assert rd.LAYER == m["layer"] and rd.MOVES == m["moves"]
        assert line(m["layer"]) and m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
        layers.setdefault(m["layer"], set()).add(m["name"])
        if m["name"].endswith("_roofline.stream") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_run_seconds_fits_the_check_with_24_cells():
    s = MAN["run_seconds"]
    assert 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_a_config_a_mix_and_a_metric_added_as_files_are_found(tmp_path):
    cfg_dir, tr_dir, m_dir = (tmp_path / d for d in ("c", "t", "m"))
    for d in (cfg_dir, tr_dir, m_dir):
        d.mkdir()
    (cfg_dir / "new_config.json").write_text(json.dumps({"num_blocks": 7}))
    (tr_dir / "new_mix.json").write_text(json.dumps({"generator": "stream",
                                                     "clip_frames": 3}))
    (m_dir / "new_metric.layer.py").write_text(textwrap.dedent('''
        LAYER = "a layer"
        MOVES = "stream_fps"
        RANGES = {}

        def read(run):
            return 2 * run.value
        '''))
    man = dict(MAN)
    man["configs"] = MAN["configs"] + [
        {"name": "new_config", "file": str(cfg_dir / "new_config.json")}]
    man["workloads"] = MAN["workloads"] + [
        {"name": "new_cell", "config": "new_config", "traffic": "new_mix",
         "chips": 1}]
    man["per_layer"] = MAN["per_layer"] + [
        {"name": "new_metric.layer", "unit": "ms", "layer": "a layer",
         "moves": "stream_fps", "workloads": ["new_cell"]}]
    reg = core.Registry(man, root=ROOT, dirs={"traffic": [tr_dir],
                                              "metrics": [m_dir]})
    cell = reg.cell("new_cell")
    assert reg.config(cell["config"]) == {"num_blocks": 7}
    assert reg.traffic(cell["traffic"])["clip_frames"] == 3
    e2e, per = reg.metrics_of("new_cell")
    assert [m["name"] for m in per] == ["new_metric.layer"]
    rd = reg.reader("metrics", "new_metric.layer")
    assert rd.read(type("R", (), {"value": 21})) == 42
    # the pieces already there are still found beside the new ones
    assert reg.traffic("stream_8k_long")["generator"] == "stream"
    with pytest.raises(KeyError):
        reg.traffic("no_such_mix")
