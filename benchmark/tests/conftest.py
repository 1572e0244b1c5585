"""Shared pieces of the benchmark's tests: the repository's root on the
path, the ``cuda`` marker, a card fixture, and cells cut to a size the CPU
runs in seconds (every width of the configuration kept unless a test asks
otherwise; the frames 32 x 48)."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELLS = {"stream_8k_bf16": ("RefVSR_MFID_8K", "stream_8k_long"),
         "stream_1080p_f32": ("RefVSR_MFID", "stream_1080p_reset9")}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def tiny_registry(tmp_path, cell, config=None, traffic=None):
    """A Registry whose cell `cell` runs its configuration and traffic with
    the overrides given, on 32 x 48 frames by default."""
    from benchmark import core
    cfg_name, tr_name = CELLS[cell]
    cfg = json.loads((ROOT / "benchmark" / "configs" /
                      f"{cfg_name}.json").read_text())
    cfg.update(config or {})
    tr = json.loads((ROOT / "benchmark" / "traffic" /
                     f"{tr_name}.json").read_text())
    tr.update({"lr_hw": [32, 48], "ref_hw": [32, 48], "clip_frames": 12},
              **(traffic or {}))
    d = tmp_path / "tiny"
    d.mkdir(exist_ok=True)
    (d / "tiny_config.json").write_text(json.dumps(cfg))
    (d / "tiny_traffic.json").write_text(json.dumps(tr))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    man["configs"] = [{"name": "tiny_config",
                       "file": str(d / "tiny_config.json")}]
    man["workloads"] = [{"name": cell, "config": "tiny_config",
                         "traffic": "tiny_traffic", "chips": 1}]
    return core.Registry(man, root=Path("/"), dirs={"traffic": [d]})


@pytest.fixture
def tiny(tmp_path):
    def make(cell, config=None, traffic=None):
        return tiny_registry(tmp_path, cell, config, traffic)
    return make
