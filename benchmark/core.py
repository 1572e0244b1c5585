"""One run of one cell: find the cell's pieces by name, set up, measure,
check against the reference, print the result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

Pieces, found by name under ``benchmark/``:

- ``BENCHMARK.json``'s cell names its configuration (the file the manifest
  gives) and its traffic mix (``traffic/<name>.json``), whose
  ``generator`` names the module under ``generators/`` that runs it;
- each end-to-end metric is read by ``end_to_end/<name>.py`` and each
  per-layer metric by ``metrics/<name>.py``: ``read(run)`` returns the
  number or None (nothing to read; the metric is left out of the line).
  A per-layer reader declares ``LAYER``, ``MOVES`` and ``RANGES``, the
  program entries it needs timed (``tracing.RangeSet``).

The last line of standard output is the result, a JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(``breakdown`` with ``--trace 1``) and, last, ``compared``: each number
the comparison with the reference decided on, with its limit. The same
numbers end standard error. Without a card, or with fewer cards than the
cell asks for, the run exits non-zero and prints no result; so it does if
JAX or the JAX package is loaded when the window has closed."""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "refvsr_tpu"})


class Refused(RuntimeError):
    """The run cannot be made here (no card, too few cards, a forbidden
    module loaded): exit non-zero, print no result."""


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def guard(modules=None):
    found = forbidden_modules(modules)
    if found:
        raise Refused(f"forbidden modules loaded: {found}")


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(
        "benchmark_piece_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Registry:
    """The manifest and the files it names. `dirs` maps a kind
    ("traffic", "end_to_end", "metrics") to the directories searched in
    order, so that tests can add their own."""

    def __init__(self, manifest: dict | None = None, root: Path = ROOT,
                 dirs: dict | None = None):
        self.root = root
        self.manifest = manifest if manifest is not None else json.loads(
            (root / "BENCHMARK.json").read_text())
        self.dirs = {k: [HERE / k] for k in ("traffic", "end_to_end",
                                             "metrics")}
        for k, extra in (dirs or {}).items():
            self.dirs[k] = list(extra) + self.dirs[k]

    def _find(self, kind, name, suffix):
        for d in self.dirs[kind]:
            p = Path(d) / f"{name}{suffix}"
            if p.exists():
                return p
        raise KeyError(f"no {kind} file for {name!r}")

    def cell(self, name: str) -> dict:
        for c in self.manifest["workloads"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.manifest["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads(self._find("traffic", name, ".json").read_text())

    def reader(self, kind: str, name: str):
        return _load(self._find(kind, name, ".py"))

    def metrics_of(self, cell: str):
        """(end-to-end metric entries, per-layer entries) the cell
        reports."""
        e2e = [m for m in self.manifest["end_to_end"]
               if cell in m.get("workloads", [cell])]
        moved = {m["name"] for m in e2e}
        per = [m for m in self.manifest["per_layer"]
               if (cell in m["workloads"] if "workloads" in m
                   else m["moves"] in moved)]
        return e2e, per


class Context:
    """What a generator needs of the run: the cell's configuration and
    traffic, the seed, the device, and how the runner is made."""

    def __init__(self, config, traffic, seed, device, make_runner=None):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.make_runner = make_runner or default_runner

    def generator(self):
        mod = importlib.import_module(
            f"benchmark.generators.{self.traffic['generator']}")
        return mod.Stream(self)


def default_runner(net, reset_branch, device, dtype):
    from refvsr_tpu_torch.eval.stream import StreamRunner
    return StreamRunner(net, reset_branch, device=device,
                        compute_dtype=dtype)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"


def run_cell(registry: Registry, workload: str, seed: int, seconds: float,
             trace: bool, device="cuda", t_start=None, make_runner=None):
    """One run; returns (result dict, the generator's run object)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = registry.cell(workload)
    config = registry.config(cell["config"])
    traffic = registry.traffic(cell["traffic"])
    e2e, per = registry.metrics_of(workload)
    run = Context(config, traffic, seed, device, make_runner).generator()
    run.setup()
    run.setup_s = time.perf_counter() - t_start
    run.window(seconds)
    cuda = torch.device(device).type == "cuda"
    run.memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    guard()
    reported = per if trace else e2e
    readers = {m["name"]: registry.reader(
        "metrics" if trace else "end_to_end", m["name"]) for m in reported}
    if trace:
        from benchmark import tracing
        ranges = {}
        for r in readers.values():
            ranges.update(r.RANGES)
        run.traced_pass(tracing.RangeSet(ranges))
    run.release_program()
    run.check(config["limits"])
    guard()
    metrics = {}
    for m in reported:
        v = readers[m["name"]].read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": run.memory_peak}
    result = {"correct": run.failed == 0, "attempted": len(run.frames),
              "failed": run.failed, "metrics": metrics, "device": dev}
    if trace:
        t = run.trace
        dev["busy_s"], dev["window_s"] = t.busy_s, t.window_s
        result["breakdown"] = {"device_ops": t.top(t.by_kernel),
                               "idle_gaps": t.top(t.gaps)}
    result["compared"] = run.compared
    return result, run


def main(argv=None, t_start=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    try:
        registry = Registry()
        cell = registry.cell(a.workload)
        if not torch.cuda.is_available():
            raise Refused("no CUDA card: torch.cuda.is_available() is False")
        if torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"the cell asks for {cell['chips']} cards, "
                          f"{torch.cuda.device_count()} present")
        result, run = run_cell(registry, a.workload, a.seed, a.seconds,
                               bool(a.trace), t_start=t_start)
    except Refused as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    except Exception:
        traceback.print_exc()
        return 1
    print(f"card: {card_line()}", file=sys.stderr)
    print(f"frames timed: {len(run.frames)}; window {run.window_s:.3f} s; "
          f"reference {run.reference_s:.1f} s", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
