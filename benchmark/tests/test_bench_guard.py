"""What the benchmark may load: no JAX, no JAX package, compared by the
whole top-level name of each module (``refvsr_tpu_torch`` begins with
``refvsr_tpu``); and a reference that takes nothing of the program."""

import ast
import subprocess
import sys

import pytest

from benchmark import core
from conftest import ROOT

BENCH = ROOT / "benchmark"


@pytest.mark.parametrize("modules, found", [
    (["refvsr_tpu_torch", "refvsr_tpu_torch.models.refvsr", "torch"], []),
    (["refvsr_tpu", "refvsr_tpu_torch"], ["refvsr_tpu"]),
    (["refvsr_tpu.models.refvsr"], ["refvsr_tpu.models.refvsr"]),
    (["jax.numpy", "jaxtyping", "jaxlib", "flaxen"], ["jax.numpy", "jaxlib"]),
    (["flax.linen"], ["flax.linen"]),
])
def test_forbidden_modules_compare_the_whole_top_level_name(modules, found):
    assert core.forbidden_modules(modules) == sorted(found)
    if found:
        with pytest.raises(core.Refused):
            core.guard(modules)
    else:
        core.guard(modules)


def imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def sources(sub=""):
    return [p for p in (BENCH / sub).rglob("*.py") if "tests" not in p.parts]


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "refvsr_tpu", "bench",
                       "run", "scripts", "tests"}


@pytest.mark.parametrize("path", sources("reference"), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in imports(path)}
    assert tops <= {"__future__", "torch"}


def test_a_run_loads_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import core, control, tracing, work\n"
            "from benchmark.generators import stream\n"
            "import refvsr_tpu_torch.models.refvsr, "
            "refvsr_tpu_torch.eval.stream\n"
            "reg = core.Registry()\n"
            "for m in reg.manifest['per_layer']:\n"
            "    reg.reader('metrics', m['name'])\n"
            "for m in reg.manifest['end_to_end']:\n"
            "    reg.reader('end_to_end', m['name'])\n"
            "print(core.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
