"""Runs one cell of the benchmark once; see ``benchmark/core.py``.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

Run from the root of a checkout. The set-up clock starts here, before
PyTorch is imported."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# run as a script, the interpreter puts benchmark/ itself first on the path;
# its modules are imported as the package's only
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") not in (HERE, ROOT)]

from benchmark import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(t_start=T_START))
