"""Build and load the CUDA kernels in ``refvsr_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library at first use, all sources at once (one ``nvcc``
process each, started together), then loaded with ``ctypes``. The libraries
go to ``refvsr_tpu_torch/_build/`` (listed in ``.gitignore``) under a name
that carries a hash of the source and flags, so an edited source rebuilds.
Nothing here runs when the module is imported."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class _Libraries:
    """Builds every source once per process; keeps the loaded libraries,
    their typed launchers, the compiler's resource report and the build
    time."""

    def __init__(self):
        self.libs: dict[str, ctypes.CDLL] = {}
        self.functions = {}   # (library, launcher) -> typed ctypes function
        self.log: dict[str, str] = {}
        self.seconds: float | None = None

    def _nvcc(self) -> str:
        for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
            if cand and os.path.exists(cand):
                return cand
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "on the machine with the card")

    def _target(self, src: Path) -> Path:
        h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"

    def build_all(self):
        if self.seconds is not None:
            return
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        sources = sorted(SRC_DIR.glob("*.cu"))
        jobs = {}
        for src in sources:
            out = self._target(src)
            if out.exists():
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [self._nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
            jobs[src.stem] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in jobs.items():
            text, _ = proc.communicate()
            self.log[name] = text
            if proc.returncode != 0:
                failed.append(f"{name}:\n{text}")
                os.unlink(tmp)
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
        for src in sources:
            self.libs[src.stem] = ctypes.CDLL(str(self._target(src)))
        self.seconds = time.perf_counter() - t0

    def lib(self, name: str) -> ctypes.CDLL:
        self.build_all()
        return self.libs[name]

    def function(self, lib: str, name: str, argtypes: list):
        fn = self.functions.get((lib, name))
        if fn is None:
            fn = getattr(self.lib(lib), name)
            fn.argtypes = [*argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self.functions[(lib, name)] = fn
        return fn


LIBS = _Libraries()


def function(lib: str, name: str, argtypes: list):
    """The C launcher `name` of ``csrc/<lib>.cu``, typed once, when it is
    first looked up after its library is loaded: `argtypes` (ctypes types),
    then the stream; it returns a cudaError_t as an int."""
    return LIBS.function(lib, name, argtypes)


def launch(fn, device, *args):
    """Call the C launcher `fn` with `args` and the current stream of
    `device` (its last argument); raise on the cudaError_t it returns. The
    device guard is entered only when `device` is not the current one. The
    stream is read as a raw pointer: ``torch._C._cuda_getCurrentRawStream``
    costs the host a few percent of ``torch.cuda.current_stream()``, which
    builds a Stream object (``bench/probe_backward.py`` times both)."""
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")
