"""K4's microbenchmark: the hand-written row gather beside
``torch.index_select``; counterpart of
``scripts/microbench_pallas_gather.py``.

    python -m refvsr_tpu_torch.bench.microbench_gather [--check]
        [--rows 2048] [--lanes 128] [--points 1048576] [--device cuda]

The script's four TPU variants (take, scalar, scalar8, onehot) are four
formulations of one function, ported once as K4. Its ``--chunk`` option, the
rows that one TPU grid step gathers, is dropped: the kernel's blocks cut P
themselves.

On the card it gathers P rows of a seeded (R, L) bf16 table (numpy
``default_rng(0)``: uniform values, indices in [0, R)), holds K4 bitwise
against its plain version, and times K4, ``index_select`` (the yardstick,
the counterpart of the script's ``xla_small``) and the plain version by
CUDA events after warm-up, in ms and ns per gathered row.

``--check``: on the card, K4 against its plain version, bitwise, at the
script's check size (R 64, L 128, P 256) in f32 and in bf16, and at a
ragged size with indices below 0 and at or above R; with ``--device cpu``,
the plain version against a numpy gather at the same sizes. Exits 1 on any
mismatch.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from refvsr_tpu_torch import resolve_device
from refvsr_tpu_torch.bench import bound_ms, cuda_ms
from refvsr_tpu_torch.ops.kernels.gather_rows import (gather_rows,
                                                      gather_rows_plain)

# (R, L, P, dtype, index range): the script's check size in f32 and bf16,
# then a ragged size whose indices leave [0, R) on both sides
CHECK_CASES = ((64, 128, 256, torch.float32, (0, 64)),
               (64, 128, 256, torch.bfloat16, (0, 64)),
               (1000, 72, 4099, torch.bfloat16, (-50, 1050)))


def make_inputs(rows, lanes, points, dtype=torch.bfloat16, lo=0, hi=None,
                device="cpu"):
    """A seeded table (R, L) of uniform values in `dtype` and int32 indices
    (P, 1) in [lo, hi) (hi defaults to R)."""
    rng = np.random.default_rng(0)
    tab = torch.from_numpy(rng.random((rows, lanes), dtype=np.float32))
    idx = rng.integers(lo, rows if hi is None else hi, (points, 1),
                       dtype=np.int32)
    return tab.to(dtype).to(device), torch.from_numpy(idx).to(device)


def check(device="cuda", log=print):
    """K4 (or, on the CPU, its plain version) against its reference at the
    CHECK_CASES; returns one dict per case."""
    dev = resolve_device(device)
    cases = []
    for rows, lanes, points, dtype, (lo, hi) in CHECK_CASES:
        tab, idx = make_inputs(rows, lanes, points, dtype, lo, hi, dev)
        if dev.type == "cpu":
            got = gather_rows_plain(tab, idx)
            want = torch.from_numpy(
                tab.float().numpy()[np.clip(idx.numpy()[:, 0], 0, rows - 1)])
            what = "plain vs numpy"
        else:
            got = gather_rows(tab, idx)
            want = gather_rows_plain(tab, idx)
            what = "kernel vs plain"
        equal = bool(torch.equal(got.float().cpu(), want.float().cpu()))
        clamped = int(((idx < 0) | (idx >= rows)).sum())
        cases.append(dict(rows=rows, lanes=lanes, points=points,
                          dtype=str(dtype), clamped=clamped, equal=equal,
                          max_abs_err=float((got.float().cpu()
                                             - want.float().cpu()).abs()
                                            .max())))
        log(f"K4 check R {rows} L {lanes} P {points} {dtype}, {clamped} "
            f"indices clamped: {what} {'equal' if equal else 'DIFFER'}")
    return cases


def run(rows=2048, lanes=128, points=1 << 20, device="cuda", log=print):
    """K4 against its plain version and index_select at (R, L, P), bf16;
    returns the numbers as a dict (times in ms)."""
    dev = resolve_device(device)
    tab, idx = make_inputs(rows, lanes, points, device=dev)
    flat = idx.reshape(-1)
    nbytes = (tab.numel() * tab.element_size() + idx.numel() * 4
              + points * lanes * tab.element_size())
    res = dict(rows=rows, lanes=lanes, points=points, device=str(dev),
               nbytes=nbytes, flops=0.0)
    if dev.type == "cpu":
        got = gather_rows_plain(tab, idx)
        res["finite"] = bool(torch.isfinite(got.float()).all())
        log(f"K4 gather_rows R {rows} L {lanes} P {points} bf16 on the CPU: "
            f"plain version only (the kernel runs on the card); no time is "
            f"measured on the CPU")
        return res
    got = gather_rows(tab, idx)
    want = gather_rows_plain(tab, idx)
    res["equal"] = bool(torch.equal(got, want))
    res["max_abs_err"] = float((got.float() - want.float()).abs().max())
    res["ms"] = cuda_ms(lambda: gather_rows(tab, idx), 20)
    res["library_ms"] = cuda_ms(lambda: tab.index_select(0, flat), 20)
    res["plain_ms"] = cuda_ms(lambda: gather_rows_plain(tab, idx), 20)
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 0.0, torch.bfloat16)
    for k in ("ms", "library_ms", "plain_ms"):
        res[k.replace("ms", "ns_per_row")] = res[k] * 1e6 / points
    log(f"K4 gather_rows R {rows} L {lanes} P {points} bf16: kernel vs plain "
        f"{'equal' if res['equal'] else 'DIFFER'}")
    log(f"  kernel {res['ms']:.4f} ms ({res['ns_per_row']:.4f} ns/row); "
        f"index_select {res['library_ms']:.4f} ms "
        f"({res['library_ns_per_row']:.4f} ns/row); plain "
        f"{res['plain_ms']:.4f} ms; bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']})")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="parity at small sizes, clamped indices included")
    ap.add_argument("--rows", type=int, default=2048)
    ap.add_argument("--lanes", type=int, default=128)
    ap.add_argument("--points", type=int, default=1 << 20)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if a.check:
        ok = all(c["equal"] for c in check(a.device))
    else:
        res = run(a.rows, a.lanes, a.points, a.device)
        ok = res.get("equal", res.get("finite"))
    if not ok:
        print("FAIL: K4 differs from its reference", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
