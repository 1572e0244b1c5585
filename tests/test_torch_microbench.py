"""K3 and K4: the plain versions and the microbenchmark entry points of the
port against the JAX package's Pallas experiments, on the CPU.

The two scripts are loaded from ``scripts/`` by path (they are not a
package) and are not edited. Importing ``microbench_pallas_conv.py`` points
JAX's compilation cache at the repository (``jax.config.update`` at import)
and puts the repository on ``sys.path``; the fixture puts both back at
once.

K3 (``conv3x3_bias``): ``pallas_conv`` runs in interpret mode at H 48, W 32
(H a multiple of its 24-row stripe), variants A and B, on the script's
seeded inputs; the plain version is held against each and against the
script's XLA reference (``lax.conv_general_dilated`` + bias) within
2^-8 max|y|: bf16 outputs, one bf16 ulp at the largest magnitude, sums in
another order. At ragged shapes (H not a multiple of 24, C 16) against the
XLA reference alone.

K4 (``gather_rows``): the plain version against ``make_pallas_gather`` in
interpret mode, all four kinds, bitwise (``onehot``, a one-hot matmul,
within 1e-6), and against ``jnp.take_along_axis(..., mode="clip")`` with
indices out of range on both sides.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py, which also runs both entry points
there."""

import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from refvsr_tpu_torch.bench import microbench_conv, microbench_gather
from refvsr_tpu_torch.ops.kernels.conv3x3 import (conv3x3_bias,
                                                  conv3x3_bias_plain)
from refvsr_tpu_torch.ops.kernels.gather_rows import (gather_rows,
                                                      gather_rows_plain)

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
_CACHE_KEYS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_compile_time_secs")


def _load_script(name):
    """scripts/<name>.py as a module, with JAX's cache settings and
    sys.path as they were before its import."""
    before = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in before.items():
            jax.config.update(k, v)
        sys.path[:] = path
    return mod


@pytest.fixture(scope="module")
def conv_script():
    return _load_script("microbench_pallas_conv")


@pytest.fixture(scope="module")
def gather_script():
    return _load_script("microbench_pallas_gather")


def _f32(a):
    return np.array(a, np.float32)


def _script_conv_inputs(h, w, c):
    """The conv script's inputs, built as its main() builds them."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((h, w, c)) * 0.1, jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((3, 3, c, c)) * 0.05, jnp.bfloat16)
    bias = jnp.asarray(rng.standard_normal((1, 1, c)) * 0.01, jnp.bfloat16)
    return x, k, bias


def _xla_conv(x, k, bias):
    """The script's reference: XLA's SAME conv, then + bias in bf16."""
    return lax.conv_general_dilated(
        x[None], k, (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))[0] + bias


def _plain(x, wm, bias):
    return conv3x3_bias_plain(*(torch.from_numpy(_f32(a)).to(torch.bfloat16)
                                for a in (x, wm, bias)))


@pytest.mark.parametrize("which", ["A", "B", "xla"])
def test_conv_plain_matches_pallas_conv(conv_script, monkeypatch, which):
    h, w = 48, 32
    monkeypatch.setattr(conv_script, "H", h)
    monkeypatch.setattr(conv_script, "W", w)
    monkeypatch.setattr(conv_script, "WP", -(-(w + 2) // 8) * 8)
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=pltpu.InterpretParams()))
    c, cp = conv_script.C, conv_script.CP
    x, k, bias = _script_conv_inputs(h, w, c)
    wm_a = k.reshape(9 * c, c)
    if which == "A":
        want = conv_script.pallas_conv(x, wm_a, bias, concat_k=True)
        wm = wm_a
    elif which == "B":
        wm_b = jnp.pad(k, [(0, 0), (0, 0), (0, cp - c), (0, 0)]).reshape(
            9 * cp, c)
        want = conv_script.pallas_conv(x, wm_b, bias, concat_k=False)
        wm = wm_b.reshape(9, cp, c)[:, :c].reshape(9 * c, c)
    else:
        want = _xla_conv(x, k, bias)
        wm = wm_a
    got = _plain(x, wm, bias)
    assert got.shape == (h, w, c) and got.dtype == torch.bfloat16
    want = _f32(want)
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= 2.0 ** -8 * float(np.abs(want).max())


@pytest.mark.parametrize("h,w,c", [(37, 53, 16), (25, 131, 48)])
def test_conv_plain_matches_xla_at_ragged_shapes(h, w, c):
    x, k, bias = _script_conv_inputs(h, w, c)
    want = _f32(_xla_conv(x, k, bias))
    got = _plain(x, k.reshape(9 * c, c), bias).float().numpy()
    assert np.abs(got - want).max() <= 2.0 ** -8 * np.abs(want).max()


def test_conv_bench_inputs_are_the_scripts():
    x, k, bias = _script_conv_inputs(24, 40, 16)
    xt, wmt, bt = microbench_conv.make_inputs(24, 40, 16)
    for a, t in ((x, xt), (k.reshape(9 * 16, 16), wmt), (bias, bt)):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(), _f32(a))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("kind", ["take", "scalar", "scalar8", "onehot"])
def test_gather_plain_matches_pallas_gather(gather_script, kind, dtype):
    rng = np.random.default_rng(1)
    tab = jnp.asarray(rng.random((64, 128)), dtype)
    idx = jnp.asarray(rng.integers(0, 64, (256, 1)), jnp.int32)
    want = _f32(gather_script.make_pallas_gather(
        kind, 64, 64, 128, interpret=True)(tab, idx))
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = gather_rows_plain(torch.from_numpy(_f32(tab)).to(tdt),
                            torch.from_numpy(np.array(idx)))
    assert got.shape == (256, 128) and got.dtype == tdt
    got = got.float().numpy()
    if kind == "onehot":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_gather_plain_clamps_like_take_along_axis(dtype):
    rng = np.random.default_rng(2)
    r, l, p = 50, 64, 333
    tab = jnp.asarray(rng.random((r, l)), dtype)
    idx = jnp.asarray(rng.integers(-40, r + 40, (p, 1)), jnp.int32)
    neg = np.asarray(idx)[:, 0] < 0
    assert neg.any() and bool((idx >= r).any())

    def clip(i):
        return _f32(jnp.take_along_axis(tab[None], i[None], axis=1,
                                        mode="clip")[0])
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = gather_rows_plain(torch.from_numpy(_f32(tab)).to(tdt),
                            torch.from_numpy(np.array(idx)))
    got = got.float().numpy()
    # at or above R both clamp to R - 1; below 0 the port clamps to 0, where
    # take_along_axis first wraps an index in [-R, 0) to R + index, as
    # numpy indexing does, and clips only what stays out of range
    np.testing.assert_array_equal(got, clip(jnp.maximum(idx, 0)))
    np.testing.assert_array_equal(got[~neg], clip(idx)[~neg])
    np.testing.assert_array_equal(clip(idx)[neg],
                                  _f32(tab)[np.asarray(idx)[neg, 0] + r])


def test_conv_wrapper_takes_plain_path_on_cpu():
    x, wm, bias = microbench_conv.make_inputs(13, 21, 32)
    before = conv3x3_bias.launches
    got = conv3x3_bias(x, wm, bias)
    assert conv3x3_bias.launches == before
    assert torch.equal(got, conv3x3_bias_plain(x, wm, bias))


@pytest.mark.parametrize("idx_shape", [(300, 1), (300,)])
def test_gather_wrapper_takes_plain_path_on_cpu(idx_shape):
    tab, idx = microbench_gather.make_inputs(40, 16, 300, torch.float32,
                                             -5, 45)
    before = gather_rows.launches
    got = gather_rows(tab, idx.reshape(idx_shape))
    assert gather_rows.launches == before
    assert torch.equal(got, gather_rows_plain(tab, idx))
    assert got.shape == (300, 16)


@pytest.mark.parametrize("c,dtype,err", [
    (24, torch.bfloat16, ValueError),       # C not a multiple of 16
    (96, torch.bfloat16, ValueError),       # beyond one block's memory
    (16, torch.float32, TypeError)])
def test_conv_wrapper_rejects(c, dtype, err):
    x = torch.zeros((8, 8, c), dtype=dtype)
    wm = torch.zeros((9 * c, c), dtype=dtype)
    bias = torch.zeros((1, 1, c), dtype=dtype)
    with pytest.raises(err):
        conv3x3_bias(x, wm, bias)


@pytest.mark.parametrize("lanes,dtype,idx_dtype,err", [
    (4, torch.bfloat16, torch.int32, ValueError),   # 8-byte rows
    (6, torch.float32, torch.int32, ValueError),    # 24-byte rows
    (16, torch.float16, torch.int32, TypeError),
    (16, torch.float32, torch.int64, TypeError)])
def test_gather_wrapper_rejects(lanes, dtype, idx_dtype, err):
    tab = torch.zeros((10, lanes), dtype=dtype)
    idx = torch.zeros((5, 1), dtype=idx_dtype)
    with pytest.raises(err):
        gather_rows(tab, idx)


def test_entry_points_raise_without_card():
    """Both entry points default to the card and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        microbench_conv.run((8, 8), 16)
    with pytest.raises(RuntimeError):
        microbench_gather.run(16, 8, 32)
    with pytest.raises(RuntimeError):
        microbench_gather.main(["--check"])


def test_gather_check_on_cpu_exits_zero(capsys):
    assert microbench_gather.main(["--check", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("plain vs numpy equal") == len(
        microbench_gather.CHECK_CASES)
    assert "clamped" in out


def test_entry_points_on_cpu_run_plain_only(capsys):
    assert microbench_conv.main(["--size", "24x40", "--channels", "16",
                                 "--device", "cpu"]) == 0
    res = microbench_gather.run(64, 128, 256, device="cpu")
    assert res["finite"] and "ms" not in res
    out = capsys.readouterr().out
    assert out.count("no time is measured") == 2
