"""The port's config surface, TensorBoard event writer and console helpers
against the JAX package and TensorBoard's own reader, on the CPU.

Configs: every variant, field by field; ``save_config`` from either package
read back by the other's ``load_config``; the unknown-key warning; the data
paths. Events: files written by ``utils/events.py`` read back by
tensorboard's ``EventFileLoader`` (the record framing, the CRCs and the
proto encoding) with their tags, steps and values; CRC-32C against the
published check values (RFC 3720, B.4)."""

import dataclasses
import json
import struct

import numpy as np
import pytest
import torch

from refvsr_tpu.configs import Config as JaxConfig
from refvsr_tpu.configs import _VARIANTS as JAX_VARIANTS
from refvsr_tpu.configs import get_config as jax_get_config
from refvsr_tpu.configs import load_config as jax_load_config
from refvsr_tpu.configs import save_config as jax_save_config
from refvsr_tpu.configs import set_data_path as jax_set_data_path
from refvsr_tpu.utils import console as jax_console
from refvsr_tpu_torch.configs import (Config, EvalConfig, get_config,
                                      load_config, save_config, set_data_path)
from refvsr_tpu_torch.utils import console
from refvsr_tpu_torch.utils.events import EventWriter, crc32c, masked_crc32c
from refvsr_tpu_torch.utils.profiling import param_count, write_cost_report


def _fields(c):
    return dataclasses.asdict(c)


def test_config_fields_match_jax():
    assert [f.name for f in dataclasses.fields(Config)] == [
        f.name for f in dataclasses.fields(JaxConfig)]
    assert _fields(Config()) == _fields(JaxConfig())


@pytest.mark.parametrize("name", sorted(JAX_VARIANTS))
def test_variants_match_jax(name):
    assert _fields(get_config(name)) == _fields(jax_get_config(name))
    over = dict(scale=2, frame_itr_num=3, batch_size=2)
    assert _fields(get_config("config_" + name, **over)) == _fields(
        jax_get_config("config_" + name, **over))


def test_unknown_variant_raises():
    with pytest.raises(KeyError):
        get_config("RefVSR_nope")


@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("name", ["RefVSR_MFID", "RefVSR_MFID_8K"])
def test_set_data_path_matches_jax(name, is_train):
    kw = dict(data_offset="/data")
    want = jax_set_data_path(jax_get_config(name, **kw), is_train)
    got = set_data_path(get_config(name, **kw), is_train)
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_config_json_round_trips_across_packages(tmp_path, writer):
    c = get_config("RefVSR_small_MFID_8K", mode="x", batch_size=3,
                   decay_period=(10, 20))
    cj = jax_get_config("RefVSR_small_MFID_8K", mode="x", batch_size=3,
                        decay_period=(10, 20))
    path = str(tmp_path / "config" / "config.json")
    (save_config if writer == "port" else jax_save_config)(
        c if writer == "port" else cj, path)
    assert _fields(load_config(path)) == _fields(c)
    assert _fields(jax_load_config(path)) == _fields(cj)


def test_config_json_bytes_match_jax(tmp_path):
    c = set_data_path(get_config("RefVSR_MFID_8K", mode="m"), True)
    cj = jax_set_data_path(jax_get_config("RefVSR_MFID_8K", mode="m"), True)
    save_config(c, str(tmp_path / "a" / "config.json"))
    jax_save_config(cj, str(tmp_path / "b" / "config.json"))
    assert (tmp_path / "a" / "config.json").read_bytes() == (
        tmp_path / "b" / "config.json").read_bytes()


def test_load_config_warns_on_unknown_keys(tmp_path):
    d = dataclasses.asdict(get_config("RefVSR_MFID"))
    d["batch_sise"] = 4
    d["EVAL"]["bogus"] = 1
    path = tmp_path / "config.json"
    path.write_text(json.dumps(d))
    with pytest.warns(UserWarning) as got:
        c = load_config(str(path))
    with pytest.warns(UserWarning) as want:
        jax_load_config(str(path))
    assert [str(w.message) for w in got] == [str(w.message) for w in want]
    assert "['EVAL.bogus', 'batch_sise']" in str(got[0].message)
    assert c.batch_size == 8 and isinstance(c.EVAL, EvalConfig)


def test_log_dirs_match_jax():
    c = get_config("RefVSR_MFID", mode="m", log_offset="/logs")
    cj = jax_get_config("RefVSR_MFID", mode="m", log_offset="/logs")
    for prop in ("log_dir", "ckpt_dir", "state_dir", "result_dir"):
        assert getattr(c, prop) == getattr(cj, prop)


# ---------------------------------------------------------------- events


def test_crc32c_known_values():
    assert crc32c(b"") == 0
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(bytes(32)) == 0x8A9136AA
    assert crc32c(b"\xff" * 32) == 0x62A8AB43
    assert crc32c(bytes(range(32))) == 0x46DD794E
    # the TFRecord mask: rotate right by 15, add a constant
    c = crc32c(b"abc")
    assert masked_crc32c(b"abc") == (((c >> 15) | (c << 17))
                                     + 0xA282EAD8) & 0xFFFFFFFF


def test_events_read_back_by_tensorboard(tmp_path):
    from tensorboard.backend.event_processing.event_file_loader import \
        LegacyEventFileLoader
    scalars = [("train_itr/total", 0.125, 9), ("valid_epoch/PSNR", 31.5, 0),
               ("train_epoch/lr", 2e-4, 3), ("x", -7.25, 2 ** 40)]
    w = EventWriter(str(tmp_path / "scalar"))
    for tag, v, step in scalars:
        w.add_scalar(tag, v, step)
    w.close()
    events = list(LegacyEventFileLoader(w.path).Load())
    assert events[0].file_version == "brain.Event:2"
    got = [(e.summary.value[0].tag, e.summary.value[0].simple_value, e.step)
           for e in events[1:]]
    assert [(t, s) for t, _, s in got] == [(t, s) for t, _, s in scalars]
    assert np.allclose([v for _, v, _ in got],
                       np.float32([v for _, v, _ in scalars]), rtol=0)
    assert all(e.wall_time > 1e9 for e in events)


def test_event_record_framing(tmp_path):
    w = EventWriter(str(tmp_path))
    w.add_scalar("a", 1.0, 1)
    w.close()
    buf = open(w.path, "rb").read()
    pos = 0
    while pos < len(buf):
        head = buf[pos:pos + 8]
        (n,) = struct.unpack("<Q", head)
        assert struct.unpack("<I", buf[pos + 8:pos + 12])[0] == \
            masked_crc32c(head)
        data = buf[pos + 12:pos + 12 + n]
        assert struct.unpack("<I", buf[pos + 12 + n:pos + 16 + n])[0] == \
            masked_crc32c(data)
        pos += 16 + n
    assert pos == len(buf)


# ---------------------------------------------------------------- console


def test_train_line_matches_jax():
    errs = {"L1_lf": 0.0123456, "total": 0.5, "PSNR": 31.25}
    args = ("RefVSR_MFID_8K", 2, 18, 9, errs, 2e-4, 1.234)
    assert console.format_train_line(*args) == \
        jax_console.format_train_line(*args)


def test_cost_report_counts_parameters(tmp_path):
    net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Conv2d(4, 2, 3))
    assert param_count(net) == 3 * 4 + 4 + 4 * 2 * 9 + 2
    lines = write_cost_report(str(tmp_path / "cost.txt"), net)
    assert (tmp_path / "cost.txt").read_text() == lines[0] + "\n"
    assert lines[0].endswith("0.0001 M")


def test_handle_directory_wipes_the_log_tree(tmp_path):
    c = get_config("RefVSR_MFID", mode="m", log_offset=str(tmp_path))
    (tmp_path / "RefVSR_TPU" / "m").mkdir(parents=True)
    (tmp_path / "RefVSR_TPU" / "m" / "old.txt").write_text("x")
    console.handle_directory(c, True)
    assert list((tmp_path / "RefVSR_TPU" / "m").iterdir()) == []
