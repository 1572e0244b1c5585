"""The port's data pipeline against the JAX package's, on the CPU.

Both sides are the same numpy arithmetic on the same bytes (the JAX
package decodes through PIL, the port through ``data/png.py``), so every
comparison is bit for bit (``np.array_equal``): the resize tables, the
crops on coordinate images, the dataset items of a PIL-written tree, the
loaders' batches over two epochs. The port's multi-worker loader is held to
its single-thread loader as ``tests/test_loader.py`` holds the JAX one,
including an abandoned iteration; a dying worker raises, and ``prefetch``
re-raises its thread's error."""

import os
import random
import time

import numpy as np
import pytest
from PIL import Image

from refvsr_tpu.configs import get_config as jax_get_config
from refvsr_tpu.configs import set_data_path as jax_set_data_path
from refvsr_tpu.data import datasets as jd
from refvsr_tpu.data.loader import _sample_rng as jax_sample_rng
from refvsr_tpu.data.np_ops import np_resize as jax_np_resize
from refvsr_tpu_torch.configs import get_config, set_data_path
from refvsr_tpu_torch.data import datasets as td
from refvsr_tpu_torch.data.loader import MultiWorkerLoader
from refvsr_tpu_torch.data.np_ops import np_resize
from refvsr_tpu_torch.data.prefetch import prefetch

# LR 48 / W 96 / HR 192 pixels; HD-in variants read every stream from HR
SIZES = {"HR": 192, "LRx2": 96, "LRx4": 48}
CLIPS = {"train": ("0000", "0001"), "valid": ("0002",)}
FRAMES = {"train": 6, "valid": 3}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A RealMCVSR tree written by PIL: random 8-bit frames."""
    root = tmp_path_factory.mktemp("mcvsr")
    rng = np.random.default_rng(5)
    for split, clips in CLIPS.items():
        for clip in clips:
            for sub, size in SIZES.items():
                for cam in ("UW", "W", "T"):
                    d = root / "RealMCVSR" / split / sub / cam / clip
                    os.makedirs(d)
                    for i in range(FRAMES[split]):
                        Image.fromarray(rng.integers(
                            0, 256, (size, size, 3), dtype=np.uint8)).save(
                                d / f"{i:04d}.png")
    return str(root)


# the two crop geometries: get_patch (default wiring) and get_patch_T
# (HD input, T refs)
VARIANTS = {"RefVSR_MFID": dict(patch_size=4),
            "RefVSR_MFID_8K": dict(patch_size=16)}


def _configs(name, tree, **kw):
    kw = dict(VARIANTS[name], data_offset=tree, is_train=True, frame_num=3,
              frame_itr_num=2, batch_size=2, **kw)
    cj = jax_set_data_path(jax_get_config(name, **kw), True)
    ct = set_data_path(get_config(name, **kw), True)
    return cj, ct


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            assert np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("mode,align", [("bicubic", False), ("bilinear",
                                                             False),
                                        ("bilinear", True), ("nearest",
                                                             False)])
@pytest.mark.parametrize("kw", [dict(scale_factor=0.25),
                                dict(scale_factor=2), dict(scale_factor=0.8),
                                dict(size=(13, 29))])
def test_np_resize_matches_jax(rng, mode, align, kw):
    x = rng.random((2, 3, 40, 35, 3)).astype(np.float32)
    want = jax_np_resize(x, mode=mode, align_corners=align, **kw)
    got = np_resize(x, mode=mode, align_corners=align, **kw)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _coords(h, w, t):
    """(h, w, t*3) image whose values name their own row, column and
    channel, so a crop's offsets show in its values."""
    yy, xx, cc = np.meshgrid(np.arange(h), np.arange(w), np.arange(3 * t),
                             indexing="ij")
    return ((yy * 4096 + xx) * 64 + cc).astype(np.float32) / 2 ** 26


@pytest.mark.parametrize("hd,is_train", [(False, True), (True, True),
                                         (False, False)])
def test_get_patch_matches_jax(hd, is_train):
    p, t = 8, 3
    lr_uw, lr_w = _coords(64, 72, t), _coords(128, 144, t)
    hr_uw, hr_w = _coords(256, 288, t), _coords(256, 288, t)
    for seed in range(5):
        want = jd.get_patch(lr_uw, lr_w, hr_uw, hr_w, p, 4, hd,
                            random.Random(seed), is_train=is_train)
        got = td.get_patch(lr_uw, lr_w, hr_uw, hr_w, p, 4, hd,
                           random.Random(seed), is_train=is_train)
        for a, b in zip(want, got):
            assert (a is None) == (b is None)
            assert a is None or np.array_equal(a, b)


@pytest.mark.parametrize("hd,is_train", [(False, True), (True, True),
                                         (True, False)])
def test_get_patch_T_matches_jax(hd, is_train):
    p, t = 8, 2
    lr_uw, lr_w, lr_t = (_coords(140, 150, t), _coords(280, 300, t),
                         _coords(300, 320, t))
    hr_uw, hr_w, hr_t = (_coords(560, 600, t), _coords(560, 600, t),
                         _coords(300, 320, t))
    for seed in range(5):
        args = (lr_uw, lr_w, lr_t, hr_uw, hr_w, hr_t, p, 4, hd)
        want = jd.get_patch_T(*args, random.Random(seed), is_train=is_train)
        got = td.get_patch_T(*args, random.Random(seed), is_train=is_train)
        for a, b in zip(want, got):
            assert (a is None) == (b is None)
            assert a is None or np.array_equal(a, b)


@pytest.mark.parametrize("rotate_k,flip_val", [(None, None), (1, None),
                                               (3, 0), (2, 1), (None, -1)])
def test_read_frame_matches_jax(tree, rotate_k, flip_val):
    path = os.path.join(tree, "RealMCVSR/train/LRx4/UW/0000/0001.png")
    want = jd.read_frame(path, rotate_k, flip_val)
    got = td.read_frame(path, rotate_k, flip_val)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


def test_load_file_list_matches_jax(tree):
    want = jd.load_file_list(os.path.join(tree, "RealMCVSR/train/HR/W"))
    got = td.load_file_list(os.path.join(tree, "RealMCVSR/train/HR/W"))
    assert got[0] == want[0]
    assert all(np.array_equal(a, b) for a, b in zip(got[1], want[1]))


def test_sample_rng_matches_jax():
    for args in ((1234, 0, 0), (7, 3, 11), (0, 99, 12345)):
        a, b = jax_sample_rng(*args), td.sample_rng(*args)
        assert [a.random() for _ in range(4)] == [b.random()
                                                   for _ in range(4)]


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_train_dataset_items_match_jax(tree, name):
    cj, ct = _configs(name, tree)
    dj, dt = jd.TrainDataset(cj), td.TrainDataset(ct)
    assert (dj.idx_video, dj.idx_frame) == (dt.idx_video, dt.idx_frame)
    assert len(dt) == 6
    for i in range(len(dt)):
        _equal(dj.__getitem__(i, rng=random.Random(i)),
               dt.__getitem__(i, rng=random.Random(i)))


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_test_dataset_items_match_jax(tree, name):
    cj, ct = _configs(name, tree)
    dj, dt = jd.TestDataset(cj, is_valid=True), td.TestDataset(ct,
                                                               is_valid=True)
    assert dt.video_ranges() == dj.video_ranges() == [(0, 0, 3)]
    for i in range(len(dt)):
        _equal(dj[i], dt[i])


def test_video_ranges_match_jax(tree):
    """Two videos of the train split read as test sets."""
    cj, ct = _configs("RefVSR_MFID", tree)
    cj = cj.replace(VAL_LR_data_path=cj.LR_data_path,
                    VAL_HR_data_path=cj.HR_data_path)
    ct = ct.replace(VAL_LR_data_path=ct.LR_data_path,
                    VAL_HR_data_path=ct.HR_data_path)
    want = jd.TestDataset(cj, is_valid=True).video_ranges()
    assert td.TestDataset(ct, is_valid=True).video_ranges() == want == [
        (0, 0, 6), (1, 6, 12)]


def test_test_dataset_skips_other_videos(tree):
    cj, ct = _configs("RefVSR_MFID", tree)
    from dataclasses import replace
    cj = cj.replace(EVAL=replace(cj.EVAL, vid_name=["none"]))
    ct = ct.replace(EVAL=replace(ct.EVAL, vid_name=["none"]))
    _equal(jd.TestDataset(cj, is_valid=True)[1],
           td.TestDataset(ct, is_valid=True)[1])


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_train_loader_batches_match_jax(tree, name):
    cj, ct = _configs(name, tree)
    lj = jd.TrainLoader(jd.TrainDataset(cj), 2, seed=7)
    lt = td.TrainLoader(td.TrainDataset(ct), 2, seed=7)
    assert len(lt) == len(lj) == 3
    for epoch in (0, 1):
        lj.set_epoch(epoch)
        lt.set_epoch(epoch)
        bj, bt = list(lj), list(lt)
        assert len(bj) == len(bt) == 3
        for a, b in zip(bj, bt):
            _equal(a, b)


def test_multiworker_matches_train_loader(tree):
    """Two workers, two epochs (the pool persists), then an iteration
    abandoned after one batch: the next epoch's batches are still the
    TrainLoader's, none left over from the abandoned one."""
    _, ct = _configs("RefVSR_MFID", tree)
    ds = td.TrainDataset(ct)
    ref = td.TrainLoader(ds, 1, seed=7)
    mw = MultiWorkerLoader(ds, 1, seed=7, num_workers=2)
    try:
        for epoch in (0, 1):
            ref.set_epoch(epoch)
            mw.set_epoch(epoch)
            bt, bm = list(ref), list(mw)
            assert len(bt) == len(bm) == 6
            for a, b in zip(bt, bm):
                _equal(a, b)
        mw.set_epoch(2)
        for _ in mw:
            break
        time.sleep(0.5)     # the workers finish the abandoned tasks
        ref.set_epoch(3)
        mw.set_epoch(3)
        for a, b in zip(list(ref), list(mw)):
            _equal(a, b)
    finally:
        mw.close()
    assert mw._pool is None


class _DyingDataset:
    """A dataset whose worker dies on its first sample."""

    def __len__(self):
        return 2

    def __getitem__(self, index, rng=None):
        os._exit(3)


def test_dead_worker_raises():
    mw = MultiWorkerLoader(_DyingDataset(), 1, num_workers=1)
    try:
        with pytest.raises(RuntimeError, match="died"):
            next(iter(mw))
    finally:
        mw.close()


def test_prefetch_reraises_worker_error():
    def items():
        yield 1
        yield 2
        raise ValueError("bad frame")

    got = []
    with pytest.raises(ValueError, match="bad frame"):
        for v in prefetch(items(), depth=1):
            got.append(v)
    assert got == [1, 2]


def test_png_reader_refuses_what_pil_reads(tmp_path):
    """A JPEG frame in the tree: PIL reads it, the port refuses it loudly."""
    path = tmp_path / "0000.png"
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(path, format="JPEG")
    assert jd.read_frame(str(path)).shape == (8, 8, 3)
    with pytest.raises(ValueError, match="not a PNG"):
        td.read_frame(str(path))
