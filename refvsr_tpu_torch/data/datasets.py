"""RealMCVSR triplet datasets (host-side numpy, NTHWC float32); counterpart
of ``refvsr_tpu/data/datasets.py``, with the same semantics:

- directory layout {split}/{HR,LRx2,LRx4}/{UW,W,T}/<clip>/<frame>.png;
- training windows of frame_num + frame_itr_num - 1 frames starting every
  frame_itr_num frames, indices clamped at the clip's edges;
- one rotation and flip shared by all six streams of a sample;
- the cross-camera patch geometry: ``get_patch`` (grid 4, W at 2x the
  coordinates plus a 0-30 px misalignment) and ``get_patch_T`` (grid 20, T
  at 5x plus a 4/5 focal rescale);
- a check that the six streams name the same folder and frame;
- test windows at stride 1, ``is_first`` where the clip changes, and per
  video metadata.

Frames are read by ``data/png.read_image``, which refuses what it cannot
decode (a JPEG, a 16-bit or interlaced PNG) with a ``ValueError``; the
JAX package reads them through PIL. Arrays are (T, H, W, 3) float32 in
[0, 1]."""

from __future__ import annotations

import os
import random
from pathlib import Path

import numpy as np

from refvsr_tpu_torch.data.np_ops import np_resize
from refvsr_tpu_torch.data.png import read_image


def load_file_list(root_path):
    """Sorted (folder_paths, files_per_folder) of the leaf folders."""
    folder_paths, files = [], []
    for root, dirnames, filenames in os.walk(root_path):
        dirnames.sort()
        if len(dirnames) != 0:
            continue
        keep = sorted(os.path.join(root, f) for f in filenames
                      if not f.startswith(".") and f != "Thumbs.db")
        if keep:
            folder_paths.append(root)
            files.append(np.array(keep, dtype=str))
    order = np.argsort(folder_paths)
    return ([folder_paths[i] for i in order], [files[i] for i in order])


def read_frame(path, rotate_k=None, flip_val=None):
    """A PNG frame as float32 in [0, 1], rotated and flipped.
    rotate_k: number of counter-clockwise 90-degree turns (1, 3 or 2).
    flip_val follows cv2.flip's codes: 0 vertical, 1 horizontal, -1 both."""
    frame = read_image(path)
    if rotate_k is not None:
        frame = np.rot90(frame, k=rotate_k)
    if flip_val is not None:
        if flip_val in (0, -1):
            frame = frame[::-1]
        if flip_val in (1, -1):
            frame = frame[:, ::-1]
    return np.clip(np.ascontiguousarray(frame), 0.0, 1.0)


def _to_nthwc(patch_hwc):
    """(H, W, T*3) stacked-channel image -> (T, H, W, 3) float32."""
    h, w = patch_hwc.shape[:2]
    return np.ascontiguousarray(
        patch_hwc.reshape(h, w, -1, 3).transpose(2, 0, 1, 3), dtype=np.float32)


def get_patch(lr_uw, lr_w, hr_uw, hr_w, patch_size, scale, flag_HD_in,
              rng: random.Random, is_crop=True, is_train=True):
    """Cross-camera random crop. Inputs (H, W, T*3)."""
    if is_crop:
        grid = 4
        h, w = lr_uw.shape[:2]
        p = patch_size
        x = rng.randrange(w // grid, (grid - 1) * w // grid - p + 1 - 15)
        y = rng.randrange(h // grid, (grid - 1) * h // grid - p + 1 - 15)
        p_lr_uw = lr_uw[y:y + p, x:x + p]

        scale_w = 2  # 59mm/30mm focal ratio
        delta = rng.randint(0, 30)
        wp = scale_w * p
        wx = (x - w // grid) * scale_w + delta
        wy = (y - h // grid) * scale_w + delta
        p_lr_w = lr_w[wy:wy + wp, wx:wx + wp]

        if not flag_HD_in:
            hp = scale * p
            p_hr_uw = hr_uw[scale * y:scale * y + hp, scale * x:scale * x + hp]
            if is_train:
                s2 = scale // 2
                hwp = s2 * wp
                p_hr_w = hr_w[s2 * wy:s2 * wy + hwp, s2 * wx:s2 * wx + hwp]
        else:
            p_hr_uw = p_lr_uw
            p_hr_w = p_lr_w
    else:
        p_lr_uw, p_lr_w, p_hr_uw, p_hr_w = lr_uw, lr_w, hr_uw, hr_w

    out_lr_uw = _to_nthwc(p_lr_uw)
    out_lr_w = _to_nthwc(p_lr_w)
    out_hr_uw = _to_nthwc(p_hr_uw)
    out_hr_w = None
    if is_train:
        out_hr_w = _to_nthwc(p_hr_w)
        if flag_HD_in:
            out_hr_w = np.clip(np_resize(out_lr_w, scale_factor=2,
                                         mode="bicubic"), 0, 1)
    return out_lr_uw, out_lr_w, out_hr_uw, out_hr_w


def get_patch_T(lr_uw, lr_w, lr_t, hr_uw, hr_w, hr_t, patch_size, scale,
                flag_HD_in, rng: random.Random, is_crop=True, is_train=True):
    """Telephoto-inclusive crop: grid 20 (UW) / 10 (W) / 4 (T); T rescaled
    by 4/5 (147 mm against 30 mm focal length)."""
    if is_crop:
        grid = 20
        pad_uw_t = 8
        h, w = lr_uw.shape[:2]
        p = patch_size
        x = rng.randrange(pad_uw_t * w // grid,
                          (grid - pad_uw_t) * w // grid - p + 1 - 15)
        y = rng.randrange(pad_uw_t * h // grid,
                          (grid - pad_uw_t) * h // grid - p + 1 - 15)
        p_lr_uw = lr_uw[y:y + p, x:x + p]

        scale_w = 2
        pad_uw_w = 5
        delta = rng.randint(0, 30)
        wp = int(scale_w * p)
        wx = int((x - pad_uw_w * w // grid) * scale_w + delta)
        wy = int((y - pad_uw_w * h // grid) * scale_w + delta)
        p_lr_w = lr_w[wy:wy + wp, wx:wx + wp]

        scale_t = 5
        delta = rng.randint(0, 60)
        tp = int(scale_t * p)
        tx = int((x - pad_uw_t * w // grid) * scale_t + delta)
        ty = int((y - pad_uw_t * h // grid) * scale_t + delta)
        p_lr_t = lr_t[ty:ty + tp, tx:tx + tp]

        if not flag_HD_in:
            hp = scale * p
            p_hr_uw = hr_uw[scale * y:scale * y + hp, scale * x:scale * x + hp]
            if is_train:
                hwp = 2 * wp
                p_hr_w = hr_w[2 * wy:2 * wy + hwp, 2 * wx:2 * wx + hwp]
        else:
            p_hr_uw = p_lr_uw
            p_hr_w = p_lr_w
        p_hr_t = p_lr_t
    else:
        p_lr_uw, p_lr_w, p_lr_t = lr_uw, lr_w, lr_t
        p_hr_uw, p_hr_w, p_hr_t = hr_uw, hr_w, hr_t

    out_lr_uw = _to_nthwc(p_lr_uw)
    out_lr_w = _to_nthwc(p_lr_w)
    out_lr_t = np.clip(np_resize(_to_nthwc(p_lr_t), scale_factor=4 / 5,
                                 mode="bicubic"), 0, 1)
    out_hr_uw = _to_nthwc(p_hr_uw)
    out_hr_w = out_hr_t = None
    if is_train:
        out_hr_w = _to_nthwc(p_hr_w)
        out_hr_t = np.clip(np_resize(_to_nthwc(p_hr_t), scale_factor=4 / 5,
                                     mode="bicubic"), 0, 1)
    return out_lr_uw, out_lr_w, out_lr_t, out_hr_uw, out_hr_w, out_hr_t


def _check_consistent(paths):
    folders = {Path(p).parent.name for p in paths}
    bases = {Path(p).name.split(".")[0] for p in paths}
    if len(folders) != 1 or len(bases) != 1:
        raise ValueError(f"inconsistent camera streams: {paths}")


class TrainDataset:
    def __init__(self, config):
        self.config = c = config
        self.frame_num = c.frame_num
        self.frame_half = c.frame_num // 2
        self.frame_itr_num = c.frame_itr_num
        self.patch_size = c.patch_size
        self.scale = c.scale
        self.flag_HD_in = c.flag_HD_in
        self.is_use_T = c.is_use_T

        _, self.lr_uw = load_file_list(os.path.join(c.LR_data_path, c.UW_path))
        _, self.lr_w = load_file_list(os.path.join(c.LR_data_path, c.W_path))
        _, self.lr_t = load_file_list(os.path.join(c.LR_data_path, c.T_path))
        _, self.hr_uw = load_file_list(os.path.join(c.HR_data_path, c.UW_path))
        _, self.hr_w = load_file_list(
            os.path.join(c.HR_ref_data_W_path, c.W_path))
        _, self.hr_t = load_file_list(
            os.path.join(c.HR_ref_data_T_path, c.T_path))

        self.idx_video, self.idx_frame = [], []
        for i, files in enumerate(self.lr_uw):
            for s in range(0, len(files) - self.frame_itr_num + 1,
                           self.frame_itr_num):
                self.idx_video.append(i)
                self.idx_frame.append(s)

    def __len__(self):
        return len(self.idx_frame)

    def __getitem__(self, index, rng: random.Random | None = None):
        rng = rng or random
        v = self.idx_video[index]
        start = self.idx_frame[index]
        offset = start - self.frame_half
        count = self.frame_num + self.frame_itr_num - 1
        idxs = np.clip(np.arange(offset, offset + count), start,
                       len(self.lr_uw[v]) - 1)

        rotate_k = None
        if rng.uniform(0, 1) <= 0.5:
            r = rng.uniform(0, 1)
            rotate_k = 1 if r <= 0.3 else (3 if r <= 0.6 else 2)
        flip_val = None
        if rng.uniform(0, 1) <= 0.5:
            r = rng.uniform(0, 1)
            flip_val = 0 if r <= 0.3 else (1 if r <= 0.6 else -1)

        def stack(files):
            return np.concatenate(
                [read_frame(files[j], rotate_k, flip_val) for j in idxs], axis=2)

        for j in idxs:
            _check_consistent([
                self.lr_uw[v][j], self.lr_w[v][j], self.lr_t[v][j],
                self.hr_uw[v][j], self.hr_w[v][j], self.hr_t[v][j]])

        lr_uw = stack(self.lr_uw[v])
        lr_w = stack(self.lr_w[v])
        hr_uw = stack(self.hr_uw[v])
        hr_w = stack(self.hr_w[v])

        if self.is_use_T:
            lr_t = stack(self.lr_t[v])
            hr_t = stack(self.hr_t[v])
            o_lr_uw, o_lr_w, o_lr_t, o_hr_uw, o_hr_w, o_hr_t = get_patch_T(
                lr_uw, lr_w, lr_t, hr_uw, hr_w, hr_t, self.patch_size,
                self.scale, self.flag_HD_in, rng)
        else:
            o_lr_uw, o_lr_w, o_hr_uw, o_hr_w = get_patch(
                lr_uw, lr_w, hr_uw, hr_w, self.patch_size, self.scale,
                self.flag_HD_in, rng)
            o_lr_t, o_hr_t = o_lr_w, o_hr_w

        return {"LR_UW": o_lr_uw, "LR_REF_W": o_lr_w, "LR_REF_T": o_lr_t,
                "HR_UW": o_hr_uw, "HR_REF_W": o_hr_w,
                "HR_REF_T": o_hr_t if self.is_use_T else o_hr_w}


class TestDataset:
    def __init__(self, config, is_valid=False):
        self.config = c = config
        self.frame_num = c.frame_num
        self.frame_half = c.frame_num // 2
        self.scale = c.scale
        self.flag_HD_in = c.flag_HD_in
        self.is_use_T = c.is_use_T
        self.is_valid = is_valid
        self.vid_name = c.EVAL.vid_name

        if is_valid:
            lr_p, hr_p = c.VAL_LR_data_path, c.VAL_HR_data_path
        else:
            lr_p, hr_p = c.EVAL.LR_data_path, c.EVAL.HR_data_path

        _, self.lr_uw = load_file_list(os.path.join(lr_p, c.UW_path))
        _, self.lr_w = load_file_list(os.path.join(lr_p, c.W_path))
        _, self.lr_t = load_file_list(os.path.join(lr_p, c.T_path))
        _, self.hr_uw = load_file_list(os.path.join(hr_p, c.UW_path))

        self.idx_video, self.idx_frame = [], []
        for i, files in enumerate(self.lr_uw):
            for s in range(len(files)):
                self.idx_video.append(i)
                self.idx_frame.append(s)

    def __len__(self):
        return len(self.idx_frame)

    def video_ranges(self):
        """[(video_idx, first_index, last_index_exclusive)] of each video."""
        ranges = []
        start = 0
        for i in range(1, len(self.idx_video) + 1):
            if i == len(self.idx_video) or self.idx_video[i] != \
                    self.idx_video[start]:
                ranges.append((self.idx_video[start], start, i))
                start = i
        return ranges

    def __getitem__(self, index):
        v = self.idx_video[index]
        center = self.idx_frame[index]
        files = self.lr_uw[v]
        video_name = Path(files[center]).parent.name
        if self.vid_name is not None and video_name not in self.vid_name:
            return {"is_continue": True, "is_first": True,
                    "video_name": video_name}

        offset = center - self.frame_half
        idxs = np.clip(np.arange(offset, offset + self.frame_num), 0,
                       len(files) - 1)

        crop = None
        if self.config.is_crop_valid and self.is_valid and not self.flag_HD_in:
            crop = self.config.crop_valid_offset

        def stack(flist, crop_mul=1):
            frames = []
            for j in idxs:
                f = read_frame(flist[j])
                if crop is not None:
                    cm = crop * crop_mul
                    f = f[cm:-cm, cm:-cm]
                frames.append(f)
            return np.concatenate(frames, axis=2)

        lr_uw = stack(files)
        lr_w = stack(self.lr_w[v])
        lr_t = stack(self.lr_t[v])
        hr_uw = stack(self.hr_uw[v], crop_mul=4)

        if self.is_use_T:
            o_lr_uw, o_lr_w, o_lr_t, o_hr_uw, _, _ = get_patch_T(
                lr_uw, lr_w, lr_t, hr_uw, None, None, None, self.scale,
                self.flag_HD_in, random, is_crop=False, is_train=False)
        else:
            o_lr_uw, o_lr_w, o_hr_uw, _ = get_patch(
                lr_uw, lr_w, hr_uw, None, None, self.scale, self.flag_HD_in,
                random, is_crop=False, is_train=False)
            o_lr_t = o_lr_w

        is_first = not (index > 0 and
                        self.idx_video[index] == self.idx_video[index - 1])
        return {"LR_UW": o_lr_uw, "LR_REF_W": o_lr_w, "LR_REF_T": o_lr_t,
                "HR_UW": o_hr_uw, "HR_REF_W": o_hr_uw, "HR_REF_T": o_hr_uw,
                "is_first": is_first,
                "video_len": len(self.lr_uw),
                "frame_len": len(files),
                "video_idx": v,
                "frame_idx": int(idxs[self.frame_half]),
                "video_name": video_name,
                "frame_name": os.path.basename(files[idxs[self.frame_half]])}


def sample_rng(seed: int, epoch: int, index: int) -> random.Random:
    """The augmentation rng of one sample in one epoch: the same draws
    whichever loader and however many workers read it."""
    return random.Random((seed * 1_000_003 + epoch) * 1_000_003 + index)


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    """The epoch-seeded permutation of n samples."""
    return np.random.default_rng(seed + epoch).permutation(n)


def rank_order(n: int, seed: int, epoch: int, world_size: int = 1,
               rank: int = 0) -> np.ndarray:
    """Rank `rank`'s samples of the epoch: every `world_size`-th entry of
    the epoch's permutation from `rank` on (DistIterSampler's sharding)."""
    return epoch_order(n, seed, epoch)[rank::world_size]


def rank_len(n: int, batch_size: int, world_size: int = 1) -> int:
    """The loaders' ``len``: ``ceil(n / world_size) // batch_size``, the
    batches of the largest shard (a later rank may yield one fewer)."""
    return -(-n // world_size) // batch_size


class TrainLoader:
    """Epoch-seeded shuffling batch iterator: a seeded permutation, each
    sample augmented by its own rng; rank `rank` of `world_size` reads its
    shard of it (``rank_order``)."""

    def __init__(self, dataset: TrainDataset, batch_size: int,
                 seed: int = 1234, world_size: int = 1, rank: int = 0):
        self.ds = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.world_size, self.rank = world_size, rank
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return rank_len(len(self.ds), self.batch_size, self.world_size)

    def __iter__(self):
        order = rank_order(len(self.ds), self.seed, self.epoch,
                           self.world_size, self.rank)
        batch = []
        for idx in order:
            batch.append(self.ds.__getitem__(
                int(idx), rng=sample_rng(self.seed, self.epoch, int(idx))))
            if len(batch) == self.batch_size:
                yield collate(batch)
                batch = []


def collate(samples):
    out = {}
    for k in samples[0]:
        v0 = samples[0][k]
        if isinstance(v0, np.ndarray):
            out[k] = np.stack([s[k] for s in samples], axis=0)
        else:
            out[k] = [s[k] for s in samples]
    return out
