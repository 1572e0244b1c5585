"""Evaluation: PSNR/SSIM with image dumps, FOV-masked metrics and
confidence-map dumps; counterpart of ``refvsr_tpu/eval/runner.py`` (the
reference's evaluation/{init, eval_qual_quan, eval_quan_FOV,
eval_quan_conf_map}.py).

Kept from the JAX package, character for character where it writes: the
score-file lines (per frame, the per-video MEAN line printed with the next
video's first item's fields and its frame count inflated by the frames
that ``--vid_name`` skips, the TOTAL line or block), the result tree
(``<result_dir>/<data>/<date>_<ckpt>/``, ``png|jpg/{input,output}/<video>/``
and ``conf/<video>/``), the checkpoint choice (by score, name, epoch or
absolute path; a named one that is missing is an error) and the evaluated
weights saved beside the results (here a ``torch.save`` state dict). For
HD-in metrics without dumps the SR frame is downscaled by 1/scale on the
device (bicubic) and only the small frame crosses to the host.

Images are written by the port's own encoders (``data/png.py``,
``data/jpeg.py``) on a small thread pool, and confidence maps are coloured
with ``utils/colormap.inferno``.

More than one rank (``parallel/mesh.py``), as the JAX package's processes:

- data-parallel (``torchrun`` ranks, ``spatial_devices`` 1): the
  quan_qual eval gives rank r the videos whose index is r modulo the rank
  count, writes ``score_<data>_<mode>_p<r>.txt`` with that shard's lines
  and its ``(shard p<r>, partial)`` TOTAL, sums the frame-weighted totals
  over the ranks in float32, and rank 0 writes the global TOTAL to the
  unsharded file; FOV and conf are not sharded, and rank 0 writes them;
- spatial (``spatial_devices`` N > 1): every rank streams every video,
  each on its rows of the frame (``parallel/serve.py``), and rank 0 alone
  scores the gathered frames and writes files.

The evaluated weights are re-saved by rank 0 alone."""

from __future__ import annotations

import concurrent.futures
import datetime
import os
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from refvsr_tpu_torch import resolve_device
from refvsr_tpu_torch.configs import Config
from refvsr_tpu_torch.data.datasets import TestDataset
from refvsr_tpu_torch.data.jpeg import write_jpeg
from refvsr_tpu_torch.data.np_ops import np_resize
from refvsr_tpu_torch.data.png import write_image
from refvsr_tpu_torch.eval.metrics import psnr, psnr_masked, ssim, ssim_masked
from refvsr_tpu_torch.eval.stream import StreamRunner
from refvsr_tpu_torch.models.refvsr import build_refvsr
from refvsr_tpu_torch.ops.resize import resize
from refvsr_tpu_torch.parallel import mesh
from refvsr_tpu_torch.train.ckpt import CkptManager
from refvsr_tpu_torch.utils.colormap import inferno
from refvsr_tpu_torch.utils.convert import load_pretrained_assets


def device_downscale(sr: torch.Tensor, scale: int) -> torch.Tensor:
    """The SR frame (N, H, W, 3) downscaled by 1/scale (bicubic, clipped to
    [0, 1]) in f32 where it lies: the HD-in metric protocol
    (eval_qual_quan.py:84-92) without the full frame's transfer."""
    return resize(sr.float(), scale_factor=1.0 / scale, mode="bicubic",
                  align_corners=False).clamp(0.0, 1.0)


def _save_img(path, arr01):
    """A [0, 1] image as PNG or JPEG, by the path's extension."""
    if str(path).endswith(".jpg"):
        write_jpeg(path, arr01)
    else:
        write_image(path, arr01)


class ImageWriter:
    """Encodes and writes images on a small thread pool, so that the
    device's next frame overlaps the host's encode; at most `max_pending`
    images wait. ``flush`` re-raises the first error of a write."""

    def __init__(self, workers: int = 4, max_pending: int = 12):
        self._ex = concurrent.futures.ThreadPoolExecutor(workers)
        self._pending = []
        self._max = max_pending

    def save(self, path, arr01):
        while len(self._pending) >= self._max:
            self._pending.pop(0).result()
        self._pending.append(self._ex.submit(_save_img, path, arr01))

    def flush(self):
        err = None
        while self._pending:
            try:
                self._pending.pop(0).result()
            except Exception as e:      # drain everything, then raise
                err = err or e
        if err is not None:
            raise err

    def close(self):
        try:
            self.flush()
        finally:
            self._ex.shutdown()


def _check_samples(ds: TestDataset):
    """The JAX init's 'empty eval dataset' check, from the file lists."""
    names = {Path(files[0]).parent.name for files in ds.lr_uw if len(files)}
    if not len(ds) or (ds.vid_name is not None
                       and not names & set(ds.vid_name)):
        raise AssertionError("empty eval dataset")


def init_eval(config: Config, device="cuda"):
    """The network (seeded, pretrained assets where present, then the
    checkpoint asked for), the test split, a StreamRunner and the result
    directory (evaluation/init.py:9-34). Returns (dataset, runner,
    save_root, ckpt_name); the score files go in save_root too."""
    dev = resolve_device(device)
    ds = TestDataset(config, is_valid=False)
    _check_samples(ds)
    net = build_refvsr(config, device=dev, seed=config.manual_seed)
    load_pretrained_assets(config, net)

    ckpt_name = "random_init"
    ev = config.EVAL
    explicit = bool(ev.ckpt_abs_name or ev.ckpt_name
                    or ev.ckpt_epoch is not None)
    if explicit or os.path.exists(os.path.join(config.ckpt_dir, "..",
                                               "checkpoints.txt")):
        cm = CkptManager(os.path.join(config.log_dir, "checkpoint", "train",
                                      "epoch"), config.mode,
                         max_files_to_keep=config.max_ckpt_num)
        try:
            ckpt_name = cm.load_params(
                net, by_score=ev.load_ckpt_by_score, name=ev.ckpt_name,
                abs_path=ev.ckpt_abs_name, epoch=ev.ckpt_epoch)
        except FileNotFoundError:
            if explicit:        # a named checkpoint that is missing
                raise

    date = _shared_date(dev)
    save_root = os.path.join(config.result_dir, config.EVAL.data,
                             f"{date}_{ckpt_name}")
    Path(save_root).mkdir(parents=True, exist_ok=True)
    if ckpt_name != "random_init" and mesh.is_main():
        # the evaluated weights beside the results (evaluation/init.py:26)
        stem = ckpt_name.rsplit(".", 1)[0]
        torch.save({k: v.detach().cpu() for k, v in net.state_dict().items()},
                   os.path.join(save_root, f"{stem}.ckpt"))

    kf_stride = (config.keyframe_stride if config.network == "RefVSR_IR"
                 else None)
    cdt = torch.bfloat16 if config.is_amp else torch.float32
    spatial = None
    if _spatial(config):
        from refvsr_tpu_torch.parallel.serve import spatial_eval_fns
        t = config.frame_num
        first = ds[0]
        spatial = spatial_eval_fns(
            net, config.spatial_halo, (1, t) + first["LR_UW"].shape[1:],
            (1, t) + first["LR_REF_W"].shape[1:], compute_dtype=cdt,
            device=dev)
    runner = StreamRunner(
        net, config.reset_branch, device=dev, compute_dtype=cdt,
        pipeline_lanes=net.pipeline_lanes, keyframe_stride=kf_stride,
        spatial=spatial)
    return ds, runner, save_root, ckpt_name


def _spatial(config) -> bool:
    return config.spatial_devices > 1


def _data_parallel(config) -> bool:
    return mesh.world_size() > 1 and not _spatial(config)


def _writes(config) -> bool:
    """Whether this rank writes score lines and images: every rank of a
    data-parallel quan_qual eval (its own shard's), else rank 0."""
    return mesh.is_main() or (_data_parallel(config)
                              and config.EVAL.eval_mode in ("quan_qual",
                                                            "qual_quan"))


def _shared_date(device):
    """The result directory's date, rank 0's on every rank."""
    now = datetime.datetime.now()
    if mesh.world_size() == 1:
        return now.strftime("%Y_%m_%d_%H%M")
    t = torch.tensor([now.year, now.month, now.day, now.hour, now.minute],
                     dtype=torch.int64, device=device)
    mesh.broadcast_([t])
    y, mo, d, h, mi = (int(v) for v in t.tolist())
    return f"{y:04d}_{mo:02d}_{d:02d}_{h:02d}{mi:02d}"


def _score_path(save_root, config, shard: bool = True):
    """The score file; a data-parallel quan_qual eval's ranks each write
    their own (``_p<rank>``), and the global TOTAL goes to the unsharded
    name (``shard=False``)."""
    tag = (f"_p{mesh.rank()}" if shard and _data_parallel(config)
           and config.EVAL.eval_mode in ("quan_qual", "qual_quan") else "")
    return os.path.join(
        save_root,
        f"score_{config.EVAL.data}_{config.EVAL.eval_mode}{tag}.txt")


def _host(sr):
    return sr[0].float().cpu().numpy()


def eval_qual_quan(config: Config, device="cuda"):
    """PSNR/SSIM streaming eval and image dumps (eval_qual_quan.py:17-144).
    Returns {PSNR, SSIM, sec_per_frame, frames} (empty without frames)."""
    ds, runner, save_root, ckpt_name = init_eval(config, device)
    t = config.frame_num
    writes = _writes(config)
    world, rank = mesh.world_size(), mesh.rank()
    shard_videos = _data_parallel(config)

    writer = ImageWriter()
    try:
        agg = dict(total_norm=0, psnr_total=0.0, ssim_total=0.0,
                   time_total=0.0, psnr_v=0.0, ssim_v=0.0, time_v=0.0,
                   frame_len_prev=0, first_write=True, cur_video=None,
                   n_sub=0, n_emit=0)
        # frames skipped by --vid_name count towards frame_len_prev in
        # stream order (the reference's quirk: the skipped video inflates
        # the preceding video's MEAN denominator); with pipelined outputs
        # L-1 windows late, each skip is applied when emission reaches the
        # submit it came at
        continue_events = []
        results_summary = {}
        need_full = not config.EVAL.quantitative_only

        def emit(oitem, sr_dev, itr_time):
            """Metrics, score lines, dumps and per-video sums of one
            output; the MEAN line of a finished video prints with the next
            video's first item's fields (eval_qual_quan.py:47). A rank
            that does not write skips it all."""
            if not writes:
                return
            while continue_events and continue_events[0] <= agg["n_emit"]:
                continue_events.pop(0)
                agg["frame_len_prev"] += 1
            agg["n_emit"] += 1
            if (agg["cur_video"] is not None
                    and oitem["video_name"] != agg["cur_video"]
                    and agg["frame_len_prev"]):
                agg["psnr_total"] += agg["psnr_v"]
                agg["ssim_total"] += agg["ssim_v"]
                agg["time_total"] += agg["time_v"]
                line = (f"[MEAN EVAL {config.mode}|{config.EVAL.data}|"
                        f"{oitem['video_name']}]"
                        f"[{oitem['video_idx']}/{oitem['video_len']}]"
                        f" PSNR: {agg['psnr_v'] / agg['frame_len_prev']:.5f}"
                        f" SSIM: {agg['ssim_v'] / agg['frame_len_prev']:.5f}"
                        f" ({agg['time_v'] / agg['frame_len_prev']:.5f}sec)"
                        "\n\n")
                print(line, end="")
                if not config.EVAL.qualitative_only:
                    with open(_score_path(save_root, config), "a") as f:
                        f.write(line)
                agg["psnr_v"] = agg["ssim_v"] = agg["time_v"] = 0.0
            agg["cur_video"] = oitem["video_name"]

            out = out_cmp = None
            if need_full or not config.flag_HD_in:
                out = _host(sr_dev)
            else:
                out_cmp = _host(device_downscale(sr_dev, config.scale))

            gt = oitem["HR_UW"][t // 2]
            frame_psnr = frame_ssim = 0.0
            if not config.EVAL.qualitative_only:
                if out_cmp is None:
                    if config.flag_HD_in:
                        out_cmp = np.clip(
                            np_resize(out, scale_factor=1 / config.scale,
                                      mode="bicubic"), 0, 1)
                    else:
                        out_cmp = out
                frame_psnr = psnr(out_cmp, gt)
                frame_ssim = ssim(out_cmp, gt)

            agg["psnr_v"] += frame_psnr
            agg["ssim_v"] += frame_ssim
            agg["time_v"] += itr_time
            agg["total_norm"] += 1
            agg["frame_len_prev"] = oitem["frame_len"]

            line = (f"[EVAL {config.mode}|{config.EVAL.data}|"
                    f"{oitem['video_name']}]"
                    f"[{oitem['video_idx'] + 1}/{oitem['video_len']}]"
                    f"[{oitem['frame_idx'] + 1}/{oitem['frame_len']}] "
                    f"{oitem['frame_name']} PSNR: {frame_psnr:.5f} "
                    f"SSIM: {frame_ssim:.5f} ({itr_time:.5f}sec)")
            print(line)
            with open(_score_path(save_root, config),
                      "w" if agg["first_write"] else "a") as f:
                f.write(line + "\n")
            agg["first_write"] = False

            if not config.EVAL.quantitative_only:
                stem = oitem["frame_name"].split(".")[0]
                for fmt in ("png", "jpg"):
                    writer.save(os.path.join(save_root, fmt, "input",
                                             oitem["video_name"],
                                             f"{stem}.{fmt}"),
                                oitem["LR_UW"][t // 2])
                    writer.save(os.path.join(save_root, fmt, "output",
                                             oitem["video_name"],
                                             f"{stem}.{fmt}"),
                                out)

        # a dispatch's time is shared by the outputs it completes; priming
        # dispatches bank theirs for the outputs that follow
        t_unattr = 0.0
        for i in range(len(ds)):
            # data-parallel: whole videos by rank, so that the recurrent
            # state stays on one rank (data_sampler.py:31-43,64-72)
            if shard_videos and ds.idx_video[i] % world != rank:
                continue
            item = ds[i]
            if item.get("is_continue"):
                continue_events.append(agg["n_sub"])
                continue
            t0 = time.time()
            agg["n_sub"] += 1
            emitted = runner.submit(item["LR_UW"][None, :t],
                                    item["LR_REF_W"][None, :t],
                                    item["is_first"], meta=item)
            t_unattr += time.time() - t0
            for oitem, sr_dev, _ in emitted:
                emit(oitem, sr_dev, t_unattr / len(emitted))
            if emitted:
                t_unattr = 0.0
        t0 = time.time()
        emitted = runner.flush()
        t_unattr += time.time() - t0
        for oitem, sr_dev, _ in emitted:
            emit(oitem, sr_dev, t_unattr / len(emitted))
    finally:
        writer.close()
    total_norm = agg["total_norm"]
    if total_norm:
        psnr_mean = (agg["psnr_total"] + agg["psnr_v"]) / total_norm
        ssim_mean = (agg["ssim_total"] + agg["ssim_v"]) / total_norm
        time_mean = (agg["time_total"] + agg["time_v"]) / total_norm
        shard = f" (shard p{rank}, partial)" if shard_videos else ""
        line = (f"\n[TOTAL {ckpt_name}|{config.EVAL.data}]{shard} "
                f"PSNR: {psnr_mean:.5f} SSIM: {ssim_mean:.5f} "
                f"({time_mean:.5f}sec)\n")
        print(line, end="")
        if not config.EVAL.qualitative_only:
            with open(_score_path(save_root, config), "a") as f:
                f.write(line)
        results_summary = {"PSNR": psnr_mean, "SSIM": ssim_mean,
                           "sec_per_frame": time_mean, "frames": total_norm}
    if shard_videos:
        # the shards hold different frame counts: the headline sums the
        # frame-weighted totals over the ranks (float32, as JAX does)
        sums = torch.tensor([agg["psnr_total"] + agg["psnr_v"],
                             agg["ssim_total"] + agg["ssim_v"],
                             agg["time_total"] + agg["time_v"],
                             float(total_norm)], dtype=torch.float32,
                            device=runner.device)
        torch.distributed.all_reduce(sums)
        g = sums.cpu().numpy()
        if g[3] > 0:
            psnr_mean, ssim_mean, time_mean = (
                float(g[0] / g[3]), float(g[1] / g[3]), float(g[2] / g[3]))
            line = (f"\n[TOTAL {ckpt_name}|{config.EVAL.data}] "
                    f"PSNR: {psnr_mean:.5f} SSIM: {ssim_mean:.5f} "
                    f"({time_mean:.5f}sec)\n")
            if rank == 0:
                print(line, end="")
                if not config.EVAL.qualitative_only:
                    with open(_score_path(save_root, config, shard=False),
                              "a") as f:
                        f.write(line)
            results_summary = {"PSNR": psnr_mean, "SSIM": ssim_mean,
                               "sec_per_frame": time_mean,
                               "frames": int(g[3])}
    return results_summary


_FOV_KEYS = (1.0, 0.9, 0.8, 0.7, 0.6, 0.5)


def eval_quan_FOV(config: Config, device="cuda"):
    """Masked PSNR/SSIM over centre-FOV fractions (eval_quan_FOV.py:17-269):
    inside (the centre crop), outside (its complement) and the ring (inside
    less the 50% centre). Per-frame lines (key 1.0) and the TOTAL block in
    the reference's format; ``is_debug`` stops after 3 frames and writes no
    file. Returns the mean of each metric by key."""
    ds, runner, save_root, ckpt_name = init_eval(config, device)
    t = config.frame_num
    # a rank that does not write runs as the debug mode does: no file
    is_debug = config.EVAL.is_debug
    quiet = not _writes(config)

    acc = {m: {k: 0.0 for k in _FOV_KEYS}
           for m in ("pfi", "pfo", "pfr", "sfi", "sfo", "sfr")}
    total_norm = 0
    time_total = 0.0
    first_write = True
    for i in range(len(ds)):
        if is_debug and total_norm >= 3:
            break
        item = ds[i]
        if item.get("is_continue"):
            continue
        t0 = time.time()
        sr_dev, _ = runner.process_device(item["LR_UW"][None, :t],
                                          item["LR_REF_W"][None, :t],
                                          item["is_first"])
        if quiet:
            total_norm += 1
            continue
        if config.flag_HD_in:
            # FOV metrics run on the 1/scale frame, downscaled where it is
            sr_dev = device_downscale(sr_dev, config.scale)
        out = _host(sr_dev)
        itr_time = time.time() - t0
        gt = item["HR_UW"][t // 2]
        h, w, _ = out.shape
        for key in _FOV_KEYS:
            if key == 1.0:
                pfi, sfi = psnr(out, gt), ssim(out, gt)
                pfo = sfo = 0.0
                mask_fi = np.ones((h, w, 3))
            else:
                cr = int(1 / ((1 - key) / 2))
                mask_fi = np.zeros((h, w, 3))
                mask_fi[h // cr:h - h // cr, w // cr:w - w // cr] = 1.0
                pfi = psnr_masked(out, gt, mask_fi)
                sfi = ssim_masked(out, gt, mask_fi)
                mask_fo = 1.0 - mask_fi
                pfo = psnr_masked(out, gt, mask_fo)
                sfo = ssim_masked(out, gt, mask_fo)
            if key > 0.5:
                mask_fr = mask_fi.copy()
                mask_fr[h // 4:h - h // 4, w // 4:w - w // 4] = 0.0
                pfr = psnr_masked(out, gt, mask_fr)
                sfr = ssim_masked(out, gt, mask_fr)
            else:
                pfr = sfr = 0.0
            if key == 1.0:
                line = (f"[EVAL {config.mode}|{config.EVAL.data}|"
                        f"{item['video_name']}]"
                        f"[{item['video_idx'] + 1}/{item['video_len']}]"
                        f"[{item['frame_idx'] + 1}/{item['frame_len']}] "
                        f"{item['frame_name']} PSNR: {pfi:.5f} "
                        f"SSIM: {sfi:.5f} ({itr_time:.5f}sec)")
                print(line)
                if not is_debug:
                    with open(_score_path(save_root, config),
                              "w" if first_write else "a") as f:
                        f.write(line + "\n")
                    first_write = False
            for name, val in (("pfi", pfi), ("pfo", pfo), ("pfr", pfr),
                              ("sfi", sfi), ("sfo", sfo), ("sfr", sfr)):
                acc[name][key] += val
        time_total += itr_time
        total_norm += 1

    if total_norm == 0 or quiet:
        return {}
    means = {m: {k: v / total_norm for k, v in d.items()}
             for m, d in acc.items()}
    time_mean = time_total / total_norm
    # the TOTAL block, eval_quan_FOV.py:245-265
    lo = f"{_FOV_KEYS[-1] * 100:3.1f}"
    out_str = f"\n[TOTAL {ckpt_name}|{config.EVAL.data}] \n[PSNR-FOV_in  ] ("
    for k, v in means["pfi"].items():
        out_str += f"0-{k * 100:3.1f}%: {v:.5f}, "
    out_str += ")\n[PSNR-FOV_out ] ("
    for k, v in means["pfo"].items():
        out_str += f"{k * 100:3.1f}-100%: {v:.5f}, "
    out_str += ")\n[PSNR-FOV_ring] ("
    for k, v in means["pfr"].items():
        out_str += f"{lo}-{k * 100:3.1f}%: {v:.5f}, "
    out_str += ")\n[SSIM-FOV_in  ] ("
    for k, v in means["sfi"].items():
        out_str += f"0-{k * 100:3.1f}%: {v:.5f}, "
    out_str += ")\n[SSIM-FOV_out ] ("
    for k, v in means["sfo"].items():
        out_str += f"{k * 100:3.1f}-100%: {v:.5f}, "
    out_str += ")\n[SSIM-FOV_ring] ("
    for k, v in means["sfr"].items():
        out_str += f"{lo}-{k * 100:3.1f}%: {v:.5f}, "
    out_str += f") ({time_mean:.5f}sec)\n\n"
    print(out_str, end="")
    if not is_debug:
        with open(_score_path(save_root, config), "a") as f:
            f.write(out_str)
    return means


def eval_quan_conf_map(config: Config, device="cuda"):
    """Inferno-coloured confidence maps (eval_quan_conf_map.py:18-182):
    the matching's, the propagated one (the larger of the branches') and
    each branch's. Returns {frames}."""
    ds, runner, save_root, ckpt_name = init_eval(config, device)
    t = config.frame_num
    writer = ImageWriter()
    try:
        count = 0
        for i in range(len(ds)):
            item = ds[i]
            if item.get("is_continue"):
                continue
            # the SR frame stays on the device; only the maps cross
            _, conf = runner.process_device(item["LR_UW"][None, :t],
                                            item["LR_REF_W"][None, :t],
                                            item["is_first"])
            count += 1
            if not _writes(config):
                continue
            conf_bw, conf_fw, conf_match = [c[0, ..., 0].float().cpu().numpy()
                                            for c in conf]
            conf_prop = np.maximum(conf_bw, conf_fw)
            stem = item["frame_name"].split(".")[0]
            for name, m in (("conf", conf_match), ("conf_prop", conf_prop),
                            ("conf_prop_bw", conf_bw),
                            ("conf_prop_fw", conf_fw)):
                writer.save(os.path.join(save_root, "conf",
                                         item["video_name"],
                                         f"{stem}_{name}.png"),
                            inferno(np.clip(m, 0, 1)))
    finally:
        writer.close()
    return {"frames": count}


def evaluate(config: Config, device="cuda"):
    """Run ``config.EVAL.eval_mode`` (eval.py:8-21) on `device` (the card
    unless the caller asks for the CPU). Pipelined streaming serves the
    one-rank RefVSR quan_qual path only; elsewhere (the spatial path
    included) it warns and streams plainly."""
    if config.spatial_devices > 1 and \
            config.spatial_devices != mesh.world_size():
        raise SystemExit(
            f"--spatial_devices {config.spatial_devices}: the process group "
            f"has {mesh.world_size()} ranks (launch with run.main or "
            "torchrun)")
    mode = config.EVAL.eval_mode
    if config.pipeline_lanes > 1 and (mode not in ("quan_qual", "qual_quan")
                                      or config.network == "RefVSR_IR"
                                      or config.spatial_devices > 1):
        warnings.warn("pipeline_lanes>1 supports the RefVSR quan_qual eval "
                      "path only — falling back to plain streaming")
        config = config.replace(pipeline_lanes=0)
    if mode in ("quan_qual", "qual_quan"):
        return eval_qual_quan(config, device)
    if mode == "FOV":
        return eval_quan_FOV(config, device)
    if mode == "conf":
        return eval_quan_conf_map(config, device)
    raise ValueError(f"unknown eval mode {mode!r}")
