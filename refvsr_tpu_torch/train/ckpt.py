"""Checkpoint manager; counterpart of ``refvsr_tpu/train/ckpt.py``, with
its rules:

- two files per save, ``ckpt/<mode>_<epoch:05d>.ckpt`` (the network) and
  ``state/<mode>_<epoch:05d>.ckpt`` (the optimizer state, step and epoch);
- ``checkpoints.txt``: the entries sorted by score, best first, then a last
  line that repeats the most recent save; rotated to the ``max_files`` best;
- loading by score (the first line), by recency (the last line), by name,
  by absolute path or by epoch;
- a resume removes the entries newer than the epoch it resumes from.

The files are ``torch.save`` archives where the JAX package writes flax
msgpack: ``ckpt/`` holds the net's state dict under the reference torch key
names (what ``utils/convert.load_reference_state_dict`` and
``Predictor.load_checkpoint`` read), ``state/`` a dict of the Adam moments
``mu``/``nu`` (lists in the order of the trained parameters), ``step`` and
``epoch``. A ``.pytorch``/``.pth``/``.pt`` path loads through
``utils/convert.load_torch_checkpoint``, and keys that do not map warn."""

from __future__ import annotations

import os
import warnings

import torch

from refvsr_tpu_torch.utils.convert import (load_reference_state_dict,
                                            load_torch_checkpoint)


class CkptManager:
    def __init__(self, root_dir: str, model_name: str,
                 max_files_to_keep: int = 10):
        self.root_dir = root_dir
        self.dir_ckpt = os.path.join(root_dir, "ckpt")
        self.dir_state = os.path.join(root_dir, "state")
        self.model_name = model_name
        self.max_files = max_files_to_keep
        self.list_path = os.path.join(root_dir, "checkpoints.txt")
        os.makedirs(self.dir_ckpt, exist_ok=True)
        os.makedirs(self.dir_state, exist_ok=True)

    def _file_name(self, epoch):
        if isinstance(epoch, str):
            return f"{self.model_name}_{epoch}.ckpt"
        return f"{self.model_name}_{epoch:05d}.ckpt"

    # ---------- save ----------

    def save(self, state_dict, train_state, epoch, score: float):
        """Write the net's state dict and the train state of `epoch`, and
        enter it in checkpoints.txt with its score."""
        name = self._file_name(epoch)
        torch.save(state_dict, os.path.join(self.dir_ckpt, name))
        torch.save(train_state, os.path.join(self.dir_state, name))

        lines = self._read_lines()
        if lines:
            # drop the repeated most-recent line; if it is not also a scored
            # entry of the body, its files were rotated out
            recent = lines[-1]
            if recent not in lines[:-1]:
                self._remove(recent.split(" ")[0])
            lines = lines[:-1]
        entry = f"{name} {score}"
        self._write_lines(lines + [entry, entry])
        self._rotate()

    def _rotate(self):
        lines = self._read_lines()
        recent = lines[-1]
        body = self._sorted(lines[:-1])
        while len(body) > self.max_files:
            victim = body.pop()
            if victim != recent:
                self._remove(victim.split(" ")[0])
        self._write_lines(body + [recent])

    def _sorted(self, lines):
        return sorted(lines, key=lambda l: float(l.split(" ")[1]),
                      reverse=True)

    def _remove(self, name):
        for d in (self.dir_ckpt, self.dir_state):
            p = os.path.join(d, name)
            if os.path.exists(p):
                os.remove(p)

    def _read_lines(self):
        if not os.path.exists(self.list_path):
            return []
        with open(self.list_path) as f:
            return [l for l in f.read().splitlines() if l.strip()]

    def _write_lines(self, lines):
        with open(self.list_path, "w") as f:
            for l in lines:
                f.write(l + os.linesep)

    # ---------- load ----------

    def _path_of(self, by_score=True, name=None, abs_path=None, epoch=None):
        """(path, file name) of the network checkpoint asked for."""
        if name is None and abs_path is None and epoch is None:
            lines = self._read_lines()
            if not lines:
                raise FileNotFoundError(
                    f"no checkpoints.txt in {self.root_dir}")
            file_name = (lines[0] if by_score else lines[-1]).split(" ")[0]
            return os.path.join(self.dir_ckpt, file_name), file_name
        if abs_path is not None:
            return abs_path, os.path.basename(abs_path)
        if name is None:
            name = self._file_name(int(epoch))
        return os.path.join(self.dir_ckpt, name), name

    def load_params(self, net, by_score=True, name=None, abs_path=None,
                    epoch=None):
        """Load the checkpoint asked for into `net` in place. Returns its
        file name."""
        path, file_name = self._path_of(by_score, name, abs_path, epoch)
        if path.endswith((".pytorch", ".pth", ".pt")):
            res = load_reference_state_dict(
                net, load_torch_checkpoint(path), strict=False)
            missing, unused = res.missing_keys, res.unexpected_keys
            if missing or unused:
                warnings.warn(
                    f"torch checkpoint '{file_name}' did not fully map: "
                    f"{len(missing)} target leaves keep their current "
                    f"values (e.g. {sorted(missing)[:3]}), "
                    f"{len(unused)} source keys unused "
                    f"(e.g. {sorted(unused)[:3]}). Wrong --config variant "
                    "for this checkpoint?")
        else:
            net.load_state_dict(torch.load(path, map_location="cpu",
                                           weights_only=True))
        return file_name

    def load_train_state(self, epoch):
        """The train state dict saved with `epoch`, on the CPU."""
        path = os.path.join(self.dir_state, self._file_name(int(epoch)))
        return torch.load(path, map_location="cpu", weights_only=True)

    def resume_prune(self, resume_epoch: int):
        """Remove the entries newer than resume_epoch."""
        lines = self._read_lines()
        if not lines:
            return
        recent = None
        kept = []
        for line in lines[:-1]:
            fname = line.split(" ")[0]
            ep = int(fname.rsplit(".", 1)[0].rsplit("_", 1)[-1])
            if ep > resume_epoch:
                self._remove(fname)
            else:
                kept.append(line)
                if ep == resume_epoch:
                    recent = line
        if recent is None and kept:
            recent = kept[-1]
        if recent is not None:
            self._write_lines(kept + [recent])
            self._rotate()
