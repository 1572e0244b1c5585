"""Persistent multi-worker training loader; counterpart of
``refvsr_tpu/data/loader.py``.

A pool of ``spawn``-context processes (``fork`` after CUDA is initialised
is unsafe) that stays alive across epochs; each worker reads, crops and
collates whole batches with numpy only. Results are put back in order by
their sequence number, so the batches are the ``TrainLoader``'s, for any
worker count: each sample draws its augmentation from its own
``datasets.sample_rng(seed, epoch, index)``. Every ``__iter__`` takes a new
generation id, so the results an abandoned iteration left in flight (a
Runner stopping at ``total_itr``) are recognised and dropped. A worker that
dies makes the iteration raise."""

from __future__ import annotations

import multiprocessing as mp
import queue as queue_mod

from refvsr_tpu_torch.data.datasets import collate, epoch_order, sample_rng

# seconds between checks of the workers' health while waiting, and the
# wait after which live but silent workers count as stalled
_POLL_S = 5.0
_STALL_S = 300.0
# batches submitted ahead of the one being yielded
_PREFETCH = 4


def _worker_main(ds, seed, task_q, result_q):
    while True:
        task = task_q.get()
        if task is None:
            return
        gen, seq, epoch, idxs = task
        samples = [ds.__getitem__(int(i), rng=sample_rng(seed, epoch, int(i)))
                   for i in idxs]
        result_q.put((gen, seq, collate(samples)))


class MultiWorkerLoader:
    """Batched, epoch-seeded iterator over a TrainDataset, with
    the TrainLoader's order and batches; ``set_epoch()`` reshuffles. The
    workers start at ``start()`` or the first ``__iter__`` and persist
    until ``close()``."""

    def __init__(self, dataset, batch_size: int, seed: int = 1234,
                 num_workers: int = 4):
        self.ds = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.epoch = 0
        self._pool = None
        self._gen = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.ds) // self.batch_size

    def start(self):
        """Start the worker processes, unless they are running."""
        if self._pool is not None:
            return
        ctx = mp.get_context("spawn")
        self._task_q = ctx.Queue()
        self._result_q = ctx.Queue()
        self._pool = [
            ctx.Process(target=_worker_main,
                        args=(self.ds, self.seed, self._task_q,
                              self._result_q), daemon=True)
            for _ in range(self.num_workers)]
        for p in self._pool:
            p.start()

    def close(self):
        """Stop the workers (they restart at the next ``__iter__``)."""
        if self._pool is None:
            return
        for _ in self._pool:
            self._task_q.put(None)
        # drain what an abandoned iteration left, so no worker blocks on a
        # full pipe while it is joined
        while True:
            try:
                self._result_q.get(timeout=0.1)
            except queue_mod.Empty:
                break
        for p in self._pool:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        self._task_q.close()
        self._result_q.close()
        self._pool = None

    def __del__(self):
        if getattr(self, "_pool", None) is not None:
            self.close()

    def _batches(self):
        order = epoch_order(len(self.ds), self.seed, self.epoch)
        return [order[b * self.batch_size:(b + 1) * self.batch_size]
                for b in range(len(order) // self.batch_size)]

    def __iter__(self):
        self.start()
        self._gen += 1
        gen, epoch = self._gen, self.epoch
        batches = self._batches()
        pending = {}
        next_submit = next_yield = 0
        while next_yield < len(batches):
            while (next_submit < len(batches)
                   and next_submit - next_yield < _PREFETCH):
                self._task_q.put((gen, next_submit, epoch,
                                  batches[next_submit].tolist()))
                next_submit += 1
            waited = 0.0
            while next_yield not in pending:
                try:
                    r_gen, seq, batch = self._result_q.get(timeout=_POLL_S)
                except queue_mod.Empty:
                    waited += _POLL_S
                    dead = [p.exitcode for p in self._pool
                            if not p.is_alive()]
                    if dead:
                        self.close()
                        raise RuntimeError(
                            f"data worker(s) died (exit codes {dead}); "
                            "note: multiprocessing 'spawn' requires an "
                            "importable __main__ module")
                    if waited >= _STALL_S:
                        raise RuntimeError(
                            f"data workers stalled (>{_STALL_S:.0f} s)")
                    continue
                if r_gen == gen:        # else: from an abandoned iteration
                    pending[seq] = batch
                    waited = 0.0
            yield pending.pop(next_yield)
            next_yield += 1
