"""The process group of the port's multi-device paths; counterpart of
``refvsr_tpu/parallel/mesh.py``.

The JAX package builds a ``(data, spatial)`` device mesh inside one
process and lets XLA insert the collectives. Here every device is a
process (a rank) of one ``torch.distributed`` group, and the collectives
are explicit:

- data parallelism (training, ``--devices N``): parameters replicated and
  broadcast from rank 0 once, the batch split over the ranks, the gradients
  averaged in one flattened bucket (``all_reduce_mean``);
- spatial sharding (the 8K stream, ``--spatial_devices N``): each frame's
  H axis split over the ranks (``parallel/spatial.py``).

The group comes from the environment ``torchrun`` sets (``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), or from
``spawn``, which starts the ranks of one host itself with that same
environment. Backend: ``nccl`` when every rank of the host has a card of
its own, ``gloo`` when ranks share a card or run on the CPU. A failure to
initialise raises; nothing switches to another backend or to the CPU.

Only ``all_reduce``, ``all_gather`` and ``broadcast`` are used, the
collectives both backends run on CUDA tensors (gloo through the host), so
the code two ranks run on one card under gloo is the code NCCL would run."""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import socket
import time

import torch
import torch.distributed as dist

# seconds a collective may wait before the group fails; a rank that hangs
# makes the others fail instead of hanging with it
COLLECTIVE_TIMEOUT_S = 900


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", rank()))


def is_main() -> bool:
    return rank() == 0


def device_for_rank(device="cuda") -> torch.device:
    """This rank's device: the CPU when `device` is, else
    ``cuda:(local_rank % device_count)``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no card is visible; "
                           "pass device='cpu' (-cpu) to run on the CPU")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def choose_backend(device, local_world: int) -> str:
    """``nccl`` when each of the host's `local_world` ranks has a card of
    its own, else ``gloo`` (ranks sharing a card, or the CPU)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def init_from_env(device="cuda") -> str:
    """Join the group the environment describes (``torchrun``'s variables).
    Returns the backend; raises if the group cannot be formed."""
    need = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")
    missing = [k for k in need if k not in os.environ]
    if missing:
        raise RuntimeError(f"cannot form the process group: {missing} "
                           "not set (launch with torchrun or run.main's "
                           "--devices/--spatial_devices)")
    world = int(os.environ["WORLD_SIZE"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = choose_backend(device, local_world)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(device_for_rank(device))
    dist.init_process_group(
        backend, init_method="env://", world_size=world,
        rank=int(os.environ["RANK"]),
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return backend


def destroy():
    if initialized():
        dist.destroy_process_group()


def free_port() -> int:
    """A free TCP port on localhost for the group's store."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(world: int, rank_: int, port: int) -> dict:
    """The environment ``torchrun`` gives rank `rank_` of a one-host group."""
    return {"WORLD_SIZE": str(world), "RANK": str(rank_),
            "LOCAL_RANK": str(rank_), "LOCAL_WORLD_SIZE": str(world),
            "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}


def _spawned(index, fn, args, world, port, results):
    os.environ.update(rank_env(world, index, port))
    out = fn(*args)
    if index == 0:
        # by value: tensors shared by handle die with this process
        results.put(pickle.dumps(out))


def spawn(fn, args, world: int, timeout_s: float | None = None):
    """Run ``fn(*args)`` in `world` spawned processes, each with the
    environment of one ``torchrun`` rank (``fn`` forms the group itself,
    through ``init_from_env``). A rank that fails stops the others and
    raises here. With `timeout_s`, ranks still running after that many
    seconds are killed and raise too; without it the wait has no deadline
    (a rank that hangs in a collective fails after COLLECTIVE_TIMEOUT_S,
    which ends the group). Returns rank 0's return value."""
    import torch.multiprocessing as tmp
    ctx = tmp.get_context("spawn")
    results = ctx.SimpleQueue()
    procs = tmp.start_processes(
        _spawned, args=(fn, args, world, free_port(), results),
        nprocs=world, join=False, start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    out = None
    try:
        while True:
            # read rank 0's result as it comes: a large one fills the pipe
            # and holds rank 0 until it is read
            if out is None and not results.empty():
                out = results.get()
            if procs.join(timeout=1.0):
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{world} spawned ranks still running "
                                   f"after {timeout_s:.0f} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    if out is None and not results.empty():
        out = results.get()
    return None if out is None else pickle.loads(out)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def broadcast_(tensors, src: int = 0):
    """Overwrite `tensors` with rank `src`'s values, in one flattened
    bucket per dtype."""
    if world_size() == 1:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        dist.broadcast(flat, src)
        with torch.no_grad():
            off = 0
            for t in group:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()


def barrier(device):
    """Wait for every rank: an all-reduce of one number on `device`."""
    if world_size() > 1:
        dist.all_reduce(torch.zeros(1, device=device))


def all_reduce_mean(tensors):
    """The mean over the ranks of each tensor of `tensors` (all of one
    dtype), by one all-reduce of a flattened bucket in the given order.
    Returns new tensors; a single rank returns its inputs."""
    if world_size() == 1 or not tensors:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= world_size()
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    return out


def all_gather_rows(x: torch.Tensor, dim: int = 0, sizes=None):
    """The ranks' `x` concatenated along `dim`. `sizes`: each rank's
    extent along `dim` when they differ (the collective moves the largest,
    zero-padded)."""
    world = world_size()
    if world == 1:
        return x
    x = x.contiguous()
    top = x.shape[dim] if sizes is None else max(sizes)
    if x.shape[dim] < top:
        pad = list(x.shape)
        pad[dim] = top - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim)
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x)
    if sizes is not None:
        parts = [p.narrow(dim, 0, n) for p, n in zip(parts, sizes)]
    return torch.cat(parts, dim)


def part(n: int, world: int | None = None, index: int | None = None):
    """Rows [a, b) of `n` that rank `index` holds when `n` rows are split
    over `world` ranks: ``floor(index * n / world)`` onwards, an even split
    whenever `world` divides `n`."""
    world = world_size() if world is None else world
    index = rank() if index is None else index
    return index * n // world, (index + 1) * n // world


def shard_rows(x: torch.Tensor, dim: int = 0):
    """This rank's rows of `x` along `dim` (``part``)."""
    a, b = part(x.shape[dim])
    return x.narrow(dim, a, b - a)


class _AllReduceSum(torch.autograd.Function):
    """Differentiable sum over the ranks: the backward pass sums the
    incoming gradients over the ranks too."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


_SYNC_BATCH = False


@contextlib.contextmanager
def sync_batch_stats():
    """Inside, ``batch_mean`` averages over the ranks' batches as well, so
    a statistic that couples the batch items (the contextual loss's
    channel mean) is the one the whole batch would give. Every rank must
    enter it around the same computation."""
    global _SYNC_BATCH
    prev = _SYNC_BATCH
    _SYNC_BATCH = True
    try:
        yield
    finally:
        _SYNC_BATCH = prev


def batch_mean(x: torch.Tensor, dims) -> torch.Tensor:
    """``x.mean(dims, keepdim=True)``; inside ``sync_batch_stats`` with
    more than one rank, the mean over every rank's `x` (which must all
    have one shape), differentiably."""
    if not (_SYNC_BATCH and world_size() > 1):
        return x.mean(dim=dims, keepdim=True)
    count = 1
    for d in dims:
        count *= x.shape[d]
    total = _AllReduceSum.apply(x.sum(dim=dims, keepdim=True))
    return total / (count * world_size())
