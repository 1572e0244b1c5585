"""Multi-device paths of the port: the process group and its collectives
(``mesh``), the H-sharded stream's shard-local ops (``spatial``) and its
serving set-up (``serve``); counterpart of ``refvsr_tpu/parallel``."""

from refvsr_tpu_torch.parallel.mesh import (  # noqa: F401
    all_gather_rows, all_reduce_mean, device_for_rank, is_main, rank,
    shard_rows, world_size)
