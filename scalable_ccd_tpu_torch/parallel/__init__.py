"""The multi-device path on ``torch.distributed`` (counterpart of
``scalable_ccd_tpu.parallel``)."""

from scalable_ccd_tpu_torch.parallel.launch import dryrun_multichip, pick_backend, spawn_local
from scalable_ccd_tpu_torch.parallel.sharded import (
    FusedCollisionsResult,
    default_group,
    make_sharded_ccd,
    partition_slice,
    rank_device,
    sharded_ccd,
)

__all__ = [
    "FusedCollisionsResult",
    "default_group",
    "dryrun_multichip",
    "make_sharded_ccd",
    "partition_slice",
    "pick_backend",
    "rank_device",
    "sharded_ccd",
    "spawn_local",
]
