"""scalable_ccd_tpu_torch — continuous collision detection on PyTorch and CUDA.

The port of :mod:`scalable_ccd_tpu` (JAX) to PyTorch, with the TPU kernels
of its paths rewritten as CUDA kernels for Hopper (``csrc/``): the
broad-phase sweep with pair emission (kernel A,
:mod:`scalable_ccd_tpu_torch.ops.sweep_ap`) and with record emission
(kernel A', :mod:`scalable_ccd_tpu_torch.ops.sweep_records`), and the
narrow-phase solver (kernel B, :mod:`scalable_ccd_tpu_torch.ops.solver`).
The entry points run on CUDA unless ``device`` names another device; on
CUDA tensors the pipelines run the kernels, on CPU tensors their plain
PyTorch versions.  This package never imports jax.

Public API::

    from scalable_ccd_tpu_torch import ccd, fused_ccd, ipc_ccd_strategy
    res = fused_ccd(v0, v1, edges, faces)                     # one pass
    toi = ccd(v0, v1, edges, faces)                           # chunked
    toi = ipc_ccd_strategy(v0, v1, edges, faces, min_distance=1e-3)  # IPC step rule
    res = fused_ccd(v0, v1, edges, faces, device="cpu")       # plain versions
    res = sharded_ccd(v0, v1, edges, faces)   # every rank of a torch.distributed group

The multi-device path (:mod:`scalable_ccd_tpu_torch.parallel`) runs on a
``torch.distributed`` process group, one process per device; the native
host broad phase (:mod:`scalable_ccd_tpu_torch.host`) is a C++
sort-and-sweep for the CPU.
"""

from scalable_ccd_tpu_torch.config import DEFAULT_CONFIG, CCDConfig, MemoryConfig
from scalable_ccd_tpu_torch.parallel.sharded import sharded_ccd
from scalable_ccd_tpu_torch.pipeline.ccd import CCDStats, ccd, ipc_ccd_strategy
from scalable_ccd_tpu_torch.pipeline.fused import FusedCCDResult, fused_ccd

__all__ = [
    "CCDConfig",
    "CCDStats",
    "DEFAULT_CONFIG",
    "FusedCCDResult",
    "MemoryConfig",
    "ccd",
    "fused_ccd",
    "ipc_ccd_strategy",
    "sharded_ccd",
]
