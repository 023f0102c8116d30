"""scalable_ccd_tpu_torch — continuous collision detection on PyTorch and CUDA.

The port of :mod:`scalable_ccd_tpu` (JAX) to PyTorch, with the two TPU
kernels of its main path rewritten as CUDA kernels for Hopper (``csrc/``):
the broad-phase sweep (kernel A, :mod:`scalable_ccd_tpu_torch.ops.sweep_ap`)
and the narrow-phase solver (kernel B, :mod:`scalable_ccd_tpu_torch.ops.solver`).
On CUDA tensors the pipeline runs the kernels; on CPU tensors their plain
PyTorch versions.  This package never imports jax.

Public API::

    from scalable_ccd_tpu_torch import fused_ccd
    res = fused_ccd(v0, v1, edges, faces, device="cuda")
"""

from scalable_ccd_tpu_torch.pipeline.fused import FusedCCDResult, fused_ccd

__all__ = ["FusedCCDResult", "fused_ccd"]
