"""End-to-end pipelines."""

from scalable_ccd_tpu_torch.pipeline.fused import FusedCCDResult, fused_ccd

__all__ = ["FusedCCDResult", "fused_ccd"]
