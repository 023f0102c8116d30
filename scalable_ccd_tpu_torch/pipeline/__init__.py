"""End-to-end pipelines: the fused pass and the chunked ``ccd()``."""

from scalable_ccd_tpu_torch.pipeline.ccd import CCDStats, ccd, ipc_ccd_strategy
from scalable_ccd_tpu_torch.pipeline.fused import FusedCCDResult, fused_ccd

__all__ = ["CCDStats", "FusedCCDResult", "ccd", "fused_ccd", "ipc_ccd_strategy"]
