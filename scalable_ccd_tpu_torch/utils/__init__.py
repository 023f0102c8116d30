"""Utilities."""

from scalable_ccd_tpu_torch.utils.logging import logger, set_logger

__all__ = ["logger", "set_logger"]
