"""Utilities."""

from scalable_ccd_tpu_torch.utils.logging import logger, set_logger
from scalable_ccd_tpu_torch.utils.timer import Timer

__all__ = ["Timer", "logger", "set_logger"]
