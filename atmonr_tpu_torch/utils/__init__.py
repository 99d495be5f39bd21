"""Config loading and device choice."""

from atmonr_tpu_torch.utils.config import load_config
from atmonr_tpu_torch.utils.device import resolve_device

__all__ = ["load_config", "resolve_device"]
