"""Training runtime of the port."""

from atmonr_tpu_torch.training.trainer import Trainer

__all__ = ["Trainer"]
