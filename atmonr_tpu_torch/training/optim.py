"""The train step's optimizer: AdamW behind a global-norm clip, with the
learning rate driven per step by a schedule. Counterpart of the optax chain
``clip_by_global_norm -> adamw(schedule, mask)`` that the JAX package's
``make_optimizer`` builds.

``torch.optim.AdamW`` does the update, with two parameter groups (weight
decay or none). Two things are done here as optax does them:

- the clip leaves the gradients untouched when their global norm is below
  ``max_norm`` and otherwise computes ``(g / norm) * max_norm``
  (``clip_grad_norm_`` multiplies by ``max_norm / (norm + 1e-6)`` instead);
  it is computed on the device, with no host synchronisation;
- the schedule is read at the optimizer's own step count, 0 for the first
  update, and a fresh optimizer starts again at 0.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from atmonr_tpu_torch.utils import spans


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of all squared elements, as a 0-d tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place to a global norm of at most ``max_norm``, as
    ``optax.clip_by_global_norm``; returns the norm before the clip."""
    grads = list(grads)
    norm = global_norm(grads)
    below = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(below, one, norm))
    torch._foreach_mul_(grads, torch.where(below, one, max_norm * one))
    return norm


class ClippedAdamW:
    """AdamW on two parameter groups (``decay_params`` with the config's
    ``weight_decay``, ``no_decay_params`` with none) behind the optional
    ``clip_global_norm`` of the optimizer config.

    ``lr_schedule`` is a float or a function of the step count. ``step()``
    clips the parameters' ``.grad``, sets the learning rate for the current
    count, updates, and advances the count."""

    def __init__(
        self,
        decay_params: Sequence[torch.nn.Parameter],
        no_decay_params: Sequence[torch.nn.Parameter],
        optimizer_config: dict,
        lr_schedule: float | Callable[[int], float],
    ) -> None:
        b1, b2 = optimizer_config.get("betas", (0.9, 0.999))
        self.lr_schedule = lr_schedule if callable(lr_schedule) else (lambda step: lr_schedule)
        clip = optimizer_config.get("clip_global_norm")
        self.max_norm = float(clip) if clip else None
        self.count = 0
        self.adamw = torch.optim.AdamW(
            [
                {
                    "params": list(decay_params),
                    "weight_decay": float(optimizer_config.get("weight_decay", 0.0)),
                },
                {"params": list(no_decay_params), "weight_decay": 0.0},
            ],
            lr=float(self.lr_schedule(0)),
            betas=(float(b1), float(b2)),
            eps=float(optimizer_config.get("eps", 1e-8)),
        )

    @property
    def params(self) -> list[torch.nn.Parameter]:
        return [p for group in self.adamw.param_groups for p in group["params"]]

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> None:
        with spans.span("optim.step"):
            grads = [p.grad for p in self.params if p.grad is not None]
            if self.max_norm is not None and grads:
                clip_by_global_norm_(grads, self.max_norm)
            lr = float(self.lr_schedule(self.count))
            for group in self.adamw.param_groups:
                group["lr"] = lr
            self.adamw.step()
            self.count += 1

    def state_dict(self) -> dict[str, Any]:
        return {"count": self.count, "adamw": self.adamw.state_dict()}

    def load_state_dict(self, state: dict[str, Any]) -> None:
        self.count = int(state["count"])
        self.adamw.load_state_dict(state["adamw"])
