"""Lion (counterpart of optax's ``lion``, which ``nif_tpu/optimizers`` wraps):
the update is the sign of ``(1-b1) g + b1 m``, the momentum then takes
``(1-b2) g + b2 m``, and decoupled weight decay ``weight_decay * p`` joins
the update before it is scaled by ``-lr``."""
from __future__ import annotations

import torch

__all__ = ["Lion"]


class Lion(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-4, betas=(0.9, 0.99), weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["m"] = torch.zeros_like(p)
                st["step"] += 1
                update = torch.sign((1.0 - b1) * g + b1 * st["m"])
                st["m"] = (1 - b2) * g + b2 * st["m"]
                update = update + group["weight_decay"] * p
                p.add_((-group["lr"]) * update)
        return loss
