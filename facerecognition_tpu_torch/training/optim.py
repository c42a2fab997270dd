"""The trainers' optimizer chains, with optax's update rules.

The JAX trainers build optax chains (``train_arcface._build_tx``,
``train_facenet``'s ``optax.adam``); ``OptaxChain`` computes the same
updates on a model's parameters, in optax's order:

1. ``clip_by_global_norm(max_norm)``: the gradients are scaled by
   ``(g / norm) * max_norm`` only when ``norm >= max_norm`` (not
   ``torch.nn.utils.clip_grad_norm_``'s ``max_norm / (norm + 1e-6)``);
2. ``add_decayed_weights(wd)`` (SGD only): ``g + wd * p`` on the clipped
   gradient, over every trainable parameter (batch-norm scales and the
   margin weight included);
3. the base optimizer, at ``lr = schedule(count)`` with ``count`` the
   number of updates made before this one:
   - ``sgd``: optax's ``trace``, ``m = g + momentum * m`` from zeros,
     update ``-lr * m``;
   - ``adam``: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g² + b2 nu``,
     bias-corrected by ``1 - b**(count + 1)``, update
     ``-lr * mu_hat / (sqrt(nu_hat) + eps)``;
   - ``adamw``: the adam direction plus ``wd * p`` (decoupled), then
     ``-lr *`` that;
4. with ``plateau``: the update times ``scale`` (optax's
   ``inject_hyperparams(scale)``), which the trainer writes and the state
   dict carries.

Frozen parameters (``trainable`` False: optax's ``multi_transform`` with
``set_to_zero``) are left out of the whole chain: they keep their values bit
for bit, hold no state, and the clip's global norm leaves them out.

The arithmetic is float32 with one rounding per operation, as optax writes
it (no fused multiply-add), and without a host synchronisation.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import numpy as np
import torch

OPTIMIZERS = ("sgd", "adam", "adamw")
#: optax.adam's defaults (the trainers set no others).
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def global_norm(tensors) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm of all the tensors together."""
    tensors = list(tensors)
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class OptaxChain:
    def __init__(
        self,
        params: Mapping[str, torch.Tensor],
        optimizer: str,
        schedule: Callable[[int], float],
        momentum: float = 0.9,
        weight_decay: float = 0.0,
        grad_clip: Optional[float] = None,
        plateau: bool = False,
        trainable: Optional[Mapping[str, bool]] = None,
    ):
        optimizer = optimizer.lower()
        if optimizer not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {optimizer}")
        self.optimizer = optimizer
        self.schedule = schedule
        self.momentum = float(momentum)
        self.weight_decay = float(weight_decay)
        self.grad_clip = None if grad_clip is None else float(grad_clip)
        self.plateau = plateau
        self.names = [n for n in params if trainable is None or trainable[n]]
        self.params = [params[n] for n in self.names]
        self.count = 0
        self.scale = 1.0
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa: E731
        self.state: dict[str, list[torch.Tensor]] = (
            {"trace": zeros()} if optimizer == "sgd" else {"mu": zeros(), "nu": zeros()}
        )

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor]) -> None:
        """Apply one update: ``grads`` by parameter name (frozen ones are
        ignored)."""
        g = [grads[n] for n in self.names]
        if self.grad_clip is not None:
            norm = global_norm(g)
            keep = norm < self.grad_clip
            one = torch.ones((), dtype=norm.dtype, device=norm.device)
            # select(keep, g, (g / norm) * max_norm), each factor exact when kept
            g = torch._foreach_div(g, torch.where(keep, one, norm))
            g = torch._foreach_mul(g, torch.where(keep, one, one * self.grad_clip))
        lr = np.float32(self.schedule(self.count))
        if self.optimizer == "sgd":
            if self.weight_decay:
                g = torch._foreach_add(g, torch._foreach_mul(self.params, self.weight_decay))
            trace = self.state["trace"]
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, g)
            step = trace
        else:
            mu, nu = self.state["mu"], self.state["nu"]
            torch._foreach_mul_(mu, ADAM_B1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - ADAM_B1))
            torch._foreach_mul_(nu, ADAM_B2)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - ADAM_B2))
            t = np.float32(self.count + 1)
            bc1 = float(np.float32(1) - np.float32(ADAM_B1) ** t)
            bc2 = float(np.float32(1) - np.float32(ADAM_B2) ** t)
            denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(denom, ADAM_EPS)
            step = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
            if self.optimizer == "adamw" and self.weight_decay:
                step = torch._foreach_add(step, torch._foreach_mul(self.params, self.weight_decay))
        upd = torch._foreach_mul(step, float(-lr))
        if self.plateau:
            upd = torch._foreach_mul(upd, float(np.float32(self.scale)))
        torch._foreach_add_(self.params, upd)
        self.count += 1

    def state_dict(self) -> dict:
        return {
            "optimizer": self.optimizer,
            "names": list(self.names),
            "count": self.count,
            "scale": self.scale,
            "state": {k: [t.detach().clone() for t in v] for k, v in self.state.items()},
        }

    def load_state_dict(self, state: Mapping) -> None:
        if state["optimizer"] != self.optimizer or list(state["names"]) != self.names:
            raise ValueError("optimizer state is for another chain or other parameters")
        self.count = int(state["count"])
        self.scale = float(state["scale"])
        for key, tensors in state["state"].items():
            for dst, src in zip(self.state[key], tensors):
                dst.copy_(src)
