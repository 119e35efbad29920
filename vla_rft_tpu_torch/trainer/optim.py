"""What the SFT trainers need of optax, with optax's semantics.

The reference builds its optimizers from optax (vla_rft_tpu/trainer/
sft_trainer.py): `chain(clip_by_global_norm(c), adamw(lr))`, optionally
through `multi_transform` with `set_to_zero()` for frozen subtrees.  This
module reproduces those steps on lists of torch parameters:

* `clip_by_global_norm`: scale every gradient by max_norm / ||g|| only when
  ||g|| >= max_norm, with no epsilon (torch's `clip_grad_norm_` adds 1e-6
  and clips at >, so it is not used).  The norm is over every gradient the
  caller passes, frozen parameters' included: the reference clips before
  `multi_transform`, so frozen leaves count in the global norm.
* `AdamW`: optax.adamw's update, in optax's order of operations: moments
  mu = (1 - b1) g + b1 mu and nu = (1 - b2) g^2 + b2 nu, bias correction
  1 - b^t computed in f32 and cast to the moment's dtype, u = mu_hat /
  (sqrt(nu_hat) + eps) + wd * p, p += -lr * u.  Defaults are optax's
  (b1 0.9, b2 0.999, eps 1e-8, weight_decay 1e-4, decay on every leaf);
  torch.optim.AdamW's default decay is 1e-2.  Moments stay in the
  parameter's dtype (bf16 for the libero Qwen), as optax keeps them; there
  is no f32 master copy, because the reference has none.
* `warmup_constant_schedule`: optax's, evaluated at the update count (the
  first update uses count 0).
* Frozen groups (`optax.set_to_zero`) are parameters left out of every
  `AdamW`: they get gradients (for the norm) and never change.

The norm is summed in f32 (optax sums each leaf in its own dtype); for the
f32 models the CPU tests compare, the two are the same computation.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple, Union

import torch

Schedule = Union[float, Callable[[int], float]]


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, an f32 scalar."""
    total = sum((g.float() * g.float()).sum() for g in grads)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@torch.no_grad()
def clip_by_global_norm(grads: Sequence[torch.Tensor],
                        max_norm: float) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """optax.clip_by_global_norm: (g / ||g||) * max_norm for every g when
    ||g|| >= max_norm, else g unchanged.  Returns (grads, ||g||)."""
    norm = global_norm(grads)
    if bool(norm < max_norm):
        return list(grads), norm
    return [(g / norm.to(g.dtype)) * max_norm for g in grads], norm


def warmup_constant_schedule(init_value: float, peak_value: float,
                             warmup_steps: int) -> Callable[[int], float]:
    """optax.warmup_constant_schedule: linear from init_value to peak_value
    over warmup_steps updates, then peak_value."""

    def schedule(count: int) -> float:
        if count >= warmup_steps:
            return peak_value
        return (init_value - peak_value) * (1.0 - count / warmup_steps) + peak_value

    return schedule


class AdamW:
    """optax.adamw over a list of parameters, updated in place."""

    def __init__(self, params: Sequence[torch.nn.Parameter], lr: Schedule, *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-4):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps, self.weight_decay = lr, b1, b2, eps, weight_decay
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """One update from `grads` (one per parameter, in order)."""
        lr = self.lr(self.count) if callable(self.lr) else self.lr
        self.count += 1
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        bc1 = 1.0 - f32(self.b1) ** self.count
        bc2 = 1.0 - f32(self.b2) ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = g.to(p.dtype)
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            dev = p.device
            u = (mu / bc1.to(dev, mu.dtype)) / (torch.sqrt(nu / bc2.to(dev, nu.dtype)) + self.eps)
            u = u + self.weight_decay * p
            p.copy_(p + (-lr) * u)
