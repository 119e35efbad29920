"""The trainers' optimizers, with optax's semantics.

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

The GRPO actor's optimizer (vla_rft_tpu/trainer/optim.py) is built from the
same pieces: `label_params` ('sigma' for the sigma net, 'base' otherwise),
`make_optimizer` (two AdamW groups, warmup on the base group only),
`clip_grads_per_module` (each top-level module clipped by its own norm) and
`apply_updates_with_skip` (a non-finite gradient leaves parameters and
optimizer state unchanged).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple, Union

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


# ------------------------------------------------- the GRPO actor's optimizer
SIGMA_KEY = "sigma_net"


def module_of(name: str) -> str:
    """The top-level module of a parameter name (the reference's `_group_of`:
    action_head, sigma_net, proprio_projector, noisy_action_projector)."""
    return name.split(".", 1)[0]


def label_params(names: Sequence[str]) -> Dict[str, str]:
    """'sigma' for the sigma net's parameters, 'base' for everything else."""
    return {n: "sigma" if module_of(n) == SIGMA_KEY else "base" for n in names}


class GroupOptimizer:
    """optax.multi_transform of two AdamWs over named parameters: each
    parameter updated by the AdamW of its label."""

    def __init__(self, named_params, labels: Dict[str, str], groups: Dict[str, "AdamW"]):
        self.names = [n for n, _ in named_params]
        self.labels, self.groups = labels, groups

    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        for label, opt in self.groups.items():
            opt.step([grads[n] for n in self.names if self.labels[n] == label])

    def state_dict(self) -> Dict[str, dict]:
        return {k: {"mu": opt.mu, "nu": opt.nu, "count": opt.count}
                for k, opt in self.groups.items()}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, dict]) -> None:
        for k, opt in self.groups.items():
            for dst, src in zip(opt.mu + opt.nu, state[k]["mu"] + state[k]["nu"]):
                dst.copy_(src)
            opt.count = int(state[k]["count"])


def make_optimizer(named_params, optim_cfg, total_training_steps: int) -> GroupOptimizer:
    """The actor's two-group AdamW (fsdp_workers.py:414-471): 'base' (the
    flow head and projectors) at `lr` with a linear warmup from 0 over
    lr_warmup_steps (or lr_warmup_steps_ratio of the run), weight decay
    `weight_decay`; 'sigma' (the sigma net) at `sigma_lr` (default 2 lr),
    no warmup, weight decay `sigma_weight_decay`."""
    named_params = list(named_params)
    base_lr = optim_cfg.get("lr", 1e-6)
    wd = optim_cfg.get("weight_decay", 0.01)
    b1, b2 = optim_cfg.get("betas", [0.9, 0.999])
    sigma_lr = optim_cfg.get("sigma_lr", base_lr * 2.0)
    sigma_wd = optim_cfg.get("sigma_weight_decay", 0.0)
    warmup = optim_cfg.get("lr_warmup_steps", -1)
    if warmup is None or warmup < 0:
        warmup = int(optim_cfg.get("lr_warmup_steps_ratio", 0.0) * total_training_steps)
    base_schedule = warmup_constant_schedule(0.0, base_lr, warmup) if warmup > 0 else base_lr
    labels = label_params([n for n, _ in named_params])
    of = lambda label: [p for n, p in named_params if labels[n] == label]
    groups = {
        "base": AdamW(of("base"), base_schedule, b1=b1, b2=b2, weight_decay=wd),
        "sigma": AdamW(of("sigma"), sigma_lr, b1=b1, b2=b2, weight_decay=sigma_wd),
    }
    return GroupOptimizer(named_params, labels, groups)


@torch.no_grad()
def clip_grads_per_module(grads: Dict[str, torch.Tensor], max_norm: float):
    """Clip each top-level module's gradients to max_norm by their own
    global norm (dp_actor._optimizer_step).  Returns (clipped grads, the
    norm of the clipped groups together, whether every norm is finite)."""
    groups: Dict[str, List[str]] = {}
    for n in grads:
        groups.setdefault(module_of(n), []).append(n)
    norms = {g: global_norm([grads[n] for n in ns]) for g, ns in sorted(groups.items())}
    finite = torch.stack([torch.isfinite(v) for v in norms.values()]).all()
    scales = {g: torch.clamp(max_norm / torch.clamp(v, min=1e-12), max=1.0)
              for g, v in norms.items()}
    clipped = {n: g * scales[module_of(n)].to(g.dtype) for n, g in grads.items()}
    total = torch.sqrt(sum(torch.clamp(v, max=max_norm) ** 2 for v in norms.values()))
    return clipped, total, finite


def apply_updates_with_skip(opt: GroupOptimizer, grads: Dict[str, torch.Tensor],
                            max_norm: float) -> torch.Tensor:
    """Clip per module, then one optimizer step; when any group's gradient
    is non-finite the step is skipped (parameters and optimizer state
    unchanged) and the reported norm is NaN."""
    clipped, total, finite = clip_grads_per_module(grads, max_norm)
    if not bool(finite):
        return torch.full_like(total, float("nan"))
    opt.step(clipped)
    return total
