"""Categorical sampling with temperature / top-k / top-p.

Port of vla_rft_tpu/ops/sampling.py (the WM rollout's sampler; the run uses
top_p = 0.8, temperature 1, top_k off).  Top-p keeps the reference's
sort-free bisection, so the filtered logits equal the reference's, ties at
the boundary all kept.  Sampling draws Gumbel noise from an explicit
`torch.Generator` (the reference's `jax.random.categorical` is Gumbel-max
too; the bits differ, the distribution does not).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask logits outside the top-k. k <= 0 disables."""
    if k is None or k <= 0:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def apply_top_p(logits: torch.Tensor, p: float, iters: int = 26) -> torch.Tensor:
    """Nucleus filtering: keep a token iff the mass of strictly more probable
    tokens is < p.  The threshold t* = sup{t : mass(probs > t) >= p} is found
    by `iters` bisection steps on [0, max prob]; p >= 1 disables."""
    if p is None or p >= 1.0:
        return logits
    probs = torch.softmax(logits.float(), dim=-1)
    lo = torch.zeros_like(probs[..., :1])
    hi = probs.amax(dim=-1, keepdim=True)
    zero = torch.zeros_like(probs)
    for _ in range(iters):  # invariant: mass(probs > lo) >= p
        mid = 0.5 * (lo + hi)
        ge = torch.where(probs > mid, probs, zero).sum(dim=-1, keepdim=True) >= p
        lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid)
    return torch.where(probs > lo, logits, torch.full_like(logits, NEG_INF))


def filtered_logits(logits: torch.Tensor, temperature: float = 1.0, top_k: int = -1,
                    top_p: float = 1.0) -> torch.Tensor:
    """Temperature + top-k + top-p filtered f32 logits; their softmax is the
    sampling distribution."""
    logits = logits.float() / float(temperature)
    return apply_top_p(apply_top_k(logits, top_k), top_p)


def sample_token(gen: torch.Generator, logits: torch.Tensor, temperature: float = 1.0,
                 top_k: int = -1, top_p: float = 1.0, do_sample: bool = True) -> torch.Tensor:
    """int32 token ids (...) from (..., V) logits, as the reference returns
    them; temperature 0 or do_sample=False gives the argmax (the first one on
    ties)."""
    if not do_sample or temperature == 0:
        return logits.argmax(dim=-1).to(torch.int32)
    fl = filtered_logits(logits, temperature, top_k, top_p)
    u = torch.rand(fl.shape, generator=gen, device=fl.device).clamp_(min=1e-20)
    return (fl - torch.log(-torch.log(u))).argmax(dim=-1).to(torch.int32)
