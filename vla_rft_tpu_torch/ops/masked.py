"""Masked statistics and logit helpers (port of vla_rft_tpu/ops/masked.py,
verl's torch_functional): log-probs and entropy from logits, masked
mean / var / whiten, response masks and position ids."""
from __future__ import annotations

import torch


def logprobs_from_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """log p(labels) from (..., V) logits, with an f32 logsumexp."""
    logits = logits.float()
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return picked - torch.logsumexp(logits, dim=-1)


def entropy_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """H = logsumexp - sum(p * logits), in f32."""
    logits = logits.float()
    p = torch.softmax(logits, dim=-1)
    return torch.logsumexp(logits, dim=-1) - (p * logits).sum(dim=-1)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, axis=None, eps: float = 1e-8):
    mask = mask.to(x.dtype)
    if axis is None:
        return (x * mask).sum() / (mask.sum() + eps)
    return (x * mask).sum(dim=axis) / (mask.sum(dim=axis) + eps)


def masked_var(x: torch.Tensor, mask: torch.Tensor, unbiased: bool = True):
    mean = masked_mean(x, mask)
    var = masked_mean((x - mean) ** 2, mask)
    if unbiased:
        n = mask.to(x.dtype).sum()
        var = var * n / torch.clamp(n - 1, min=1)
    return var


def masked_whiten(x: torch.Tensor, mask: torch.Tensor, shift_mean: bool = True):
    """(x - mean) / std over the masked entries."""
    mean = masked_mean(x, mask)
    whitened = (x - mean) * torch.rsqrt(masked_var(x, mask) + 1e-8)
    return whitened if shift_mean else whitened + mean


def get_response_mask(response_ids: torch.Tensor, eos_token_id: int, dtype=torch.int32):
    """1 up to and including the first EOS, 0 after."""
    is_eos = (response_ids == eos_token_id).to(torch.int32)
    seen = torch.cumsum(is_eos, dim=-1) - is_eos  # EOS count strictly before each position
    return (seen == 0).to(dtype)


def compute_position_id_with_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """cumsum(mask) - 1 clipped at 0, int32."""
    return (torch.cumsum(attention_mask, dim=-1) - 1).clamp_min(0).to(torch.int32)
