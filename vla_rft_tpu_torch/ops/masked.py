"""Masked statistics and logit helpers: the part of
vla_rft_tpu/ops/masked.py the world-model reward path uses."""
from __future__ import annotations

import torch


def logprobs_from_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """log p(labels) from (..., V) logits, with an f32 logsumexp."""
    logits = logits.float()
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return picked - torch.logsumexp(logits, dim=-1)


def compute_position_id_with_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """cumsum(mask) - 1 clipped at 0, int32."""
    return (torch.cumsum(attention_mask, dim=-1) - 1).clamp_min(0).to(torch.int32)
