"""World-model sequence processor for the ctx_msp layout.

Port of the part of vla_rft_tpu/workers/processor.py that the reward path
runs (ContextMultiStepPredictionProcessor, the VLA-RFT layout):
    [ctx (Nc tokens, +visual_token_num)] then per future frame
    [dyn (Nd tokens)] [act (action_dim tokens, +2*visual_token_num)]
LIBERO: 1024 + 9 * (64 + 7) = 1663 tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from vla_rft_tpu_torch.ops.masked import compute_position_id_with_mask


@dataclasses.dataclass(frozen=True)
class ProcessorConfig:
    """The fields of the `processor:` config group that the ctx_msp path
    reads (the reference's ProcessorConfig also carries the BOS/EOS framing
    of the 'simple' processor, which is not ported)."""

    visual_token_num: int = 4375
    action_bins: int = 256
    action_dim: int = 7
    tokens_per_frame: int = 64


def discretize_actions(actions: torch.Tensor, action_ranges: torch.Tensor,
                       num_bins: int = 256) -> torch.Tensor:
    """Uniform bins: actions (..., A), ranges (A, 2) [min, max] -> int32 (..., A)."""
    mins, maxs = action_ranges[:, 0], action_ranges[:, 1]
    x = torch.clamp((actions - mins) / (maxs - mins + 1e-8), 0.0, 1.0)
    return torch.clamp(torch.floor(x * num_bins), 0, num_bins - 1).to(torch.int32)


def ctx_msp_process(cfg: ProcessorConfig, ctx_tokens: torch.Tensor, dyn_tokens: torch.Tensor,
                    actions: torch.Tensor, action_ranges: torch.Tensor) -> Dict[str, torch.Tensor]:
    """ctx_tokens (B, 1, Nc) and dyn_tokens (B, T, Nd) raw FSQ indices,
    actions (B, T+1, A) continuous -> input_ids, attention_mask,
    position_ids, labels, action_ids and the offset ctx_tokens."""
    B, T = dyn_tokens.shape[:2]
    v = cfg.visual_token_num
    ctx = (ctx_tokens + v).reshape(B, -1)
    act = discretize_actions(actions[:, 1:], action_ranges, cfg.action_bins) + 2 * v
    hist = torch.cat([dyn_tokens.to(torch.int32), act], dim=-1).reshape(B, -1)
    input_ids = torch.cat([ctx.to(torch.int32), hist], dim=-1)
    labels = hist.clone()
    labels[:, : dyn_tokens.shape[-1]] = -100  # the first frame's dyn tokens are given
    labels = torch.cat([torch.full_like(ctx, -100, dtype=torch.int32), labels], dim=-1)
    attention_mask = torch.ones(input_ids.shape, dtype=torch.float32, device=input_ids.device)
    return {
        "input_ids": input_ids,
        "attention_mask": attention_mask,
        "position_ids": compute_position_id_with_mask(attention_mask),
        "labels": labels,
        "action_ids": act,
        "ctx_tokens": (ctx_tokens + v).to(torch.int32),
    }


def add_context_frame(pixels: torch.Tensor, actions: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prepend frame 0 as the context frame; pad actions with their first
    and last entries.  pixels (B, T, ...), actions (B, T-1, A) ->
    (B, T+1, ...), (B, T+1, A)."""
    return (torch.cat([pixels[:, :1], pixels], dim=1),
            torch.cat([actions[:, :1], actions, actions[:, -1:]], dim=1))


def split_response_tokens(cfg: ProcessorConfig, responses: torch.Tensor,
                          num_frames: int) -> torch.Tensor:
    """responses (B, F*(Nd+A)) -> visual tokens (B, F, Nd) clamped to the
    visual-token range."""
    B = responses.shape[0]
    per = cfg.tokens_per_frame + cfg.action_dim
    r = responses[:, : num_frames * per].reshape(B, num_frames, per)
    return torch.clamp(r[:, :, : cfg.tokens_per_frame], 0, cfg.visual_token_num - 1).to(torch.int32)
