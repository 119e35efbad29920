"""Action-token masks over label sequences.

Port of vla_rft_tpu/models/action_masks.py (prismatic/training/
train_utils.py:8-41).  Token ids above ACTION_TOKEN_BEGIN_IDX are action
tokens; the cumulative count of non-IGNORE labels splits them into the
current action (first ACTION_DIM) and the next actions (the rest).
"""
from __future__ import annotations

import torch

IGNORE_INDEX = -100
ACTION_TOKEN_BEGIN_IDX = 151386
ACTION_DIM = 7
NUM_ACTIONS_CHUNK = 8
PROPRIO_DIM = 8
NUM_TOKENS = 64


def get_current_action_mask(token_ids: torch.Tensor) -> torch.Tensor:
    cumsum = torch.cumsum((token_ids != IGNORE_INDEX).to(torch.int32), dim=1)
    mask = (cumsum >= 1) & (cumsum <= ACTION_DIM)
    return mask & (token_ids > ACTION_TOKEN_BEGIN_IDX)


def get_next_actions_mask(token_ids: torch.Tensor) -> torch.Tensor:
    cumsum = torch.cumsum((token_ids != IGNORE_INDEX).to(torch.int32), dim=1)
    return (cumsum > ACTION_DIM) & (token_ids > ACTION_TOKEN_BEGIN_IDX)


def gather_masked(x: torch.Tensor, mask: torch.Tensor, n: int):
    """The first n True positions of each row of `mask`, in order:
    returns (x gathered at them (B, n, ...), their indices (B, n)).  Rows
    must hold at least n True entries (the collator guarantees it)."""
    B, S = mask.shape
    pos = torch.arange(S, device=mask.device)[None, :]
    key = torch.where(mask, pos, S + pos)
    idx = torch.argsort(key, dim=-1)[:, :n]
    gathered = torch.take_along_dim(x, idx.reshape(B, n, *([1] * (x.dim() - 2))), dim=1)
    return gathered, idx


def scatter_rows(x: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """A copy of x (B, S, D) with values (B, n, D) written at idx (B, n)."""
    out = x.clone()
    batch_idx = torch.arange(x.shape[0], device=x.device)[:, None]
    out[batch_idx, idx] = values.to(x.dtype)
    return out
