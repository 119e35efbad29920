"""Flow-matching action head and its input projectors.

Port of the serving half of vla_rft_tpu/models/action_head.py:
`ActionHeadConfig`, `MLPProjector`, `FlowMatchingActionHead` and
`ActionExpert.predict_flow`.  The sigma net and the training-time sampling
helpers belong to the training slice and are not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from vla_rft_tpu_torch.models.dit import DiTConfig, DiTSingleTokenActionOneCtx
from vla_rft_tpu_torch.models.layers import Dense

ACTION_DIM = 7
NUM_ACTIONS_CHUNK = 8


class MLPProjector(nn.Module):
    """fc1 -> GELU -> fc2."""

    def __init__(self, in_dim: int, out_dim: int, dtype=torch.bfloat16,
                 param_dtype=torch.float32):
        super().__init__()
        self.fc1 = Dense(in_dim, out_dim, dtype=dtype, param_dtype=param_dtype)
        self.fc2 = Dense(out_dim, out_dim, dtype=dtype, param_dtype=param_dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


@dataclasses.dataclass(frozen=True)
class ActionHeadConfig:
    llm_dim: int = 896
    action_dim: int = ACTION_DIM
    num_actions_chunk: int = NUM_ACTIONS_CHUNK
    num_flow_steps: int = 10
    dit_hidden: int = 512
    dit_depth: int = 8
    dit_heads: int = 8
    ctx_every: int = 2
    min_std: float = 0.08
    max_std: float = 0.2
    proprio_dim: int = 8
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    def dit_cfg(self, dtype=None) -> DiTConfig:
        return DiTConfig(
            in_channels=self.action_dim * self.llm_dim,
            out_channels=self.action_dim,
            hidden_size=self.dit_hidden,
            depth=self.dit_depth,
            num_heads=self.dit_heads,
            num_actions=self.num_actions_chunk,
            ctx_every=self.ctx_every,
            llm_dim=self.llm_dim,
            dtype=dtype or self.dtype,
            param_dtype=self.param_dtype,
        )


class FlowMatchingActionHead(nn.Module):
    """Noisy-action features + VLM context -> flow field (B, chunk, A)."""

    def __init__(self, cfg: ActionHeadConfig):
        super().__init__()
        self.cfg = cfg
        self.dit = DiTSingleTokenActionOneCtx(cfg.dit_cfg())

    def forward(self, hidden_states, timesteps, proprio_features, noisy_action_features):
        cfg = self.cfg
        B = noisy_action_features.shape[0]
        obs = noisy_action_features.reshape(
            B, cfg.num_actions_chunk, cfg.action_dim * cfg.llm_dim
        )
        return self.dit(obs, timesteps, hidden_states, proprio_features)


class ActionExpert(nn.Module):
    """The flow head and the two input projectors (the sigma net comes with
    the training slice)."""

    def __init__(self, cfg: ActionHeadConfig):
        super().__init__()
        self.cfg = cfg
        self.action_head = FlowMatchingActionHead(cfg)
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.proprio_projector = MLPProjector(cfg.proprio_dim, cfg.llm_dim, **kw)
        self.noisy_action_projector = MLPProjector(1, cfg.llm_dim, **kw)

    def predict_flow(self, hidden_states, noisy_actions, timesteps, proprio):
        """hidden (B, S_ctx, llm_dim), noisy actions (B, chunk, A), t (B,),
        proprio (B, proprio_dim) -> flow (B, chunk, A)."""
        B = noisy_actions.shape[0]
        naf = self.noisy_action_projector(noisy_actions.reshape(B, -1, 1))
        pf = self.proprio_projector(proprio.reshape(B, -1))
        return self.action_head(hidden_states, timesteps, pf, naf)
