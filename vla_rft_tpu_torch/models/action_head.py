"""Flow-matching action head and its input projectors.

Port of vla_rft_tpu/models/action_head.py: `ActionHeadConfig`,
`MLPProjector`, `FlowMatchingActionHead`, `TokenSigmaNet` (the per-dim
sigma head of the stochastic rollout: the same DiT computed in f32, a
tanh-squashed log-std in [log(min_std), log(max_std)]), `ActionExpert`
(`predict_flow`, `predict_std` and both together) and the flow-matching
targets (`sample_beta`, `sample_noisy_actions`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vla_rft_tpu_torch.models.dit import DiTConfig, DiTSingleTokenActionOneCtx
from vla_rft_tpu_torch.models.layers import Dense

ACTION_DIM = 7
NUM_ACTIONS_CHUNK = 8


def sample_beta(gen: Optional[torch.Generator], alpha: float, beta: float, shape,
                device=None) -> torch.Tensor:
    """action_heads.py:12-15: g_i = U_i^(1/a_i); t = g1 / (g1 + g2), f32."""
    g1 = torch.rand(shape, generator=gen, device=device) ** (1.0 / alpha)
    g2 = torch.rand(shape, generator=gen, device=device) ** (1.0 / beta)
    return g1 / (g1 + g2)


def noisy_actions(noise: torch.Tensor, timesteps: torch.Tensor,
                  gt_actions: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The flow-matching pair from bf16 noise (B, chunk, A) and bf16 flow
    times (B,): x_t = (1 - t) noise + t gt and u = noise - gt, computed in
    f32 and stored in bf16 (the reference's `sample_noisy_actions` after its
    draws)."""
    t = timesteps.float()[:, None, None]
    noise_f, gt = noise.float(), gt_actions.float()
    return {
        "noise": noise,
        "flow": (noise_f - gt).to(torch.bfloat16),
        "gt_noisy_actions": ((1.0 - t) * noise_f + t * gt).to(torch.bfloat16),
        "gt_timesteps": timesteps,
    }


def sample_noisy_actions(gen: Optional[torch.Generator], gt_actions: torch.Tensor,
                         cfg: "ActionHeadConfig") -> Dict[str, torch.Tensor]:
    """FlowMatchingActionHead.sample_noisy_actions (action_heads.py:63-96):
    noise drawn in f32 and rounded to bf16, t ~ Beta(1.5, 1) mapped to
    t * 0.999 + 0.001 and rounded to bf16, then `noisy_actions`.  The draws
    come from `gen` (torch's stream, not JAX's: parity tests pass the same
    noise dict to both)."""
    B, dev = gt_actions.shape[0], gt_actions.device
    noise = torch.randn((B, cfg.num_actions_chunk, cfg.action_dim), generator=gen,
                        device=dev, dtype=torch.float32).to(torch.bfloat16)
    t_beta = sample_beta(gen, 1.5, 1.0, (B,), dev)
    return noisy_actions(noise, (t_beta * 0.999 + 0.001).to(torch.bfloat16), gt_actions)


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


class TokenSigmaNet(nn.Module):
    """Per-dim sigma head: the DiT in f32 (parameters and compute), then
    log_std = log_min + (log_max - log_min) (tanh(raw) + 1) / 2."""

    def __init__(self, cfg: ActionHeadConfig):
        super().__init__()
        self.cfg = cfg
        self.dit = DiTSingleTokenActionOneCtx(cfg.dit_cfg(dtype=torch.float32))

    def forward(self, hidden_states, timesteps, proprio_features, noisy_action_features
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        B = noisy_action_features.shape[0]
        obs = noisy_action_features.reshape(
            B, cfg.num_actions_chunk, cfg.action_dim * cfg.llm_dim
        ).float()
        raw = self.dit(obs, timesteps.float(), hidden_states.float(), proprio_features.float())
        log_min, log_max = math.log(cfg.min_std), math.log(cfg.max_std)
        log_std = log_min + (log_max - log_min) * (torch.tanh(raw.float()) + 1.0) * 0.5
        return torch.exp(log_std), log_std


class ActionExpert(nn.Module):
    """The trainable modules: the flow head, the sigma net and the two input
    projectors (one module, so the optimizer sees one parameter tree)."""

    def __init__(self, cfg: ActionHeadConfig):
        super().__init__()
        self.cfg = cfg
        self.action_head = FlowMatchingActionHead(cfg)
        self.sigma_net = TokenSigmaNet(cfg)
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.proprio_projector = MLPProjector(cfg.proprio_dim, cfg.llm_dim, **kw)
        self.noisy_action_projector = MLPProjector(1, cfg.llm_dim, **kw)

    def _project_inputs(self, noisy_actions, proprio):
        B = noisy_actions.shape[0]
        naf = self.noisy_action_projector(noisy_actions.reshape(B, -1, 1))
        pf = self.proprio_projector(proprio.reshape(B, -1))
        return naf, pf

    def predict_flow(self, hidden_states, noisy_actions, timesteps, proprio):
        """hidden (B, S_ctx, llm_dim), noisy actions (B, chunk, A), t (B,),
        proprio (B, proprio_dim) -> flow (B, chunk, A)."""
        naf, pf = self._project_inputs(noisy_actions, proprio)
        return self.action_head(hidden_states, timesteps, pf, naf)

    def predict_std(self, hidden_states, noisy_actions, timesteps, proprio):
        """The same inputs -> (std, log_std), (B, chunk, A) f32."""
        naf, pf = self._project_inputs(noisy_actions, proprio)
        return self.sigma_net(hidden_states, timesteps, pf, naf)

    def forward(self, hidden_states, noisy_actions, timesteps, proprio):
        flow = self.predict_flow(hidden_states, noisy_actions, timesteps, proprio)
        std, log_std = self.predict_std(hidden_states, noisy_actions, timesteps, proprio)
        return flow, std, log_std
