"""Action-expert DiT: DiT_SingleTokenAction_OneCtx.

Port of vla_rft_tpu/models/dit.py: adaLN-Zero blocks over the action
tokens, a sinusoidal TimestepEmbedder, cross-attention into the VLM context
every `ctx_every` blocks (plus the first and last), a final adaLN layer and
a fixed sincos temporal embedding.  Parameters are f32 and compute is bf16
by default, as in the reference.  The attention here is plain PyTorch: the
reference's is plain XLA too.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vla_rft_tpu_torch.models.layers import Dense, LayerNorm


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    in_channels: int
    out_channels: int = 7
    hidden_size: int = 512
    depth: int = 8
    num_heads: int = 8
    mlp_ratio: float = 4.0
    num_actions: int = 8
    ctx_every: int = 2
    llm_dim: int = 896
    freq_dim: int = 256
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32


def sincos_temp_embed(length: int, dim: int) -> np.ndarray:
    """get_1d_sincos_temp_embed: (length, dim) [sin | cos] halves."""
    pos = np.arange(length, dtype=np.float64)
    omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
    omega = 1.0 / (10000.0**omega)
    out = np.einsum("m,d->md", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1).astype(np.float32)


def timestep_frequency_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0):
    """[cos | sin] halves of t (B,) f32 at geometric frequencies."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _modulate(x, shift, scale):
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def _softmax_attend(q, k, v, hd: int):
    """Plain attention as the reference writes it: scores rounded to the
    compute dtype, softmax in f32, probabilities back in the compute dtype."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (hd ** -0.5)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


class TimestepEmbedder(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.fc1 = Dense(cfg.freq_dim, cfg.hidden_size, **kw)
        self.fc2 = Dense(cfg.hidden_size, cfg.hidden_size, **kw)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        h = timestep_frequency_embedding(t, self.cfg.freq_dim)
        return self.fc2(F.silu(self.fc1(h)))


class SelfAttention(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        C = cfg.hidden_size
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.qkv = Dense(C, 3 * C, **kw)
        self.proj = Dense(C, C, **kw)

    def forward(self, x):
        cfg = self.cfg
        B, N, C = x.shape
        hd = C // cfg.num_heads
        qkv = self.qkv(x).view(B, N, 3, cfg.num_heads, hd)
        o = _softmax_attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], hd)
        return self.proj(o.reshape(B, N, C))


class CrossAttention(nn.Module):
    """Pre-LN on both streams, separate q (v_proj) / k (l_proj) / v
    (values_l_proj) heads, out projection, LayerScale `gamma_v` residual."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        C = cfg.hidden_size
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.layer_norm_v = LayerNorm(C, eps=1e-6, **kw)
        self.layer_norm_l = LayerNorm(C, eps=1e-6, **kw)
        self.v_proj = Dense(C, C, **kw)
        self.l_proj = Dense(C, C, **kw)
        self.values_l_proj = Dense(C, C, **kw)
        self.out_v_proj = Dense(C, C, **kw)
        self.gamma_v = nn.Parameter(torch.empty(C, dtype=cfg.param_dtype))

    def forward(self, x, ctx):
        cfg = self.cfg
        B, N, C = x.shape
        H, hd = cfg.num_heads, C // cfg.num_heads
        xv = self.layer_norm_v(x)
        cl = self.layer_norm_l(ctx)
        q = self.v_proj(xv).view(B, N, H, hd)
        k = self.l_proj(cl).view(B, cl.shape[1], H, hd)
        v = self.values_l_proj(cl).view(B, cl.shape[1], H, hd)
        o = self.out_v_proj(_softmax_attend(q, k, v, hd).reshape(B, N, C))
        return x + self.gamma_v.to(o.dtype) * o


class DiTBlock(nn.Module):
    def __init__(self, cfg: DiTConfig, use_cross: bool):
        super().__init__()
        H = cfg.hidden_size
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.adaLN_modulation = Dense(H, 6 * H, **kw)
        self.norm1 = LayerNorm(H, eps=1e-6, use_bias=False, use_scale=False)
        self.attn_temporal = SelfAttention(cfg)
        self.cross_attn = CrossAttention(cfg) if use_cross else None
        self.norm3 = LayerNorm(H, eps=1e-6, use_bias=False, use_scale=False)
        self.mlp_fc1 = Dense(H, int(H * cfg.mlp_ratio), **kw)
        self.mlp_fc2 = Dense(int(H * cfg.mlp_ratio), H, **kw)

    def forward(self, x, c, ctx):
        mod = self.adaLN_modulation(F.silu(c))
        sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = mod.chunk(6, dim=-1)
        h = self.attn_temporal(_modulate(self.norm1(x), sh_msa, sc_msa))
        x = x + g_msa[:, None, :] * h
        if self.cross_attn is not None:
            x = self.cross_attn(x, ctx)
        h = _modulate(self.norm3(x), sh_mlp, sc_mlp)
        h = self.mlp_fc2(F.gelu(self.mlp_fc1(h), approximate="tanh"))
        return x + g_mlp[:, None, :] * h


class DiTSingleTokenActionOneCtx(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.x_embedder = Dense(cfg.in_channels, H, **kw)
        self.t_embedder = TimestepEmbedder(cfg)
        self.proprio_embedder = Dense(cfg.llm_dim, H, **kw)
        self.context_adapter = Dense(cfg.llm_dim, H, **kw)
        self.blocks = nn.ModuleList(
            DiTBlock(cfg, (i % cfg.ctx_every == 0) or (i == cfg.depth - 1))
            for i in range(cfg.depth)
        )
        self.final_adaLN = Dense(H, 2 * H, **kw)
        self.norm_final = LayerNorm(H, eps=1e-6, use_bias=False, use_scale=False)
        self.final_linear = Dense(H, cfg.out_channels, **kw)
        self.register_buffer(
            "temp_embed", torch.tensor(sincos_temp_embed(cfg.num_actions, H)),
            persistent=False,
        )

    def forward(
        self,
        x: torch.Tensor,  # (B, num_actions, in_channels)
        timesteps: torch.Tensor,  # (B,) in [0, 1]
        context: torch.Tensor,  # (B, S_ctx, llm_dim)
        proprio: torch.Tensor,  # (B, llm_dim), projected proprio
    ) -> torch.Tensor:
        x = self.x_embedder(x)
        x = x + self.temp_embed[None].to(x.dtype)
        t_emb = self.t_embedder(timesteps)
        p_emb = self.proprio_embedder(proprio)
        ctx = self.context_adapter(context)
        c = p_emb + t_emb + ctx.mean(dim=1)
        for blk in self.blocks:
            x = blk(x, c, ctx)
        shift, scale = self.final_adaLN(F.silu(c)).chunk(2, dim=-1)
        h = _modulate(self.norm_final(x), shift, scale)
        return self.final_linear(h)  # (B, num_actions, out_channels)
