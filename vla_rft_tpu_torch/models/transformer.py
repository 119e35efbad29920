"""Decoder-only transformer (LLaMA / Qwen2 family), full forward only.

Port of vla_rft_tpu/models/transformer.py for the policy backbone
(Qwen2.5-0.5B: GQA 14/2 heads with qkv bias, tied embeddings, rope theta
1e6): RMSNorm, NeoX rope, GQA attention through `ops.attention.attention`
(the CUDA flash kernel on the card), SiLU MLP.  The reference's `nn.scan`
over stacked layers becomes a ModuleList.

Not ported yet (the world-model slice needs them): the KV cache and its
layouts, int8 KV / int8 weights, the shared-prefix split cache, Ulysses.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vla_rft_tpu_torch.models.layers import Dense, Embed
from vla_rft_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: Optional[int] = None
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    qkv_bias: bool = False
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 8192
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    param_dtype: torch.dtype = torch.bfloat16

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @staticmethod
    def qwen25_0_5b(**kw) -> "TransformerConfig":
        d = dict(
            vocab_size=151936,
            hidden_size=896,
            intermediate_size=4864,
            num_layers=24,
            num_heads=14,
            num_kv_heads=2,
            rope_theta=1_000_000.0,
            rms_norm_eps=1e-6,
            qkv_bias=True,
            tie_word_embeddings=True,
            max_position_embeddings=32768,
        )
        d.update(kw)
        return TransformerConfig(**d)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, param_dtype=torch.bfloat16):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim, dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        xf = xf * torch.rsqrt(var + self.eps)
        return (xf * self.weight.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """NeoX-style rotary embedding. x: (B, S, H, D), positions: (B, S)."""
    d = x.shape[-1]
    exponent = torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    freqs = 1.0 / (theta ** exponent)
    angles = positions[..., None].float() * freqs  # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        H, hd, nh, nkv = cfg.hidden_size, cfg.hd, cfg.num_heads, cfg.num_kv_heads
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.q_proj = Dense(H, nh * hd, bias=cfg.qkv_bias, **kw)
        self.k_proj = Dense(H, nkv * hd, bias=cfg.qkv_bias, **kw)
        self.v_proj = Dense(H, nkv * hd, bias=cfg.qkv_bias, **kw)
        self.o_proj = Dense(nh * hd, H, bias=False, **kw)

    def forward(self, x, positions, kv_lens, causal: bool, attn_impl: str):
        cfg = self.cfg
        B, S, _ = x.shape
        q = self.q_proj(x).view(B, S, cfg.num_heads, cfg.hd)
        k = self.k_proj(x).view(B, S, cfg.num_kv_heads, cfg.hd)
        v = self.v_proj(x).view(B, S, cfg.num_kv_heads, cfg.hd)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        out = attention(
            q, k, v, causal=causal, kv_lens=kv_lens, impl=attn_impl
        )
        return self.o_proj(out.reshape(B, S, cfg.num_heads * cfg.hd))


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        kw = dict(bias=False, dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.gate_proj = Dense(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.up_proj = Dense(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.down_proj = Dense(cfg.intermediate_size, cfg.hidden_size, **kw)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.param_dtype)
        self.self_attn = Attention(cfg)
        self.post_attention_layernorm = RMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, cfg.param_dtype
        )
        self.mlp = MLP(cfg)

    def forward(self, x, positions, kv_lens, causal, attn_impl):
        x = x + self.self_attn(self.input_layernorm(x), positions, kv_lens, causal, attn_impl)
        return x + self.mlp(self.post_attention_layernorm(x))


class Decoder(nn.Module):
    """LLaMA/Qwen2-style causal decoder, full forward.

    `attn_impl` is "auto" (the CUDA kernel for CUDA tensors, the plain twin
    for CPU tensors) or "plain" (the twin everywhere, the reference the
    kernel path is checked against on the card)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.attn_impl = "auto"
        self.embed_tokens = Embed(
            cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype, param_dtype=cfg.param_dtype
        )
        self.layers = nn.ModuleList(DecoderLayer(cfg) for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.param_dtype)
        self.lm_head = (
            None if cfg.tie_word_embeddings
            else Dense(cfg.hidden_size, cfg.vocab_size, bias=False, dtype=cfg.dtype,
                       param_dtype=cfg.param_dtype)
        )

    def forward(
        self,
        input_ids: Optional[torch.Tensor] = None,
        inputs_embeds: Optional[torch.Tensor] = None,
        kv_lens: Optional[torch.Tensor] = None,
        causal: bool = True,
        compute_logits: bool = True,
        embed_only: bool = False,
    ):
        """embed_only -> token embeddings (B, S, H); otherwise
        (logits (B, S, V) f32 or None, hidden (B, S, H) after the final norm)."""
        cfg = self.cfg
        if embed_only:
            return self.embed_tokens(input_ids)
        if inputs_embeds is None:
            inputs_embeds = self.embed_tokens(input_ids)
        B, S, _ = inputs_embeds.shape
        dev = inputs_embeds.device
        positions = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)
        if kv_lens is None:
            kv_lens = torch.full((B,), S, dtype=torch.int32, device=dev)
        x = inputs_embeds
        for layer in self.layers:
            x = layer(x, positions, kv_lens, causal, self.attn_impl)
        x = self.norm(x)
        logits = None
        if compute_logits:
            if cfg.tie_word_embeddings:
                logits = self.embed_tokens.attend(x.to(cfg.dtype))
            else:
                logits = self.lm_head(x)
            logits = logits.float()
        return logits, x
