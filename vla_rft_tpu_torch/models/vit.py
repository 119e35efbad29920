"""Vision transformers: SigLIP-so400m + DINOv2-large-reg4 feature towers.

Port of vla_rft_tpu/models/vit.py: patch embedding, optional cls + register
tokens (DINOv2's position embedding covers the patches only), LayerScale,
exact GELU, LayerNorm eps 1e-6.  Only blocks 0 .. depth-2 exist and run (the
reference's second-to-last-layer tap) and the prefix tokens are stripped.
The reference's `nn.scan` over stacked blocks becomes a ModuleList.  The
attention is the plain twin, as the reference's is plain XLA here.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vla_rft_tpu_torch.models.layers import Dense, LayerNorm
from vla_rft_tpu_torch.ops.attention import attention_plain


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1152
    depth: int = 27
    num_heads: int = 16
    mlp_dim: int = 4304
    num_prefix_tokens: int = 0  # cls + register tokens
    class_token: bool = False
    reg_tokens: int = 0
    layerscale: bool = False
    pos_embed_prefix: bool = False  # pos embed covers the cls token too
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.bfloat16
    mean: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    std: Tuple[float, float, float] = (0.5, 0.5, 0.5)

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @staticmethod
    def siglip_so400m(**kw) -> "ViTConfig":
        """vit_so400m_patch14_siglip_224: 1152d/27L/16H, mlp 4304, no cls."""
        d = dict(
            hidden_size=1152, depth=27, num_heads=16, mlp_dim=4304,
            class_token=False, reg_tokens=0, num_prefix_tokens=0,
            mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
        )
        d.update(kw)
        return ViTConfig(**d)

    @staticmethod
    def dinov2_large_reg4(**kw) -> "ViTConfig":
        """vit_large_patch14_reg4_dinov2: 1024d/24L/16H, cls + 4 registers,
        LayerScale, imagenet normalization, no position embedding on the
        prefix tokens."""
        d = dict(
            hidden_size=1024, depth=24, num_heads=16, mlp_dim=4096,
            class_token=True, reg_tokens=4, num_prefix_tokens=5,
            layerscale=True, pos_embed_prefix=False,
            mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
        )
        d.update(kw)
        return ViTConfig(**d)


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.hidden_size
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.norm1 = LayerNorm(D, eps=1e-6, **kw)
        self.q = Dense(D, D, **kw)
        self.k = Dense(D, D, **kw)
        self.v = Dense(D, D, **kw)
        self.proj = Dense(D, D, **kw)
        self.norm2 = LayerNorm(D, eps=1e-6, **kw)
        self.mlp_fc1 = Dense(D, cfg.mlp_dim, **kw)
        self.mlp_fc2 = Dense(cfg.mlp_dim, D, **kw)
        if cfg.layerscale:
            self.ls1_gamma = nn.Parameter(torch.empty(D, dtype=cfg.param_dtype))
            self.ls2_gamma = nn.Parameter(torch.empty(D, dtype=cfg.param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, N, D = x.shape
        H = cfg.num_heads
        h = self.norm1(x)
        q = self.q(h).view(B, N, H, D // H)
        k = self.k(h).view(B, N, H, D // H)
        v = self.v(h).view(B, N, H, D // H)
        o = self.proj(attention_plain(q, k, v, causal=False).reshape(B, N, D))
        if cfg.layerscale:
            o = o * self.ls1_gamma.to(o.dtype)
        x = x + o
        h = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))
        if cfg.layerscale:
            h = h * self.ls2_gamma.to(h.dtype)
        return x + h


class PatchEmbed(nn.Module):
    """Flax nn.Conv with stride = kernel = patch over NHWC images."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        p, D = cfg.patch_size, cfg.hidden_size
        self.weight = nn.Parameter(torch.empty(D, 3, p, p, dtype=cfg.param_dtype))
        self.bias = nn.Parameter(torch.empty(D, dtype=cfg.param_dtype))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dt, p = self.cfg.dtype, self.cfg.patch_size
        x = F.conv2d(
            images.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), self.bias.to(dt), stride=p
        )  # (B, D, g, g)
        return x.flatten(2).transpose(1, 2)  # (B, g*g, D), row-major patches


class ViT(nn.Module):
    """Feature extractor: patch tokens after block depth-2."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        D, pd = cfg.hidden_size, cfg.param_dtype
        self.patch_embed = PatchEmbed(cfg)
        pos_len = cfg.num_patches + (1 if cfg.pos_embed_prefix and cfg.class_token else 0)
        self.pos_embed = nn.Parameter(torch.empty(1, pos_len, D, dtype=pd))
        self.cls_token = (
            nn.Parameter(torch.empty(1, 1, D, dtype=pd)) if cfg.class_token else None
        )
        self.reg_tokens = (
            nn.Parameter(torch.empty(1, cfg.reg_tokens, D, dtype=pd)) if cfg.reg_tokens else None
        )
        self.blocks = nn.ModuleList(ViTBlock(cfg) for _ in range(cfg.depth - 1))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, H, W, 3) normalized -> (B, num_patches, D)."""
        cfg = self.cfg
        x = self.patch_embed(images)
        B, _, D = x.shape
        pos = self.pos_embed.to(x.dtype)
        prefix = []
        if self.cls_token is not None:
            cls = self.cls_token.to(x.dtype).expand(B, 1, D)
            if cfg.pos_embed_prefix:
                cls = cls + pos[:, :1]
                x = x + pos[:, 1:]
            else:
                x = x + pos
            prefix.append(cls)
        else:
            x = x + pos
        if self.reg_tokens is not None:
            prefix.append(self.reg_tokens.to(x.dtype).expand(B, cfg.reg_tokens, D))
        if prefix:
            x = torch.cat(prefix + [x], dim=1)
        for blk in self.blocks:
            x = blk(x)
        return x[:, cfg.num_prefix_tokens:]


def normalize_images(images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """uint8 or float [0,1] (B, H, W, 3) -> f32 normalized for this tower."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    mean = torch.tensor(cfg.mean, dtype=torch.float32, device=images.device)
    std = torch.tensor(cfg.std, dtype=torch.float32, device=images.device)
    return (images.float() - mean) / std
