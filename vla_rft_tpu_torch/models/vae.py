"""Convolutional VAE blocks of the visual tokenizer, NCHW.

Port of vla_rft_tpu/models/vae.py (diffusers-style ResnetBlock2D, down/up
blocks, the mid block with single-head spatial attention, and the
cross-frame CrossAttentionBlock2D of the conditional encoder/decoder).  The
reference works channels-last for the TPU; these modules work on
(B, C, H, W) and keep the reference's module names, so a Flax tree converts
leaf by leaf (convert.py transposes the conv kernels).  Convolutions are
`F.conv2d` and the attention is plain softmax attention, as in the
reference (plain XLA there).  Every module computes in `dtype` with f32
parameters, as Flax's `dtype=` does.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vla_rft_tpu_torch.models.layers import Conv, Dense, GroupNorm


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W, C), row-major over (H, W) like NHWC."""
    return x.flatten(2).transpose(1, 2)


def _image(t: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, H*W, C) -> (B, C, H, W)."""
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], H, W)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, groups: int = 32, eps: float = 1e-6,
                 dtype=torch.float32):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_ch, eps=eps, dtype=dtype)
        self.conv1 = Conv(in_ch, out_ch, 3, padding=1, dtype=dtype)
        self.norm2 = GroupNorm(groups, out_ch, eps=eps, dtype=dtype)
        self.conv2 = Conv(out_ch, out_ch, 3, padding=1, dtype=dtype)
        self.conv_shortcut = Conv(in_ch, out_ch, 1, dtype=dtype) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class SpatialAttention(nn.Module):
    """GroupNorm -> one-head attention over H*W -> residual."""

    def __init__(self, ch: int, groups: int = 32, eps: float = 1e-6, dtype=torch.float32):
        super().__init__()
        self.group_norm = GroupNorm(groups, ch, eps=eps, dtype=dtype)
        self.to_q = Dense(ch, ch, dtype=dtype)
        self.to_k = Dense(ch, ch, dtype=dtype)
        self.to_v = Dense(ch, ch, dtype=dtype)
        self.to_out = Dense(ch, ch, dtype=dtype)

    def forward(self, x):
        B, C, H, W = x.shape
        h = _tokens(self.group_norm(x))
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        s = torch.einsum("bqc,bkc->bqk", q, k).float() * (C ** -0.5)
        p = torch.softmax(s, dim=-1).to(h.dtype)
        o = self.to_out(torch.einsum("bqk,bkc->bqc", p, v))
        return x + _image(o, H, W)


class Downsample(nn.Module):
    """Stride-2 conv after diffusers' asymmetric (0, 1, 0, 1) padding."""

    def __init__(self, ch: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv(ch, ch, 3, stride=2, dtype=dtype)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Exact 2x nearest upsample, then a 3x3 conv."""

    def __init__(self, ch: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv(ch, ch, 3, padding=1, dtype=dtype)

    def forward(self, x):
        return self.conv(x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3))


class DownEncoderBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, num_layers: int, add_downsample: bool,
                 groups: int, dtype=torch.float32):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"resnets_{i}", ResnetBlock(in_ch if i == 0 else out_ch, out_ch,
                                                        groups, dtype=dtype))
        self.num_layers = num_layers
        self.downsamplers_0 = Downsample(out_ch, dtype) if add_downsample else None

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"resnets_{i}")(x)
        return x if self.downsamplers_0 is None else self.downsamplers_0(x)


class UpDecoderBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, num_layers: int, add_upsample: bool,
                 groups: int, dtype=torch.float32):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"resnets_{i}", ResnetBlock(in_ch if i == 0 else out_ch, out_ch,
                                                        groups, dtype=dtype))
        self.num_layers = num_layers
        self.upsamplers_0 = Upsample(out_ch, dtype) if add_upsample else None

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"resnets_{i}")(x)
        return x if self.upsamplers_0 is None else self.upsamplers_0(x)


class UNetMidBlock(nn.Module):
    def __init__(self, ch: int, groups: int, add_attention: bool = True, dtype=torch.float32):
        super().__init__()
        self.resnets_0 = ResnetBlock(ch, ch, groups, dtype=dtype)
        self.attentions_0 = SpatialAttention(ch, groups, dtype=dtype) if add_attention else None
        self.resnets_1 = ResnetBlock(ch, ch, groups, dtype=dtype)

    def forward(self, x):
        x = self.resnets_0(x)
        if self.attentions_0 is not None:
            x = self.attentions_0(x)
        return self.resnets_1(x)


class CrossAttentionBlock2D(nn.Module):
    """Cross-frame attention from the dynamics path into the context
    features: GroupNorm (eps 1e-5) on both, learned positional embeddings,
    4-head attention, residual + silu."""

    def __init__(self, ch: int, resolution: int, num_heads: int = 4, groups: int = 32,
                 kv_frames: int = 1, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.kv_norm = GroupNorm(groups, ch, eps=1e-5, dtype=dtype)
        self.q_norm = GroupNorm(groups, ch, eps=1e-5, dtype=dtype)
        self.kv_pos_emb = nn.Parameter(torch.empty(kv_frames * resolution * resolution, ch))
        self.q_pos_emb = nn.Parameter(torch.empty(resolution * resolution, ch))
        self.q_proj = Dense(ch, ch, dtype=dtype)
        self.k_proj = Dense(ch, ch, dtype=dtype)
        self.v_proj = Dense(ch, ch, dtype=dtype)
        self.out_proj = Dense(ch, ch, dtype=dtype)

    def forward(self, z, addin):
        B, C, H, W = z.shape
        nh, hd = self.num_heads, C // self.num_heads
        kv = _tokens(self.kv_norm(addin))
        kv = kv + self.kv_pos_emb.to(kv.dtype)
        q = _tokens(self.q_norm(z))
        q = q + self.q_pos_emb.to(q.dtype)
        qh = self.q_proj(q).reshape(B, -1, nh, hd)
        kh = self.k_proj(kv).reshape(B, -1, nh, hd)
        vh = self.v_proj(kv).reshape(B, -1, nh, hd)
        s = torch.einsum("bqhd,bkhd->bhqk", qh, kh).float() * (hd ** -0.5)
        p = torch.softmax(s, dim=-1).to(qh.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", p, vh).reshape(B, -1, C)
        return F.silu(z + _image(self.out_proj(o), H, W))


class Encoder(nn.Module):
    """conv_in -> down blocks -> mid -> GN/silu/conv_out.  With
    `return_features`, also [post-conv_in, each down block, mid]."""

    def __init__(self, in_ch: int, out_ch: int, block_out_channels: Sequence[int],
                 layers_per_block: int, groups: int, dtype=torch.float32):
        super().__init__()
        chs = list(block_out_channels)
        self.conv_in = Conv(in_ch, chs[0], 3, padding=1, dtype=dtype)
        prev = chs[0]
        for i, ch in enumerate(chs):
            self.add_module(f"down_blocks_{i}", DownEncoderBlock(
                prev, ch, layers_per_block, i < len(chs) - 1, groups, dtype))
            prev = ch
        self.n_blocks = len(chs)
        self.mid_block = UNetMidBlock(prev, groups, dtype=dtype)
        self.conv_norm_out = GroupNorm(groups, prev, eps=1e-6, dtype=dtype)
        self.conv_out = Conv(prev, out_ch, 3, padding=1, dtype=dtype)

    def forward(self, x, return_features: bool = False):
        feats: List[torch.Tensor] = []
        x = self.conv_in(x)
        feats.append(x)
        for i in range(self.n_blocks):
            x = getattr(self, f"down_blocks_{i}")(x)
            feats.append(x)
        x = self.mid_block(x)
        feats.append(x)
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return (x, feats) if return_features else x


class Decoder(nn.Module):
    """conv_in -> mid -> up blocks -> GN/silu/conv_out.  With
    `return_features`, also [post-conv_in, mid, each up block]."""

    def __init__(self, in_ch: int, out_ch: int, block_out_channels: Sequence[int],
                 layers_per_block: int, groups: int, dtype=torch.float32):
        super().__init__()
        rev = list(reversed(block_out_channels))
        self.conv_in = Conv(in_ch, rev[0], 3, padding=1, dtype=dtype)
        self.mid_block = UNetMidBlock(rev[0], groups, dtype=dtype)
        prev = rev[0]
        for i, ch in enumerate(rev):
            self.add_module(f"up_blocks_{i}", UpDecoderBlock(
                prev, ch, layers_per_block + 1, i < len(rev) - 1, groups, dtype))
            prev = ch
        self.n_blocks = len(rev)
        self.conv_norm_out = GroupNorm(groups, prev, eps=1e-6, dtype=dtype)
        self.conv_out = Conv(prev, out_ch, 3, padding=1, dtype=dtype)

    def forward(self, z, return_features: bool = False):
        feats: List[torch.Tensor] = []
        x = self.conv_in(z)
        feats.append(x)
        x = self.mid_block(x)
        feats.append(x)
        for i in range(self.n_blocks):
            x = getattr(self, f"up_blocks_{i}")(x)
            feats.append(x)
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return (x, feats) if return_features else x


class ConditionalEncoder(nn.Module):
    """An Encoder whose down path cross-attends into the context encoder's
    features at resolutions <= max_att_resolution."""

    def __init__(self, in_ch: int, out_ch: int, block_out_channels: Sequence[int],
                 layers_per_block: int, groups: int, max_att_resolution: int,
                 init_resolution: int, dtype=torch.float32):
        super().__init__()
        chs = list(block_out_channels)
        self.conv_in = Conv(in_ch, chs[0], 3, padding=1, dtype=dtype)
        prev, res, att = chs[0], init_resolution, []
        for i, ch in enumerate(chs):
            final = i == len(chs) - 1
            self.add_module(f"down_blocks_{i}", DownEncoderBlock(
                prev, ch, layers_per_block, not final, groups, dtype))
            prev = ch
            if not final:
                res //= 2
            if res <= max_att_resolution:
                self.add_module(f"cross_att_blocks_{len(att)}",
                                CrossAttentionBlock2D(ch, res, groups=groups, dtype=dtype))
                att.append(i)
        self.att_after = att  # down-block indices followed by cross-attention
        self.n_blocks = len(chs)
        self.mid_block = UNetMidBlock(prev, groups, dtype=dtype)
        self.conv_norm_out = GroupNorm(groups, prev, eps=1e-6, dtype=dtype)
        self.conv_out = Conv(prev, out_ch, 3, padding=1, dtype=dtype)

    def forward(self, x, cond_features: List[torch.Tensor]):
        x = self.conv_in(x)
        for i in range(self.n_blocks):
            x = getattr(self, f"down_blocks_{i}")(x)
            if i in self.att_after:
                blk = getattr(self, f"cross_att_blocks_{self.att_after.index(i)}")
                x = blk(x, cond_features[i + 1])
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class ConditionalDecoder(nn.Module):
    """A Decoder whose up path cross-attends into the context decoder's
    features."""

    def __init__(self, in_ch: int, out_ch: int, block_out_channels: Sequence[int],
                 layers_per_block: int, groups: int, max_att_resolution: int,
                 init_resolution: int, dtype=torch.float32):
        super().__init__()
        rev = list(reversed(block_out_channels))
        self.conv_in = Conv(in_ch, rev[0], 3, padding=1, dtype=dtype)
        self.mid_block = UNetMidBlock(rev[0], groups, dtype=dtype)
        self.cross_att_blocks_0 = CrossAttentionBlock2D(rev[0], init_resolution, groups=groups,
                                                        dtype=dtype)
        prev, res, att = rev[0], init_resolution, []
        for i, ch in enumerate(rev):
            final = i == len(rev) - 1
            self.add_module(f"up_blocks_{i}", UpDecoderBlock(
                prev, ch, layers_per_block + 1, not final, groups, dtype))
            prev = ch
            if not final:
                res *= 2
            if res <= max_att_resolution:
                self.add_module(f"cross_att_blocks_{len(att) + 1}",
                                CrossAttentionBlock2D(ch, res, groups=groups, dtype=dtype))
                att.append(i)
        self.att_after = att  # up-block indices followed by cross-attention
        self.n_blocks = len(rev)
        self.conv_norm_out = GroupNorm(groups, prev, eps=1e-6, dtype=dtype)
        self.conv_out = Conv(prev, out_ch, 3, padding=1, dtype=dtype)

    def forward(self, z, cond_features: List[torch.Tensor]):
        x = self.mid_block(self.conv_in(z))
        x = self.cross_att_blocks_0(x, cond_features[1])
        for i in range(self.n_blocks):
            x = getattr(self, f"up_blocks_{i}")(x)
            if i in self.att_after:
                blk = getattr(self, f"cross_att_blocks_{self.att_after.index(i) + 1}")
                x = blk(x, cond_features[i + 2])
        return self.conv_out(F.silu(self.conv_norm_out(x)))
