"""The context-compressive visual tokenizer (CompressiveVQModelFSQ, 'ctx_cnn').

Port of vla_rft_tpu/models/tokenizers.py.  The context frame goes through
Encoder -> 1x1 conv -> FSQ at the ctx grid (32x32 = 1024 tokens at 256 px);
each future frame goes through the ConditionalEncoder (cross-attending the
context features) -> 4x4 patchify -> linear -> FSQ at the dyn grid (8x8 = 64
tokens).  Decoding mirrors it.

Public functions take and return the reference's layouts: pixels
(B, T, H, W, C) channels-last, tokens (B, 1, Nc) and (B, T, Nd).  The
decoder feature pyramid that `ctx_decode` returns and `detokenize_dyn`
takes is a list of NCHW tensors (the reference's are NHWC); only its batch
axis is ever indexed outside this module.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch
from torch import nn

from vla_rft_tpu_torch.models.fsq import FSQ, get_fsq_levels
from vla_rft_tpu_torch.models.layers import Conv, Dense
from vla_rft_tpu_torch.models.vae import ConditionalDecoder, ConditionalEncoder, Decoder, Encoder


def _patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, (H/p)*(W/p), p*p*C), features laid out [p, p, C]
    per patch, patches row-major (the reference's order)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // p) * (W // p), p * p * C)


def _depatchify(x: torch.Tensor, h: int, w: int, p: int, c: int) -> torch.Tensor:
    """Inverse of _patchify: (B, L, p*p*c) -> (B, h, w, c)."""
    B = x.shape[0]
    x = x.reshape(B, h // p, w // p, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, h, w, c)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


@dataclasses.dataclass(frozen=True)
class TokenizerConfig:
    """The reference module's fields (defaults: the libero tokenizer)."""

    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    vq_fsq_levels: int = 12
    dyn_fsq_levels: int = 12
    patch_size: int = 4
    resolution: int = 256
    max_att_resolution: int = 32
    ctx_res: Tuple[int, int] = (32, 32)
    dyn_res: Tuple[int, int] = (8, 8)
    norm_num_groups: int = 32
    dtype: torch.dtype = torch.float32


class CompressiveVQModelFSQ(nn.Module):
    def __init__(self, cfg: TokenizerConfig = TokenizerConfig()):
        super().__init__()
        self.cfg = cfg
        v_levels = get_fsq_levels(cfg.vq_fsq_levels)
        d_levels = get_fsq_levels(cfg.dyn_fsq_levels)
        self.quantize = FSQ(v_levels)
        self.dynamics_quantize = FSQ(d_levels)
        ch, lat, g, dt = cfg.block_out_channels, cfg.latent_channels, cfg.norm_num_groups, cfg.dtype
        lpb = cfg.layers_per_block
        self.encoder = Encoder(3, lat, ch, lpb, g, dtype=dt)
        self.cond_encoder = ConditionalEncoder(3, lat, ch, lpb, g, cfg.max_att_resolution,
                                               cfg.resolution, dtype=dt)
        self.decoder = Decoder(lat, 3, ch, lpb, g, dtype=dt)
        self.cond_decoder = ConditionalDecoder(lat, 3, ch, lpb, g, cfg.max_att_resolution,
                                               cfg.ctx_res[0], dtype=dt)
        self.quant_conv = Conv(lat, len(v_levels), 1, dtype=dt)
        self.post_quant_conv = Conv(len(v_levels), lat, 1, dtype=dt)
        p2c = lat * cfg.patch_size * cfg.patch_size
        self.quant_linear = Dense(p2c, len(d_levels), dtype=dt)
        self.post_quant_linear = Dense(len(d_levels), p2c, dtype=dt)

    @staticmethod
    def _repeat_feats(feats: Sequence[torch.Tensor], reps: int) -> List[torch.Tensor]:
        """Each context's features repeated for its `reps` future frames."""
        return [f.repeat_interleave(reps, dim=0) for f in feats]

    def tokenize(self, pixel_values: torch.Tensor):
        """(B, T, H, W, C) float -> (indices_c (B, 1, Nc), indices_d (B, T-1, Nd)),
        int32, context_length 1."""
        B, T = pixel_values.shape[:2]
        ctx = _nchw(pixel_values[:, 0])
        fut = _nchw(pixel_values[:, 1:].reshape(B * (T - 1), *pixel_values.shape[2:]))
        h, cond_feats = self.encoder(ctx, return_features=True)
        h = self.quant_conv(h)
        d = self.cond_encoder(fut, self._repeat_feats(cond_feats, T - 1))
        d = self.quant_linear(_patchify(_nhwc(d), self.cfg.patch_size))
        _, info = self.quantize(_nhwc(h))
        _, info_d = self.dynamics_quantize(d)
        return info.reshape(B, 1, -1), info_d.reshape(B, T - 1, -1)

    def ctx_decode(self, indices_c: torch.Tensor):
        """(B, 1, Nc) ctx tokens -> (decoded ctx frame (B, H, W, 3), the
        decoder feature pyramid [NCHW])."""
        B = indices_c.shape[0]
        ch, cw = self.cfg.ctx_res
        quant = self.quantize.indices_to_codes(indices_c.reshape(B, -1))
        quant = _nchw(quant.reshape(B, ch, cw, -1).to(self.cfg.dtype))
        frame, feats = self.decoder(self.post_quant_conv(quant), return_features=True)
        return _nhwc(frame), feats

    def detokenize_dyn(self, indices_d: torch.Tensor, cond_feats) -> torch.Tensor:
        """(B, T, Nd) dynamics tokens + per-sequence ctx features ->
        future-frame pixels (B, T, H, W, 3)."""
        B, T = indices_d.shape[:2]
        cfg = self.cfg
        quant_d = self.dynamics_quantize.indices_to_codes(indices_d.reshape(B * T, -1))
        quant2_d = self.post_quant_linear(quant_d.to(cfg.dtype))
        quant2_d = _depatchify(quant2_d, cfg.ctx_res[0], cfg.ctx_res[1], cfg.patch_size,
                               cfg.latent_channels)
        dec = _nhwc(self.cond_decoder(_nchw(quant2_d), self._repeat_feats(cond_feats, T)))
        return dec.reshape(B, T, *dec.shape[1:])

    def detokenize(self, indices_c: torch.Tensor, indices_d: torch.Tensor) -> torch.Tensor:
        """(B, 1, Nc), (B, T, Nd) -> pixels (B, T+1, H, W, 3), frame 0 the
        decoded context."""
        context_dec, cond_feats = self.ctx_decode(indices_c)
        dec = self.detokenize_dyn(indices_d, cond_feats)
        return torch.cat([context_dec[:, None], dec], dim=1)
