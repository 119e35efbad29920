"""OpenVLA / Prismatic VLM (the policy's context encoder).

Port of vla_rft_tpu/models/prismatic.py: the fused DINOv2 + SigLIP backbone
over a channel-stacked 6-channel image, the 3-layer GELU projector, and
`OpenVLA.encode_context`: action-token embeddings replaced by learned
action queries, vision patches spliced in after BOS, one causal forward of
the Qwen backbone, and the context [BOS + patches (the last patch dropped,
as the reference does) | action-token hidden states]; and
`OpenVLA.lm_forward`, the pretraining stages' caption logits.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from vla_rft_tpu_torch.models.action_masks import (
    NUM_TOKENS,
    gather_masked,
    get_current_action_mask,
    get_next_actions_mask,
    scatter_rows,
)
from vla_rft_tpu_torch.models.layers import Dense, Embed
from vla_rft_tpu_torch.models.transformer import Decoder, TransformerConfig
from vla_rft_tpu_torch.models.vit import ViT, ViTConfig, normalize_images


@dataclasses.dataclass(frozen=True)
class OpenVLAConfig:
    siglip: ViTConfig = ViTConfig.siglip_so400m()
    dino: ViTConfig = ViTConfig.dinov2_large_reg4()
    llm: TransformerConfig = TransformerConfig.qwen25_0_5b()
    num_patches: int = 256  # per image
    num_tokens: int = NUM_TOKENS
    proprio_dim: int = 8
    num_images: int = 1

    @property
    def vision_dim(self) -> int:
        return self.dino.hidden_size + self.siglip.hidden_size

    @property
    def total_patches(self) -> int:
        return self.num_patches * self.num_images

    @staticmethod
    def tiny_test() -> "OpenVLAConfig":
        """Miniature config for CPU tests (same topology, tiny dims)."""
        f32 = dict(dtype=torch.float32, param_dtype=torch.float32)
        return OpenVLAConfig(
            siglip=ViTConfig.siglip_so400m(
                image_size=28, patch_size=14, hidden_size=16, depth=3, num_heads=2,
                mlp_dim=32, **f32,
            ),
            dino=ViTConfig.dinov2_large_reg4(
                image_size=28, patch_size=14, hidden_size=16, depth=3, num_heads=2,
                mlp_dim=32, **f32,
            ),
            llm=TransformerConfig(
                vocab_size=152000, hidden_size=32, intermediate_size=64,
                num_layers=2, num_heads=4, num_kv_heads=2, qkv_bias=True,
                tie_word_embeddings=True, **f32,
            ),
            num_patches=4,
            num_tokens=8,
        )


class PrismaticVisionBackbone(nn.Module):
    def __init__(self, cfg: OpenVLAConfig):
        super().__init__()
        self.cfg = cfg
        self.featurizer = ViT(cfg.dino)
        self.fused_featurizer = ViT(cfg.siglip)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values (B, H, W, 6*num_images) in [0,1], image i in channels
        [6i, 6i+6) as a dino|siglip stack -> (B, num_images*P, vision_dim).
        The images fold into the batch so each tower runs once."""
        N = self.cfg.num_images
        if N > 1:
            B, H, W, _ = pixel_values.shape
            pixel_values = (
                pixel_values.reshape(B, H, W, N, 6).movedim(3, 1).reshape(B * N, H, W, 6)
            )
        p_d = self.featurizer(normalize_images(pixel_values[..., 0:3], self.cfg.dino))
        p_s = self.fused_featurizer(normalize_images(pixel_values[..., 3:6], self.cfg.siglip))
        patches = torch.cat([p_d, p_s], dim=-1)
        if N > 1:
            patches = patches.reshape(B, N * patches.shape[1], patches.shape[-1])
        return patches


class PrismaticProjector(nn.Module):
    def __init__(self, cfg: OpenVLAConfig):
        super().__init__()
        llm, vd = cfg.llm, cfg.vision_dim
        kw = dict(dtype=llm.dtype, param_dtype=llm.param_dtype)
        self.fc1 = Dense(vd, 4 * vd, **kw)
        self.fc2 = Dense(4 * vd, llm.hidden_size, **kw)
        self.fc3 = Dense(llm.hidden_size, llm.hidden_size, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc3(F.gelu(self.fc2(F.gelu(self.fc1(x)))))


class OpenVLA(nn.Module):
    def __init__(self, cfg: OpenVLAConfig):
        super().__init__()
        self.cfg = cfg
        self.vision_backbone = PrismaticVisionBackbone(cfg)
        self.projector = PrismaticProjector(cfg)
        self.language_model = Decoder(cfg.llm)
        self.action_queries = Embed(
            cfg.num_tokens, cfg.llm.hidden_size, param_dtype=cfg.llm.param_dtype
        )

    def forward(self, input_ids, pixel_values, labels, attention_mask):
        return self.encode_context(input_ids, pixel_values, labels, attention_mask)

    def encode_context(
        self,
        input_ids: torch.Tensor,  # (B, S) right-padded
        pixel_values: torch.Tensor,  # (B, H, W, 6*num_images) in [0,1]
        labels: torch.Tensor,  # (B, S) with IGNORE_INDEX
        attention_mask: torch.Tensor,  # (B, S) right-padded 1/0
    ) -> torch.Tensor:
        """One multimodal forward -> (B, total_patches + num_tokens, llm_dim):
        [BOS + patch hiddens | action-query hiddens], the DiT's context."""
        cfg = self.cfg
        B, S = input_ids.shape
        P = cfg.total_patches
        lm = self.language_model

        tok_emb = lm(input_ids, embed_only=True)
        all_actions = get_current_action_mask(labels) | get_next_actions_mask(labels)
        queries = self.action_queries.weight[None].expand(B, cfg.num_tokens, -1)
        _, idx = gather_masked(tok_emb, all_actions, cfg.num_tokens)
        tok_emb = scatter_rows(tok_emb, idx, queries)

        patches = self.projector(self.vision_backbone(pixel_values))
        mm_emb = torch.cat(
            [tok_emb[:, :1], patches.to(tok_emb.dtype), tok_emb[:, 1:]], dim=1
        )
        kv_lens = attention_mask.sum(dim=-1).to(torch.int32) + P
        _, hidden = lm(inputs_embeds=mm_emb, kv_lens=kv_lens, compute_logits=False)

        text_hidden = hidden[:, P:-1]  # (B, S-1, D)
        shifted = labels[:, 1:]
        act_mask = get_current_action_mask(shifted) | get_next_actions_mask(shifted)
        act_hidden, _ = gather_masked(text_hidden, act_mask, cfg.num_tokens)
        task_latent = hidden[:, :P]  # BOS + patches, the last patch dropped
        return torch.cat([task_latent, act_hidden], dim=1)

    def lm_forward(
        self,
        input_ids: torch.Tensor,  # (B, S) right-padded caption tokens
        pixel_values: torch.Tensor,  # (B, H, W, 6*num_images) in [0,1]
        attention_mask: torch.Tensor,  # (B, S)
    ) -> torch.Tensor:
        """The pretraining stages' language-model forward (caption
        next-token loss with the vision patches after BOS; no action-query
        substitution) -> f32 logits over the text positions, (B, S, V):
        logits[:, i] predicts input_ids[:, i+1].  The head runs on the S
        text positions only, which gives the reference's values without its
        (B, P, V) slab over the patches."""
        P = self.cfg.total_patches
        lm = self.language_model
        tok_emb = lm(input_ids, embed_only=True)
        patches = self.projector(self.vision_backbone(pixel_values))
        mm_emb = torch.cat(
            [tok_emb[:, :1], patches.to(tok_emb.dtype), tok_emb[:, 1:]], dim=1
        )
        kv_lens = attention_mask.sum(dim=-1).to(torch.int32) + P
        _, hidden = lm(inputs_embeds=mm_emb, kv_lens=kv_lens, compute_logits=False)
        # text positions: BOS at 0, then the patches, then input_ids[1:]
        return lm.logits(torch.cat([hidden[:, :1], hidden[:, P + 1:]], dim=1))
