"""Model factory for the policy: the VLM and the action expert.

Port of the policy half of vla_rft_tpu/models/factory.py:
* 'libero' — SigLIP-so400m + DINOv2-L + Qwen2.5-0.5B (bf16) and the DiT
  d8/h512 action expert (f32 params, bf16 compute);
* 'tiny'   — the same topology at test sizes, all f32.

`build_policy` makes the modules directly on the target device and fills
them with seeded random weights there (the convention of the reference's
`fast_random_params`: ones for norm scales and LayerScale gammas, zeros for
biases, N(0, 0.02) for everything else), so nothing is read from disk.
Trained weights come in through `convert.flax_to_torch` + `load_state_dict`.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from vla_rft_tpu_torch import resolve_device
from vla_rft_tpu_torch.config import PolicyConfig
from vla_rft_tpu_torch.models.action_head import ActionExpert, ActionHeadConfig
from vla_rft_tpu_torch.models.layers import LayerNorm
from vla_rft_tpu_torch.models.prismatic import OpenVLA, OpenVLAConfig
from vla_rft_tpu_torch.models.transformer import RMSNorm

PRESETS = ("libero", "tiny")


@dataclasses.dataclass
class PolicyBundle:
    vla: OpenVLA
    expert: ActionExpert
    vla_cfg: OpenVLAConfig
    expert_cfg: ActionHeadConfig
    policy_seq_len: int
    policy_image_size: int


def policy_configs(preset: str = "libero", config: PolicyConfig = PolicyConfig()):
    """(OpenVLAConfig, ActionHeadConfig, policy_seq_len, image_size) of a preset."""
    num_images, action_dim = config.num_images_in_input, config.action_dim
    if preset == "tiny":
        vla_cfg = OpenVLAConfig.tiny_test()
        if num_images != 1:
            vla_cfg = dataclasses.replace(vla_cfg, num_images=num_images)
        expert_cfg = ActionHeadConfig(
            llm_dim=vla_cfg.llm.hidden_size, dit_hidden=32, dit_depth=2, dit_heads=4,
            action_dim=action_dim, dtype=torch.float32,
            num_actions_chunk=config.segment_length - 1, proprio_dim=vla_cfg.proprio_dim,
        )
        return vla_cfg, expert_cfg, 32, vla_cfg.siglip.image_size
    if preset == "libero":
        vla_cfg = OpenVLAConfig(num_images=num_images)
        expert_cfg = ActionHeadConfig(
            llm_dim=vla_cfg.llm.hidden_size, action_dim=action_dim,
            proprio_dim=vla_cfg.proprio_dim,
        )
        return vla_cfg, expert_cfg, 96, 224
    raise ValueError(f"unknown preset {preset!r}; expected one of {PRESETS}")


@torch.no_grad()
def init_random_(module: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random init in place, on the module's own device."""
    dev = next(module.parameters()).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for name, p in module.named_parameters():
        owner = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(owner, (LayerNorm, RMSNorm)) and leaf == "weight":
            p.fill_(1.0)
        elif "gamma" in leaf:
            p.fill_(1.0)
        elif leaf == "bias":
            p.zero_()
        else:
            r = torch.randn(p.shape, generator=gen, device=dev, dtype=torch.float32)
            p.copy_(r * 0.02)
    return module


def build_policy(preset: str = "libero", config: PolicyConfig = PolicyConfig(), *,
                 device="cuda", seed: int = 0) -> PolicyBundle:
    """The policy (VLM + action expert) in eval mode on `device`."""
    dev = resolve_device(device)
    vla_cfg, expert_cfg, seq_len, image_size = policy_configs(preset, config)
    with torch.device(dev):
        vla = OpenVLA(vla_cfg)
        expert = ActionExpert(expert_cfg)
    init_random_(vla, seed)
    init_random_(expert, seed + 1)
    return PolicyBundle(
        vla=vla.eval().requires_grad_(False),
        expert=expert.eval().requires_grad_(False),
        vla_cfg=vla_cfg,
        expert_cfg=expert_cfg,
        policy_seq_len=seq_len,
        policy_image_size=image_size,
    )
