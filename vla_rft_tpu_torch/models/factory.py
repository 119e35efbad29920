"""Model factory: the policy, the world-model reward models, a lone decoder.

Port of vla_rft_tpu/models/factory.py:
* `build_policy`, preset 'libero': SigLIP-so400m + DINOv2-L + Qwen2.5-0.5B
  (bf16) and the DiT d8/h512 action expert (f32 params, bf16 compute);
  frozen for serving, or trainable for the SFT trainers;
* `build_wm_reward`, preset 'libero': the 24-layer WM (`wm_llama`, bf16,
  int8 KV cache), the compressive tokenizer at 256 px and VGG16 LPIPS (f32
  params, bf16 compute);
* `build_decoder`: one trainable `Decoder` of a given config (the WM's
  `wm_llama` for next-token SFT);
* `build_models`: everything the GRPO trainer runs, from the config tree
  (the reference's `build_models`): the policy with a trainable action
  expert, and the WM, tokenizer and LPIPS, frozen;
* preset 'tiny': the same topologies at test sizes, all f32;
* preset 'push': the sizes of the MuJoCo push-env pipeline
  (tools/rft_evidence.py, whose trained weights are in
  artifacts/rft_evidence32/): 64 px views with 8 px patches, ViTs 64 wide x
  3 deep, a Qwen stand-in 128 wide x 3 layers with 4 / 2 heads of 32, a DiT
  64 / 3 / 4, a WM 128 / 512 / 4 layers / 2 heads, a tokenizer of
  (16, 32, 32) channels with a 4 x 4 dyn grid, all f32.

Every preset builds on either device.  On the card 'push' runs the f32
instances of the kernels (the flash kernels #1-#3 at head dims 32 and 64,
the decode kernels #4 / #5 over its f32 cache); 'tiny' builds there too,
but its WM's heads of 16 and its policy LLM's of 8 are outside every
instance (ops/attention.py's F32_HEAD_DIMS, the decode kernels' D = 64), so
its attention raises on a CUDA device and it runs on the CPU.

Both make the modules directly on the target device and fill them with
seeded random weights there (the convention of the reference's
`fast_random_params`: ones for norm scales and LayerScale gammas, zeros for
biases, N(0, 0.02) for everything else), so nothing is read from disk.
Trained weights come in through `convert.flax_to_torch` + `load_state_dict`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from vla_rft_tpu_torch import resolve_device
from vla_rft_tpu_torch.config import Config, PolicyConfig, WMRewardConfig
from vla_rft_tpu_torch.models.action_head import ActionExpert, ActionHeadConfig
from vla_rft_tpu_torch.models.layers import GroupNorm, LayerNorm
from vla_rft_tpu_torch.models.lpips import LPIPS
from vla_rft_tpu_torch.models.prismatic import OpenVLA, OpenVLAConfig
from vla_rft_tpu_torch.models.tokenizers import CompressiveVQModelFSQ, TokenizerConfig
from vla_rft_tpu_torch.models.transformer import Decoder, RMSNorm, TransformerConfig
from vla_rft_tpu_torch.models.vit import ViTConfig
from vla_rft_tpu_torch.workers.processor import ProcessorConfig
from vla_rft_tpu_torch.workers.reward import RewardConfig
from vla_rft_tpu_torch.workers.wm_rollout import WMRolloutConfig

PRESETS = ("libero", "tiny", "push")


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
    if preset == "push":
        f32 = dict(dtype=torch.float32, param_dtype=torch.float32)
        vit = dict(image_size=64, patch_size=8, hidden_size=64, depth=3, num_heads=4,
                   mlp_dim=128, **f32)
        vla_cfg = OpenVLAConfig(
            siglip=ViTConfig.siglip_so400m(**vit),
            dino=ViTConfig.dinov2_large_reg4(**vit),
            llm=TransformerConfig(
                vocab_size=152000, hidden_size=128, intermediate_size=256, num_layers=3,
                num_heads=4, num_kv_heads=2, qkv_bias=True, tie_word_embeddings=True, **f32,
            ),
            num_patches=64, num_tokens=8, num_images=num_images,
        )
        expert_cfg = ActionHeadConfig(
            llm_dim=vla_cfg.llm.hidden_size, dit_hidden=64, dit_depth=3, dit_heads=4,
            action_dim=action_dim, dtype=torch.float32,
            num_actions_chunk=config.segment_length - 1, proprio_dim=vla_cfg.proprio_dim,
        )
        return vla_cfg, expert_cfg, 32, 64
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
        if isinstance(owner, (LayerNorm, RMSNorm, GroupNorm)) and leaf == "weight":
            p.fill_(1.0)
        elif "gamma" in leaf:
            p.fill_(1.0)
        elif leaf == "bias":
            p.zero_()
        else:
            r = torch.randn(p.shape, generator=gen, device=dev, dtype=torch.float32)
            p.copy_(r * 0.02)
    return module


def _mode(module: nn.Module, trainable: bool) -> nn.Module:
    """train() with gradients on, or eval() and frozen."""
    return module.train(trainable).requires_grad_(trainable)


def build_policy(preset: str = "libero", config: PolicyConfig = PolicyConfig(), *,
                 device="cuda", seed: int = 0, trainable: bool = False) -> PolicyBundle:
    """The policy (VLM + action expert) on `device`: in eval mode and frozen
    (serving, rollouts), or with `trainable` in train mode with every
    parameter requiring grad (the SFT trainers freeze by leaving parameters
    out of the update, as the reference's optax labels do)."""
    dev = resolve_device(device)
    vla_cfg, expert_cfg, seq_len, image_size = policy_configs(preset, config)
    with torch.device(dev):
        vla = OpenVLA(vla_cfg)
        expert = ActionExpert(expert_cfg)
    init_random_(vla, seed)
    init_random_(expert, seed + 1)
    return PolicyBundle(
        vla=_mode(vla, trainable),
        expert=_mode(expert, trainable),
        vla_cfg=vla_cfg,
        expert_cfg=expert_cfg,
        policy_seq_len=seq_len,
        policy_image_size=image_size,
    )


def build_decoder(cfg: TransformerConfig, *, device="cuda", seed: int = 0) -> Decoder:
    """One trainable `Decoder` of config `cfg` on `device` with seeded random
    weights (the reference's `SFTTrainer` builds its LLM this way)."""
    dev = resolve_device(device)
    with torch.device(dev):
        dec = Decoder(cfg)
    return _mode(init_random_(dec, seed), True)


@dataclasses.dataclass
class WMRewardBundle:
    wm: Decoder
    tokenizer: CompressiveVQModelFSQ
    lpips: LPIPS
    wm_cfg: TransformerConfig
    proc_cfg: ProcessorConfig
    roll_cfg: WMRolloutConfig
    reward_cfg: RewardConfig
    image_size: int  # the tokenizer's frame size
    num_raw_frames: int  # data.video.segment_length


# the tiny preset's data shapes: a 64-token ctx grid and 4 dyn tokens per
# frame (the overrides the reference's tiny CLI run uses)
TINY_WM_DATA = dict(tokens_per_frame=4, interact_max_tokens=4, max_prompt_length=64 + 4 + 7,
                    max_response_length=8 * (4 + 7))


def wm_reward_configs(preset: str = "libero", config: WMRewardConfig = WMRewardConfig(),
                      tiny_data: bool = True):
    """(TransformerConfig, TokenizerConfig, ProcessorConfig, WMRolloutConfig,
    RewardConfig, image size, LPIPS compute dtype) of a preset.  The tiny
    preset takes TINY_WM_DATA's token shapes unless `tiny_data` is False
    (the trainer, whose config sets them).  The WM's KV cache takes
    `config.kv_layout` in both presets (the reference reads the key at
    libero, factory.py:235-237; its tiny WM, 4 heads of 16, falls back to
    the 'heads' layout for the TPU's 128 lanes, a rule the port does not
    have)."""
    if preset == "tiny":
        if tiny_data:
            config = dataclasses.replace(config, **TINY_WM_DATA)
        wm_cfg = TransformerConfig(
            vocab_size=config.wm_vocab_size, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=4, dtype=torch.float32,
            param_dtype=torch.float32, kv_layout=config.kv_layout,
        )
        tok_cfg = TokenizerConfig(
            block_out_channels=(8, 16, 16), layers_per_block=1, latent_channels=4,
            norm_num_groups=4, resolution=32, ctx_res=(8, 8), dyn_res=(2, 2),
            max_att_resolution=8,
        )
        image_size, lpips_dtype = 32, torch.float32
    elif preset == "push":
        wm_cfg = TransformerConfig(
            vocab_size=config.wm_vocab_size, hidden_size=128, intermediate_size=512,
            num_layers=4, num_heads=2, num_kv_heads=2, dtype=torch.float32,
            param_dtype=torch.float32, kv_layout=config.kv_layout,
        )
        tok_cfg = TokenizerConfig(
            block_out_channels=(16, 32, 32), layers_per_block=1, latent_channels=4,
            norm_num_groups=4, resolution=32, ctx_res=(8, 8), dyn_res=(4, 4), patch_size=2,
            max_att_resolution=8,
        )
        image_size, lpips_dtype = 32, torch.float32
    elif preset == "libero":
        wm_cfg = TransformerConfig.wm_llama(vocab_size=config.wm_vocab_size,
                                            kv_cache_dtype="int8", kv_layout=config.kv_layout)
        tok_cfg = TokenizerConfig(dtype=torch.bfloat16)
        image_size, lpips_dtype = 256, torch.bfloat16
    else:
        raise ValueError(f"unknown preset {preset!r}; expected one of {PRESETS}")
    proc_cfg = ProcessorConfig(
        visual_token_num=config.visual_token_num, action_bins=config.action_bins,
        action_dim=config.action_dim, tokens_per_frame=config.tokens_per_frame,
    )
    num_frames = config.segment_length - 1
    roll_cfg = WMRolloutConfig(
        prompt_length=config.max_prompt_length, response_length=config.max_response_length,
        num_frames=num_frames, interact_max_tokens=config.interact_max_tokens,
        action_dim=config.action_dim, temperature=config.temperature, top_k=config.top_k,
        top_p=config.top_p, do_sample=config.do_sample, cache_segments=config.cache_segments,
        speculative_k=config.speculative_k,
    )
    reward_cfg = RewardConfig(
        reward_fn=config.reward_fn, lpips_weight=config.lpips_weight,
        recon_weight=config.recon_weight, msp_reward_aggregate=config.msp_reward_aggregate,
        msp_reward_discount=config.msp_reward_discount, num_frames=num_frames,
    )
    return wm_cfg, tok_cfg, proc_cfg, roll_cfg, reward_cfg, image_size, lpips_dtype


def build_wm_reward(preset: str = "libero", config: WMRewardConfig = WMRewardConfig(), *,
                    device="cuda", seed: int = 0, tiny_data: bool = True,
                    wm_overrides: Optional[dict] = None) -> WMRewardBundle:
    """The WM, the tokenizer and LPIPS in eval mode on `device`, with their
    configurations; `wm_overrides` replaces fields of the WM's config."""
    dev = resolve_device(device)
    wm_cfg, tok_cfg, proc_cfg, roll_cfg, reward_cfg, image_size, lpips_dtype = (
        wm_reward_configs(preset, config, tiny_data))
    if wm_overrides:
        wm_cfg = dataclasses.replace(wm_cfg, **wm_overrides)
    with torch.device(dev):
        wm = Decoder(wm_cfg)
        tokenizer = CompressiveVQModelFSQ(tok_cfg)
        lpips = LPIPS(lpips_dtype)
    for i, m in enumerate((wm, tokenizer, lpips)):
        init_random_(m, seed + i)
    return WMRewardBundle(
        wm=_mode(wm, False),
        tokenizer=_mode(tokenizer, False),
        lpips=_mode(lpips, False),
        wm_cfg=wm_cfg, proc_cfg=proc_cfg, roll_cfg=roll_cfg, reward_cfg=reward_cfg,
        image_size=image_size, num_raw_frames=config.segment_length,
    )


@dataclasses.dataclass
class ModelBundle:
    """Every module of a GRPO step with its configuration: the fields of
    PolicyBundle and WMRewardBundle."""
    vla: OpenVLA
    expert: ActionExpert
    wm: Decoder
    tokenizer: CompressiveVQModelFSQ
    lpips: LPIPS
    vla_cfg: OpenVLAConfig
    expert_cfg: ActionHeadConfig
    wm_cfg: TransformerConfig
    proc_cfg: ProcessorConfig
    roll_cfg: WMRolloutConfig
    reward_cfg: RewardConfig
    policy_seq_len: int
    policy_image_size: int
    image_size: int  # the tokenizer's frame size
    num_raw_frames: int


def build_models(config: Config, preset: str = "libero", *, device="cuda",
                 seed: int = 0) -> ModelBundle:
    """The GRPO trainer's modules from the config tree, on `device`, with
    seeded random weights: the VLM frozen, the action expert trainable (the
    libero and push experts take rollout.num_flow_steps; the tiny one keeps
    10, as in the reference), the WM (with world_model_rollout.model.size_overrides
    and rollout.kv_layout), tokenizer and LPIPS frozen."""
    policy = build_policy(preset, PolicyConfig.from_config(config), device=device, seed=seed)
    if preset in ("libero", "push"):
        k = int(config.actor_rollout_ref.rollout.get("num_flow_steps", 10))
        policy.expert_cfg = dataclasses.replace(policy.expert_cfg, num_flow_steps=k)
    overrides = config.world_model_rollout.model.get("size_overrides", None)
    overrides = {k: int(v) for k, v in (overrides.to_dict() if overrides else {}).items()
                 if v is not None}
    wm = build_wm_reward(preset, WMRewardConfig.from_config(config), device=device,
                         seed=seed + 2, tiny_data=False, wm_overrides=overrides)
    return ModelBundle(
        vla=policy.vla, expert=_mode(policy.expert, True), wm=wm.wm, tokenizer=wm.tokenizer,
        lpips=wm.lpips, vla_cfg=policy.vla_cfg, expert_cfg=policy.expert_cfg, wm_cfg=wm.wm_cfg,
        proc_cfg=wm.proc_cfg, roll_cfg=wm.roll_cfg,
        reward_cfg=wm.reward_cfg, policy_seq_len=policy.policy_seq_len,
        policy_image_size=policy.policy_image_size, image_size=wm.image_size,
        num_raw_frames=wm.num_raw_frames,
    )
