"""The configuration the ported paths read.

The reference's `vla_rft_default_config()` (vla_rft_tpu/config.py) holds
the whole training run; the ported paths read only these fields of it, with
the same defaults: `PolicyConfig` for the serving path (eval/policy.py:80-84
and the policy half of models/factory.py), `WMRewardConfig` for the
world-model reward path (the WM/tokenizer/LPIPS half of
models/factory.py::build_models).  The rest comes with the slices that need
it.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    # actor_rollout_ref.model.num_images_in_input: camera views per request
    num_images_in_input: int = 1
    # processor.action_dim
    action_dim: int = 7
    # data.video.segment_length: the action chunk is segment_length - 1 long
    segment_length: int = 9


@dataclasses.dataclass(frozen=True)
class WMRewardConfig:
    # data.max_prompt_length / data.max_response_length: WM prompt and response
    max_prompt_length: int = 1095
    max_response_length: int = 568
    # data.video.segment_length: frames per sample; the WM predicts all but one
    segment_length: int = 9
    # world_model_rollout.world_model.vocab_size
    wm_vocab_size: int = 9008
    # processor.*
    visual_token_num: int = 4375
    action_bins: int = 256
    action_dim: int = 7
    tokens_per_frame: int = 64
    # world_model_rollout.rollout.* (val_kwargs, as is_validate is set)
    interact_max_tokens: int = 64
    temperature: float = 1.0
    top_k: int = -1
    top_p: float = 0.8
    do_sample: bool = True
    # the reference's WMRolloutConfig default; the yaml's 8 changes no result
    cache_segments: int = 4
    # trainer.reward_fn / loss_weight / msp_reward_*
    reward_fn: str = "mae"
    lpips_weight: float = 1.0
    recon_weight: float = 1.0
    msp_reward_aggregate: str = "mean"
    msp_reward_discount: float = 0.95
