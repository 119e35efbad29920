"""The configuration the ported paths read.

* `Config`, `_parse_value` and `vla_rft_default_config()` are the
  reference's dependency-free config tree (vla_rft_tpu/config.py: nested
  dict with attribute access and hydra-style dotted overrides), copied so
  that the port's CLIs (trainer/main_sft.py) take the same overrides with
  the same defaults.
* `PolicyConfig` holds the fields the serving path reads
  (eval/policy.py:80-84 and the policy half of models/factory.py) and
  `WMRewardConfig` those of the world-model reward path (the
  WM/tokenizer/LPIPS half of models/factory.py::build_models), with the
  same defaults as the tree.
"""
from __future__ import annotations

import copy
import dataclasses
import json
from typing import Any, Dict, List, Optional


class Config:
    """Attribute-accessible nested dict with dotted get/set and yaml IO."""

    def __init__(self, d: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_d", {})
        for k, v in (d or {}).items():
            self._d[k] = Config(v) if isinstance(v, dict) else v

    # -- mapping / attribute access ------------------------------------------
    def __getattr__(self, k):
        try:
            return object.__getattribute__(self, "_d")[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self._d[k] = Config(v) if isinstance(v, dict) else v

    def __getitem__(self, k):
        return self._d[k]

    def __setitem__(self, k, v):
        self.__setattr__(k, v)

    def __contains__(self, k):
        return k in self._d

    def get(self, k, default=None):
        return self._d.get(k, default)

    def keys(self):
        return self._d.keys()

    def items(self):
        return self._d.items()

    def to_dict(self) -> Dict[str, Any]:
        return {
            k: (v.to_dict() if isinstance(v, Config) else v) for k, v in self._d.items()
        }

    def __repr__(self):
        return f"Config({json.dumps(self.to_dict(), default=str, indent=1)})"

    def copy(self) -> "Config":
        return Config(copy.deepcopy(self.to_dict()))

    # -- dotted-path ops ------------------------------------------------------
    def set_path(self, path: str, value: Any) -> None:
        parts = path.split(".")
        node = self
        for p in parts[:-1]:
            if p not in node._d or not isinstance(node._d[p], Config):
                node._d[p] = Config()
            node = node._d[p]
        node._d[parts[-1]] = Config(value) if isinstance(value, dict) else value

    def get_path(self, path: str, default=None):
        node = self
        for p in path.split("."):
            if isinstance(node, Config) and p in node._d:
                node = node._d[p]
            else:
                return default
        return node

    def apply_overrides(self, overrides: List[str]) -> "Config":
        """Apply `a.b.c=value` hydra-style overrides (values parsed as python/json)."""
        for ov in overrides:
            path, _, raw = ov.partition("=")
            self.set_path(path.strip(), _parse_value(raw.strip()))
        return self

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        import yaml

        with open(path) as f:
            return cls(yaml.safe_load(f))


def _parse_value(raw: str) -> Any:
    low = raw.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none", "~"):
        return None
    for cast in (int, float):
        try:
            return cast(raw)
        except ValueError:
            pass
    if raw.startswith("[") or raw.startswith("{"):
        try:
            return json.loads(raw.replace("'", '"'))
        except json.JSONDecodeError:
            pass
    return raw.strip("'\"")


def vla_rft_default_config() -> Config:
    """Defaults mirroring vla_rft_grpo_trainer.yaml + run_vla_rft.sh overrides
    for the LIBERO ctx_msp run."""
    return Config(
        {
            "data": {
                "train_batch_size": 16,
                "val_batch_size": 4,
                "shuffle_buffer_size": 100_000,
                # held-out validation data: fraction of shards (episodes when
                # single-shard) consumed by trainer.validate() — the
                # reference's val dataloader (ray_trainer.py:1157-1214)
                "val_fraction": 0.0,
                "image_aug": True,
                "use_raw_image": True,
                "max_prompt_length": 1095,
                "max_response_length": 568,
                "video": {
                    "no_aug": False,
                    "segment_length": 9,
                    "dataset_name": "libero_spatial_no_noops",
                    "dataset_path": None,
                    "resolution": [224, 224],
                },
            },
            "processor": {
                # ctx_msp LIBERO token space (run_vla_rft.sh:56,73-77;
                # ivideogpt/processor.py:191-203)
                "use_img_gt_ac": True,
                "interact": True,
                "tokenizer": {"name": "ctx_cnn", "path": None},
                # 8-seq reward chunks: 16 OOMs at train_batch_size 4/chip
                # (VGG+cond-decoder pyramids alongside resident params)
                "tokenizer_micro_batch_size": 8,
                "context_length": 1,
                "action_dim": 7,
                "action_bins": 256,
                "action_ranges_path": None,
                # VGG16 features (+ optional taming lin heads) for the LPIPS
                # reward term (reference downloads them in ivideogpt/lpips.py)
                "lpips_path": None,
                "max_length": 1663,
                "visual_token_num": 4375,
                "bos_token_id": 9006,
                "eos_token_id": 9007,
                "pad_token_id": 9007,
                "gen_output_length": 568,
                "gen_input_length": 1095,
                "tokens_per_frame": 64,
                "processor_type": "ctx_msp",
            },
            "actor_rollout_ref": {
                "hybrid_engine": True,
                "model": {
                    "ckpt_path": None,
                    "cfg_path": None,
                    "enable_gradient_checkpointing": False,
                    "use_remove_padding": False,
                    # camera views per sample (third-person [+ wrist]);
                    # reference num_images_in_input — LIBERO eval default 2
                    # (run_libero_eval.py:99, modeling_prismatic.py:209-231)
                    "num_images_in_input": 1,
                },
                "actor": {
                    "num_patches": 256,
                    "num_tokens": 64,
                    "log_l1_loss": True,
                    "vocab_size": 9008,
                    "ppo_mini_batch_size": 16,
                    "ppo_micro_batch_size_per_gpu": 8,
                    "use_dynamic_bsz": False,
                    "grad_clip": 1.0,
                    "clip_ratio": 0.2,
                    "clip_ratio_low": 0.2,
                    "clip_ratio_high": 0.2,
                    "clip_ratio_c": 3.0,
                    "loss_agg_mode": "token-mean",
                    "entropy_coeff": 0.003,
                    "use_mse_loss": True,
                    "mse_loss_coef": 0.01,
                    "mse_kl_low": 0.0,
                    "mse_kl_high": 0.2,
                    "log_mse_loss": False,
                    "use_kl_loss": False,
                    "kl_loss_coef": 0.001,
                    "kl_loss_type": "low_var_kl",
                    "ppo_epochs": 1,
                    # K flow steps folded per DiT call in the grad replay
                    # (1 = fully batched; K = sequential; bounds activations)
                    "replay_step_chunks": 2,
                    "shuffle": False,
                    "optim": {
                        "lr": 1e-6,
                        "lr_warmup_steps": 10,
                        "lr_warmup_steps_ratio": 0.0,
                        "total_training_steps": -1,
                        "weight_decay": 0.01,
                        "betas": [0.9, 0.999],
                        "sigma_lr": 1e-5,
                        "sigma_weight_decay": 0.0,
                    },
                },
                "ref": {"log_prob_micro_batch_size_per_gpu": 8},
                "rollout": {
                    "name": "flow",  # reference: 'hf' (HFRollout); here a scan rollout
                    "micro_batch_size": 32,
                    "num_patches": 256,
                    "num_tokens": 64,
                    "temperature": 1.0,
                    "prompt_length": 1095,
                    "response_length": 568,
                    "do_sample": True,
                    "n": 16,
                    # text-RL rollout: share one prefilled prompt KV across
                    # the n GRPO rollouts (sglang RadixAttention analog,
                    # one level deep) — llm_rollout.generate_sequences
                    "prefix_share": False,
                    "log_prob_micro_batch_size_per_gpu": 16,
                    "num_flow_steps": 10,
                    "val_kwargs": {"top_k": -1, "top_p": 1.0, "temperature": 1.0, "n": 1, "do_sample": True},
                },
            },
            "world_model_rollout": {
                # size_overrides: optional TransformerConfig field overrides
                # applied on top of the preset's WM architecture (None = use
                # the preset default).  Lets tools/rft_evidence.py scale the
                # push WM (capacity sweeps) without a new preset.
                "model": {
                    "path": None,
                    "use_remove_padding": False,
                    "size_overrides": {
                        "hidden_size": None,
                        "intermediate_size": None,
                        "num_layers": None,
                        "num_heads": None,
                        "num_kv_heads": None,
                    },
                },
                "world_model": {"vocab_size": 9008, "interact": True},
                "rollout": {
                    "w_gt_ac": True,
                    "is_validate": True,
                    # 128 = policy+gt branches of a 64-seq step in ONE
                    # decode call (split-cache: own cache ~20MB/seq int8
                    # packed; B=128 measured 144 frames/s vs 120 at B=64)
                    "micro_batch_size": 128,
                    "name": "scan",  # reference: vLLM; here lax.scan decode
                    "temperature": 1.0,
                    "top_k": -1,
                    "top_p": 0.8,
                    "prompt_length": 1095,
                    "response_length": 568,
                    "do_sample": True,
                    "interact": True,
                    "interact_max_tokens": 64,
                    # valid-prefix KV bounding: frame loop split into this
                    # many statically-sized cache segments (perf-neutral
                    # semantics; see wm_rollout.generate_sequences)
                    "cache_segments": 8,
                    # UPPER BOUND on rows per decode-kernel iteration; each
                    # call clamps to the largest divisor of its uniform-
                    # prefix run (n+1=17 with the interleaved gt row).
                    # 'hd' kernel: bigger is better (shared-segment work is
                    # linear in it); 'heads' kernel measured best at 2.
                    "decode_block_b": 32,
                    # KV cache layout: 'hd' (L,B,S,Hkv*D — head-dense lanes,
                    # ops/decode_attention_hd.py) or 'heads' (L,B,H,S,D
                    # pair-packed, round-1 kernels)
                    "kv_layout": "hd",
                    # run the gt-action branch once per unique SAMPLE instead
                    # of once per rollout: the branch depends only on
                    # per-sample inputs (shared prompt head + gt actions), and
                    # a shared gt realization cancels exactly in the
                    # group-relative GRPO advantage while the reference's n
                    # duplicates (vllm_rollout.py:216-230) only add
                    # independent reward noise.  ~halves wm_rollout rows and
                    # gt detokenize frames.  False = reference behavior.
                    "gt_branch_per_sample": True,
                    # speculative decoding draft length (0=off): copy-prev-
                    # frame drafts + exact rejection sampling — distribution
                    # preserving; pays off with REAL WM weights (repetitive
                    # video tokens), not with the synthetic bench's random
                    # weights, hence off by default
                    "speculative_k": 0,
                    # int8 WM weights for the (frozen) rollout model —
                    # halves decode weight reads; logprob paths stay bf16
                    "weights_int8": False,
                    "val_kwargs": {"top_k": -1, "top_p": 0.8, "temperature": 1.0},
                },
            },
            "critic": {
                "optim": {"lr": 1e-5, "weight_decay": 0.01},
                "grad_clip": 1.0,
                "cliprange_value": 0.5,
                "ppo_epochs": 1,
            },
            "reward_model": {"enable": False, "reward_manager": "naive"},
            "algorithm": {
                "gamma": 1.0,
                "lam": 1.0,
                "adv_estimator": "grpo",
                "uniform_std": False,
                "use_kl_in_reward": False,
                "kl_penalty": "kl",
                "kl_ctrl": {"type": "fixed", "kl_coef": 0.001, "horizon": 10000, "target_kl": 0.1},
            },
            "trainer": {
                "use_ac_reward": False,
                "ac_reward_type": "l1",
                "total_epochs": 30,
                "total_training_steps": 400,
                "project_name": "vla_rft",
                "experiment_name": "vla_rft_fm_tpu",
                "logger": ["console"],
                "nnodes": 1,
                "n_devices": -1,
                "save_freq": 50,
                "save_last_freq": 20,
                "save_last_num": 2,
                "resume_mode": "auto",
                "resume_from_path": None,
                "val_before_train": False,
                "val_iters": 10,
                "test_freq": -1,
                "critic_warmup": 0,
                "balance_batch": False,
                "default_local_dir": "checkpoints/vla_rft_tpu",
                "reward_fn": "mae",
                "loss_weight": {"lpips": 1, "mae": 1, "mse": 0, "ssim": 0, "psnr": 0},
                "msp_reward_aggregate": "mean",
                "msp_reward_discount": 0.95,
                "seed": 0,
            },
            "mesh": {"dp": -1, "fsdp": 1, "tp": 1, "sp": 1},
        }
    )


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    # actor_rollout_ref.model.num_images_in_input: camera views per request
    num_images_in_input: int = 1
    # processor.action_dim
    action_dim: int = 7
    # data.video.segment_length: the action chunk is segment_length - 1 long
    segment_length: int = 9

    @staticmethod
    def from_config(config: Config) -> "PolicyConfig":
        return PolicyConfig(
            num_images_in_input=int(config.actor_rollout_ref.model.get("num_images_in_input", 1)),
            action_dim=config.processor.action_dim,
            segment_length=config.data.video.segment_length,
        )


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
    # world_model_rollout.rollout.kv_layout: the WM's KV cache layout
    kv_layout: str = "hd"
    # world_model_rollout.rollout.speculative_k: the rollout's draft length
    speculative_k: int = 0
    # trainer.reward_fn / loss_weight / msp_reward_*
    reward_fn: str = "mae"
    lpips_weight: float = 1.0
    recon_weight: float = 1.0
    msp_reward_aggregate: str = "mean"
    msp_reward_discount: float = 0.95

    @staticmethod
    def from_config(config: Config) -> "WMRewardConfig":
        """The fields as the reference's build_models reads them from the tree."""
        roll, proc, tr = config.world_model_rollout.rollout, config.processor, config.trainer
        sampling = roll.val_kwargs if roll.is_validate else roll
        return WMRewardConfig(
            max_prompt_length=config.data.max_prompt_length,
            max_response_length=config.data.max_response_length,
            segment_length=config.data.video.segment_length,
            wm_vocab_size=config.world_model_rollout.world_model.vocab_size,
            visual_token_num=proc.visual_token_num, action_bins=proc.action_bins,
            action_dim=proc.action_dim, tokens_per_frame=proc.tokens_per_frame,
            interact_max_tokens=roll.interact_max_tokens, temperature=sampling.temperature,
            top_k=sampling.top_k, top_p=sampling.top_p, do_sample=roll.do_sample,
            cache_segments=roll.get("cache_segments", 4),
            kv_layout=str(roll.get("kv_layout", "hd") or "hd"),
            speculative_k=int(roll.get("speculative_k", 0) or 0), reward_fn=tr.reward_fn,
            lpips_weight=tr.loss_weight.lpips,
            recon_weight=tr.loss_weight.get(tr.reward_fn, 1.0),
            msp_reward_aggregate=tr.msp_reward_aggregate,
            msp_reward_discount=tr.msp_reward_discount,
        )
