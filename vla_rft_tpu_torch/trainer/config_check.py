"""Cross-field config validation (port of vla_rft_tpu/trainer/config_check.py,
RayPPOTrainer._validate_config): batch divisibility and the ctx_msp token
layout, checked before any model is built (an off-by-one in the layout
silently destroys rewards)."""
from __future__ import annotations

from typing import List, Optional

from vla_rft_tpu_torch.ops.decode_attention_hd import MAX_SQ

# a verify call of the speculative WM rollout sends 1 + k tokens a row to the
# decode kernel (#4 / #6), which takes at most MAX_SQ
MAX_SPECULATIVE_K = MAX_SQ - 1


def speculative_k_problem(config) -> Optional[str]:
    """The problem with world_model_rollout.rollout.speculative_k, if any
    (the trainer refuses it)."""
    spec_k = int(config.world_model_rollout.rollout.get("speculative_k", 0) or 0)
    if spec_k <= MAX_SPECULATIVE_K:
        return None
    return (f"world_model_rollout.rollout.speculative_k ({spec_k}) > {MAX_SPECULATIVE_K}: a "
            f"verify call of 1 + k tokens exceeds the decode kernel's Sq <= {MAX_SQ} "
            f"(ops/decode_attention_hd.py MAX_SQ)")


def resolve_mesh(config, world_size: int):
    """config.mesh resolved against the world's ranks: the reference's
    MeshConfig.resolve, with its ValueError for a mesh the world cannot
    hold."""
    from vla_rft_tpu_torch.parallel.mesh import MeshConfig

    return MeshConfig(**config.mesh.to_dict()).resolve(world_size)


def validate_config(config, n_devices: int = 1) -> List[str]:
    """Returns a list of problems (empty = valid). Raises on fatal ones."""
    problems: List[str] = []
    data = config.data
    actor = config.actor_rollout_ref.actor
    roll = config.actor_rollout_ref.rollout
    proc = config.processor

    B = data.train_batch_size
    n = roll.n
    total = B * n
    mini = actor.ppo_mini_batch_size
    micro = actor.ppo_micro_batch_size_per_gpu

    if total % mini != 0:
        problems.append(
            f"train_batch_size*n ({total}) must divide into ppo_mini_batch_size ({mini})"
        )
    if micro is not None and mini % (micro) != 0 and mini > micro:
        problems.append(
            f"ppo_mini_batch_size ({mini}) should be a multiple of "
            f"ppo_micro_batch_size_per_gpu ({micro})"
        )
    if total % n_devices != 0:
        problems.append(f"global batch {total} not divisible by {n_devices} devices")

    # decode_block_b is the TPU kernel's batch block; the CUDA kernels read
    # prefix_map per row, but the field must still be positive
    wm_roll = config.world_model_rollout.rollout
    if int(wm_roll.get("decode_block_b", 1) or 1) < 1:
        problems.append("world_model_rollout.rollout.decode_block_b must be >= 1")
    spec = speculative_k_problem(config)
    if spec:
        problems.append(spec)
    # WM chunks are cut on group boundaries (n, or n + 1 with the gt row),
    # so a chunk must hold at least one group
    wm_mb = int(wm_roll.get("micro_batch_size", 0) or 0)
    if wm_mb and wm_mb < n:
        problems.append(
            f"world_model_rollout.rollout.micro_batch_size ({wm_mb}) is "
            f"smaller than one rollout group (n={n}); decode chunks cut on "
            f"group boundaries and can't subdivide a group"
        )

    # token-layout invariants (ctx_msp)
    if proc.processor_type == "ctx_msp":
        seg = data.video.segment_length
        per_frame = proc.tokens_per_frame + proc.action_dim
        expect_prompt = 1024 if proc.tokens_per_frame == 64 else None
        gen_in = proc.get("gen_input_length", data.max_prompt_length)
        if data.max_response_length != (seg - 1) * per_frame:
            problems.append(
                f"max_response_length ({data.max_response_length}) != "
                f"(segment_length-1)*(tokens_per_frame+action_dim) = {(seg - 1) * per_frame}"
            )
        if expect_prompt is not None and data.max_prompt_length != expect_prompt + per_frame:
            problems.append(
                f"max_prompt_length ({data.max_prompt_length}) != ctx(1024) + "
                f"first frame ({per_frame})"
            )
        vocab = config.actor_rollout_ref.actor.vocab_size
        if proc.eos_token_id >= vocab or proc.bos_token_id >= vocab:
            problems.append("bos/eos token ids exceed WM vocab size")
        if proc.bos_token_id != 2 * proc.visual_token_num + proc.action_bins:
            problems.append(
                "bos_token_id should be 2*visual_token_num + action_bins "
                f"({2 * proc.visual_token_num + proc.action_bins}) for the ctx_msp space"
            )

    # chunk/frame invariant
    seg = data.video.segment_length
    # action chunk must cover the predicted frames (num_actions_chunk == seg-1)

    return problems


def assert_valid_config(config, n_devices: int = 1) -> None:
    problems = validate_config(config, n_devices)
    if problems:
        raise ValueError("invalid config:\n  - " + "\n  - ".join(problems))
