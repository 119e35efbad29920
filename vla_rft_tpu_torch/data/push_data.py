"""MuJoCo push-env segments and the push task's policy inputs.

Port of vla_rft_tpu/data/push_data.py (numpy only at import; PIL and
`mujoco` are imported inside the functions that use them).  The push
preset's behaviour cloning and RFT (tools/rft_evidence.py) train on
(frame_0, 8 actions, 8 future frames) segments of `eval/mujoco_push_env.py`
episodes: the scripted expert's chunks with graded action noise, so that a
world model trained on them sees off-expert dynamics.  This module

* collects them (`CollectConfig`, `collect_push_segments`), saves and
  loads them with the renderer's version (`save_segments`, `load_segments`)
  and splits them (`train_val_split`);
* replays them in the batch layout the trainers read
  (`PushSegmentDataset`, with `state_dict` / `load_state_dict`):

    pixel_values      (B, P, P, 6)  policy view, both tower channels
    proprio           (B, 8)
    input_ids/attention_mask/labels (B, S)  the fixed prompt row
    actions           (B, chunk, 7) executed (or, for BC, expert) chunk
    raw_pixel_values  (B, chunk+1, W, W, 3) uint8 WM frames
    sim_states        (B, state_dim) the MuJoCo state at segment start

* and builds the policy's inputs: `resize_uint8` (the Lanczos resize of a
  rendered view) and `build_push_prompt` (the fixed prompt row with its
  action-query span).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from vla_rft_tpu_torch.models.action_masks import ACTION_TOKEN_BEGIN_IDX


def resize_uint8(img: np.ndarray, size: int) -> np.ndarray:
    """Lanczos resize (PIL), uint8 in/out — same resampler as the eval glue's
    resize_image_for_policy."""
    from PIL import Image

    if img.shape[0] == size and img.shape[1] == size:
        return np.asarray(img, np.uint8)
    pil = Image.fromarray(np.asarray(img, np.uint8)).resize(
        (size, size), Image.LANCZOS
    )
    return np.asarray(pil, np.uint8)


def build_push_prompt(
    seq_len: int, num_tokens: int, task: str = "push the red cube into the green target zone"
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fixed prompt row: [BOS, task-derived pseudo tokens, num_tokens action
    tokens, EOS, pad].  The task is constant across the suite, so the text
    token VALUES only need to be deterministic — the policy conditions on the
    image; labels mark the action-query span exactly like the RLDS transform
    (RLDSBatchTransform_V1, datasets.py:300-433)."""
    text = np.frombuffer(task.encode(), np.uint8).astype(np.int64) + 1000
    text_len = seq_len - num_tokens - 2
    text = text[:text_len]
    input_ids = np.zeros(seq_len, np.int64)
    labels = np.full(seq_len, -100, np.int64)
    attn = np.zeros(seq_len, np.int64)
    input_ids[0] = 1  # BOS
    input_ids[1 : 1 + len(text)] = text
    start = 1 + len(text)
    action_ids = ACTION_TOKEN_BEGIN_IDX + 1 + (np.arange(num_tokens) % 100)
    input_ids[start : start + num_tokens] = action_ids
    labels[start : start + num_tokens] = action_ids
    input_ids[start + num_tokens] = 2  # EOS
    attn[: start + num_tokens + 1] = 1
    return input_ids.astype(np.int32), attn.astype(np.int32), labels.astype(np.int32)


@dataclasses.dataclass
class CollectConfig:
    n_segments: int = 512
    chunk: int = 8
    policy_image_size: int = 64
    wm_image_size: int = 32
    # the scripted expert needs ~10-25 chunks (align + push); 28 matches the
    # libero_spatial 220-step budget and gives 100% pure-expert success
    max_chunks_per_episode: int = 28
    # fraction of chunks executed with each noise scale (on top of the
    # scripted expert); >0 noise gives the WM off-expert dynamics coverage
    noise_scales: Tuple[float, ...] = (0.0, 0.0, 0.25, 0.5, 1.0)
    random_chunk_prob: float = 0.1  # fully random action chunks
    seed: int = 0
    resolution: int = 128  # env render resolution before downscale


def collect_push_segments(cfg: CollectConfig) -> Dict[str, np.ndarray]:
    """Roll episodes across the 3 push tasks; at every chunk boundary compute
    the scripted expert chunk, optionally perturb it, execute it, and record
    one training segment."""
    from vla_rft_tpu_torch.eval.libero_eval import quat2axisangle
    from vla_rft_tpu_torch.eval.mujoco_push_env import make_push_env, scripted_push_expert

    rng = np.random.default_rng(cfg.seed)
    segs = {
        "policy_pixels": [],  # (P, P, 3) uint8 at chunk start
        "proprio": [],  # (8,)
        "actions": [],  # (chunk, 7)
        "raw_pixel_values": [],  # (chunk+1, W, W, 3) uint8
        "sim_states": [],  # env state at chunk start
        "expert_actions": [],  # the unperturbed expert chunk (BC target)
        "noise_scale": [],  # scalar per segment
        "task_id": [],
        "success": [],  # episode eventually succeeded from this chunk on
    }
    n = 0
    episode = 0
    while n < cfg.n_segments:
        task_id = episode % 3
        env, _, init_states = make_push_env(
            task_id, resolution=cfg.resolution, num_init_states=16,
            seed=cfg.seed + episode // 3,
        )
        env.reset()
        env.set_init_state(init_states[rng.integers(len(init_states))])
        ep_records = []
        done = False
        for _ in range(cfg.max_chunks_per_episode):
            obs = env._obs()
            img = obs["agentview_image"][::-1, ::-1]  # undo render flip
            proprio = np.concatenate(
                [
                    obs["robot0_eef_pos"],
                    quat2axisangle(obs["robot0_eef_quat"]),
                    obs["robot0_gripper_qpos"],
                ]
            ).astype(np.float32)
            state = env.get_sim_state()
            expert = scripted_push_expert(env, cfg.chunk)
            if rng.random() < cfg.random_chunk_prob:
                acts = rng.uniform(-1, 1, (cfg.chunk, 7)).astype(np.float32)
                scale = -1.0  # sentinel: fully random
            else:
                scale = float(rng.choice(cfg.noise_scales))
                acts = np.clip(
                    expert + scale * rng.normal(size=expert.shape).astype(np.float32),
                    -1.0, 1.0,
                ).astype(np.float32)
            frames = [resize_uint8(img, cfg.wm_image_size)]
            for a in acts:
                obs, _, done, _ = env.step(a.tolist())
                frames.append(
                    resize_uint8(
                        obs["agentview_image"][::-1, ::-1], cfg.wm_image_size
                    )
                )
            ep_records.append(
                dict(
                    policy_pixels=resize_uint8(img, cfg.policy_image_size),
                    proprio=proprio,
                    actions=acts,
                    raw_pixel_values=np.stack(frames),
                    sim_states=state.astype(np.float32),
                    expert_actions=expert.astype(np.float32),
                    noise_scale=np.float32(scale),
                    task_id=np.int32(task_id),
                )
            )
            if done:
                break
        for r in ep_records:
            r["success"] = np.bool_(done)
            for k, v in r.items():
                segs[k].append(v)
            n += 1
        episode += 1
    return {k: np.stack(v[: cfg.n_segments]) for k, v in segs.items()}


class PushSegmentDataset:
    """Trainer-compatible batch stream over collected push segments
    (StatefulDataLoader analog: state_dict/load_state_dict expose the step)."""

    def __init__(
        self,
        data: Dict[str, np.ndarray],
        batch_size: int,
        seq_len: int = 32,
        num_action_tokens: int = 8,
        seed: int = 0,
        expert_targets: bool = False,
        indices: Optional[np.ndarray] = None,
    ):
        self.data = data
        self.idx = (
            np.asarray(indices, np.int64)
            if indices is not None
            else np.arange(len(data["actions"]))
        )
        self.batch_size = batch_size
        self.seed = seed
        self._step = 0
        # BC trains on the clean expert chunk; RFT's gt branch uses the
        # executed actions (they produced the recorded future frames)
        self.action_key = "expert_actions" if expert_targets else "actions"
        self._prompt = build_push_prompt(seq_len, num_action_tokens)

    def state_dict(self) -> Dict:
        return {"step": self._step}

    def load_state_dict(self, state: Dict) -> None:
        self._step = int(state["step"])

    def __len__(self):
        return len(self.idx)

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, self._step))
        self._step += 1
        rows = self.idx[rng.integers(0, len(self.idx), self.batch_size)]
        ids, attn, labels = self._prompt
        B = len(rows)
        px = self.data["policy_pixels"][rows].astype(np.float32) / 255.0
        return {
            "pixel_values": np.concatenate([px, px], axis=-1),
            "proprio": self.data["proprio"][rows],
            "input_ids": np.tile(ids, (B, 1)),
            "attention_mask": np.tile(attn, (B, 1)),
            "labels": np.tile(labels, (B, 1)),
            "actions": self.data[self.action_key][rows],
            "raw_pixel_values": self.data["raw_pixel_values"][rows],
            "sim_states": self.data["sim_states"][rows],
        }

    def __iter__(self):
        while True:
            yield self.next_batch()


def save_segments(path: str, data: Dict[str, np.ndarray]) -> None:
    """The segments as a compressed .npz, tagged with the renderer's version."""
    from vla_rft_tpu_torch.eval.mujoco_push_env import RENDER_VERSION

    np.savez_compressed(path, **data, render_version=np.int32(RENDER_VERSION))


def load_segments(path: str) -> Dict[str, np.ndarray]:
    """Segments saved by `save_segments`: an untagged file warns, one from
    another renderer version raises."""
    from vla_rft_tpu_torch.eval.mujoco_push_env import RENDER_VERSION

    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    ver = int(data.pop("render_version", -1))
    if ver == -1:
        import warnings

        warnings.warn(
            f"{path} predates render_version tagging (pre round-5); its "
            f"frames may not match the current env renderer "
            f"(RENDER_VERSION={RENDER_VERSION})."
        )
    elif ver != RENDER_VERSION:
        raise ValueError(
            f"{path} was collected with render_version={ver} but the env "
            f"now renders version {RENDER_VERSION}; collect the segments "
            f"again (stale observation distribution)."
        )
    return data


def train_val_split(
    data: Dict[str, np.ndarray], val_frac: float = 0.1, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """(train, val) segment indices: a seeded permutation, at least one for
    validation."""
    n = len(data["actions"])
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_val = max(1, int(n * val_frac))
    return perm[n_val:], perm[:n_val]
