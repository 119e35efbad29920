"""ALOHA real-robot evaluation harness.

Port of vla_rft_tpu/eval/aloha_eval.py (numpy at import; PIL inside the
resizes).  Counterpart of experiments/robot/aloha/run_aloha_eval.py:1-385 +
aloha_utils.py:1-85: drives a (bimanual) ALOHA rig at 25 Hz from the robot
workstation, querying the policy for 25-step open-loop action chunks —
either over HTTP from a GPU host running serving/action_server.py (the
reference's use_vla_server path, get_server_endpoint :113-116) or from an
in-process policy_fn.

Everything robot-side is host CPU (dm_env TimeStep protocol); the GPU never
sees this module.  The env handle is injected so tests drive the full loop
with FakeAlohaEnv — the real `make_real_env` (aloha/real_env.py, ROS) is
imported lazily and only when requested.

Reference behaviors kept:
- image pipeline: cam_high + left/right wrist frames are FIRST resized to
  256x256 bicubic (aloha_utils.resize_image_for_preprocessing:38-48 — the
  RLDS builder's convention, so eval matches training distribution), then
  policy-resized with the JPEG-roundtrip + lanczos3 scheme shared with
  LIBERO (openvla_utils.resize_image_for_policy).
- 25 Hz step pacing with sleep-to-deadline (run_aloha_eval.py:146,230-234).
- relative-action mode integrates commanded targets, NOT measured qpos
  (run_aloha_eval.py:216-224: "assume it is the commanded target state").
- requery exactly when the action queue drains (deque(maxlen=chunk)).
- per-episode stats: success / total_steps / model_query_time /
  episode_duration (:245-251).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from vla_rft_tpu_torch.eval.libero_eval import resize_image_for_policy, save_rollout_video

ALOHA_PREPROCESS_SIZE = 256  # aloha_utils.py:44
STEP_DURATION_SEC = 1.0 / 25.0  # run_aloha_eval.py:146


@dataclasses.dataclass
class AlohaGenerateConfig:
    """Mirrors run_aloha_eval.GenerateConfig (:47-78)."""

    num_open_loop_steps: int = 25
    num_rollouts_planned: int = 50
    max_steps: int = 1500
    use_relative_actions: bool = False
    resize_size: int = 224
    seed: int = 7
    save_video_dir: Optional[str] = None
    # pace the loop at 25 Hz (off in tests: a fake env has no real robot to
    # outrun, and 1500 sleeps would dominate the suite)
    pace_control: bool = True


def resize_image_for_preprocessing(img: np.ndarray) -> np.ndarray:
    """256x256 bicubic — exactly the ALOHA RLDS preprocessing resize
    (aloha_utils.py:38-48), applied BEFORE the policy resize so eval-time
    inputs go through the same two-stage chain as training frames."""
    from PIL import Image

    pil = Image.fromarray(np.asarray(img, np.uint8))
    return np.array(pil.resize((ALOHA_PREPROCESS_SIZE, ALOHA_PREPROCESS_SIZE),
                               resample=Image.BICUBIC))


def make_aloha_env():
    """Real rig only (aloha_utils.get_aloha_env:33-36).  Lazy ROS import."""
    try:
        from aloha.real_env import make_real_env  # type: ignore
    except ImportError as e:  # pragma: no cover - hardware-only path
        raise RuntimeError(
            "ALOHA env requires the aloha/interbotix ROS stack on the robot "
            "workstation; pass env= explicitly for simulation or tests"
        ) from e
    return make_real_env(init_node=True)


def prepare_observation(obs: Any, resize_size: int) -> Tuple[Dict[str, np.ndarray], List[np.ndarray]]:
    """run_aloha_eval.prepare_observation (:119-138): three cameras through
    the two-stage resize + qpos state.  Returns (policy obs, resized views
    for replay videos)."""
    images = obs.observation["images"]
    views = []
    for cam in ("cam_high", "cam_left_wrist", "cam_right_wrist"):
        img = resize_image_for_preprocessing(images[cam])
        views.append(resize_image_for_policy(img, resize_size))
    observation = {
        "full_image": views[0],
        "left_wrist_image": views[1],
        "right_wrist_image": views[2],
        "state": np.asarray(obs.observation["qpos"], np.float32),
    }
    return observation, views


def run_episode(
    cfg: AlohaGenerateConfig,
    env: Any,
    task_description: str,
    get_action_chunk: Callable[[Dict[str, Any], str], np.ndarray],
    success_fn: Optional[Callable[[Any], bool]] = None,
) -> Tuple[Dict[str, Any], List[np.ndarray]]:
    """One episode (run_aloha_eval.run_episode:141-255).

    `get_action_chunk(observation, task)` returns a (>=chunk, dof) array —
    the HTTP client (serving.get_action_from_server) or an in-process
    policy; only the first num_open_loop_steps rows are executed (:205).
    `success_fn(env)` replaces the reference's interactive y/n prompt
    (:243-244) — defaults to env.is_success() when available, else False.
    """
    obs = env.reset()
    action_queue: deque = deque(maxlen=cfg.num_open_loop_steps)
    t = 0
    curr_state = np.asarray(env.get_qpos(), np.float32)
    replay_images: List[np.ndarray] = []
    episode_start = time.time()
    query_time = 0.0

    try:
        while t < cfg.max_steps:
            step_start = time.time()
            obs = env.get_observation(t=t)
            replay_images.append(np.asarray(obs.observation["images"]["cam_high"]))

            if len(action_queue) == 0:
                observation, _ = prepare_observation(obs, cfg.resize_size)
                q0 = time.time()
                actions = np.asarray(get_action_chunk(observation, task_description))
                query_time += time.time() - q0
                action_queue.extend(actions[: cfg.num_open_loop_steps])

            action = np.asarray(action_queue.popleft(), np.float32)
            if cfg.use_relative_actions:
                target = curr_state + action
                obs = env.step(target.tolist())
                curr_state = target  # commanded, not measured (:223)
            else:
                obs = env.step(action.tolist())
            t += 1

            if cfg.pace_control:
                elapsed = time.time() - step_start
                if elapsed < STEP_DURATION_SEC:
                    time.sleep(STEP_DURATION_SEC - elapsed)
            if getattr(env, "done", False):
                break
    except KeyboardInterrupt:
        pass

    if success_fn is not None:
        success = bool(success_fn(env))
    else:
        success = bool(env.is_success()) if hasattr(env, "is_success") else False
    stats = {
        "success": success,
        "total_steps": t,
        "model_query_time": query_time,
        "episode_duration": time.time() - episode_start,
    }
    return stats, replay_images


def run_eval(
    cfg: AlohaGenerateConfig,
    get_action_chunk: Callable[[Dict[str, Any], str], np.ndarray],
    env: Any,
    task_descriptions: List[str],
    success_fn: Optional[Callable[[Any], bool]] = None,
) -> Dict[str, Any]:
    """Multi-rollout driver (run_aloha_eval.eval_model:300-385): aggregate
    success over num_rollouts_planned episodes, optional replay videos."""
    episodes = []
    n = min(cfg.num_rollouts_planned, len(task_descriptions))
    for idx in range(n):
        stats, frames = run_episode(cfg, env, task_descriptions[idx],
                                    get_action_chunk, success_fn)
        episodes.append({"task": task_descriptions[idx], **stats})
        if cfg.save_video_dir and frames:
            tag = f"ep{idx}_" + task_descriptions[idx].lower().replace(" ", "_")[:50]
            save_rollout_video(frames, cfg.save_video_dir, tag, stats["success"], fps=25)
    succ = [e["success"] for e in episodes]
    return {
        "num_episodes": len(episodes),
        "num_successes": int(np.sum(succ)),
        "success_rate": float(np.mean(succ)) if episodes else 0.0,
        "episodes": episodes,
    }
