"""BridgeData V2 (WidowX) real-robot evaluation harness.

Port of vla_rft_tpu/eval/bridge_eval.py (numpy at import; PIL inside the
resize).  Counterpart of experiments/robot/bridge/run_bridgev2_eval.py:1-183 +
bridgev2_utils.py:1-133: drives a WidowX arm at 5 Hz, one policy query per
control step (Bridge uses single-step actions — no open-loop chunk queue,
unlike ALOHA/LIBERO), unnorm key "bridge_orig" (:91), center_crop must be
OFF (:85-86).

Robot-side host CPU only.  The WidowX client stack (widowx_envs ROS
service) is imported lazily in make_widowx_env; tests inject a fake env
that implements reset()/step()/get_observation().

Reference behaviors kept:
- deadline-based 5 Hz pacing: a step fires only when step_duration has
  elapsed since the previous one (run_bridgev2_eval.py:127-131) — the loop
  polls rather than sleeps, matching the non-blocking WidowX controller.
- refresh_obs pulls full_image/image_primary/proprio each step
  (bridgev2_utils.py:126-133).
- policy-input image takes the JPEG-roundtrip + lanczos3 resize
  (bridgev2_utils.resize_image:104-117 — the Octo/RLDS builder scheme),
  shared with LIBERO via resize_image_for_policy.
- optional rollout data dump: orig images / processed images / proprio /
  actions to one .npz per episode (bridgev2_utils.save_rollout_data:80-101).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from vla_rft_tpu_torch.eval.libero_eval import resize_image_for_policy, save_rollout_video

BRIDGE_PROPRIO_DIM = 7  # bridgev2_utils.py:18


@dataclasses.dataclass
class BridgeGenerateConfig:
    """Mirrors run_bridgev2_eval.GenerateConfig (:37-78)."""

    host_ip: str = "localhost"
    port: int = 5556
    # 30-degree wrist offset start pose (:57-58)
    init_ee_pos: tuple = (0.3, -0.09, 0.26)
    init_ee_quat: tuple = (0.0, -0.259, 0.0, -0.966)
    bounds: tuple = ((0.1, -0.20, -0.01, -1.57, 0), (0.45, 0.25, 0.30, 1.57, 0))
    camera_topics: tuple = ({"name": "/blue/image_raw"},)
    blocking: bool = False
    max_episodes: int = 50
    max_steps: int = 60
    control_frequency: float = 5.0
    resize_size: int = 224
    unnorm_key: str = "bridge_orig"
    save_data: bool = False
    save_dir: str = "./rollouts"
    save_video_dir: Optional[str] = None
    # tests: skip the wall-clock deadline gate (fake envs have no controller
    # to pace against)
    pace_control: bool = True


def make_widowx_env(cfg: BridgeGenerateConfig):
    """Real WidowX service client (bridgev2_utils.get_widowx_env:33-47).
    Lazy import — widowx_envs is a robot-workstation ROS package."""
    try:
        from widowx_envs.widowx_env_service import WidowXClient, WidowXConfigs  # type: ignore
    except ImportError as e:  # pragma: no cover - hardware-only path
        raise RuntimeError(
            "Bridge eval requires the widowx_envs service stack on the robot "
            "workstation; pass env= explicitly for simulation or tests"
        ) from e
    env_params = WidowXConfigs.DefaultEnvParams.copy()
    env_params["override_workspace_boundaries"] = [list(b) for b in cfg.bounds]
    env_params["camera_topics"] = list(cfg.camera_topics)
    env_params["return_full_image"] = True
    env_params["start_state"] = list(cfg.init_ee_pos) + list(cfg.init_ee_quat)
    client = WidowXClient(host=cfg.host_ip, port=cfg.port)
    client.init(env_params)
    from vla_rft_tpu_torch.eval.widowx_gym import WidowXGym

    return WidowXGym(client, cfg=cfg, blocking=cfg.blocking)


def refresh_obs(obs: Dict[str, Any], env: Any) -> Dict[str, Any]:
    """bridgev2_utils.refresh_obs (:126-133)."""
    new_obs = env.get_observation()
    obs["full_image"] = new_obs["full_image"]
    obs["image_primary"] = new_obs["image_primary"]
    obs["proprio"] = new_obs["proprio"]
    return obs


def save_rollout_data(orig_images, images, states, actions, idx: int,
                      out_dir: str) -> str:
    """bridgev2_utils.save_rollout_data (:80-101): one npz per episode."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"rollout-bridge-{idx + 1}.npz")
    np.savez(
        path,
        orig_images=np.asarray(orig_images),
        images=np.asarray(images),
        states=np.asarray(states),
        actions=np.asarray(actions),
    )
    return path


def run_episode(
    cfg: BridgeGenerateConfig,
    env: Any,
    task_description: str,
    get_action: Callable[[Dict[str, Any], str], np.ndarray],
    episode_idx: int = 0,
) -> Dict[str, Any]:
    """One Bridge episode (run_bridgev2_eval.py:108-174).  `get_action`
    returns a single (7,) action (chunked policies: row 0 is executed —
    Bridge requeries every step)."""
    reset_out = env.reset()
    obs = reset_out[0] if isinstance(reset_out, tuple) else reset_out
    t = 0
    step_duration = 1.0 / cfg.control_frequency
    replay_images: List[np.ndarray] = []
    rollout = {"orig_images": [], "images": [], "states": [], "actions": []}
    last_tstamp = 0.0 if not cfg.pace_control else time.time()

    while t < cfg.max_steps:
        try:
            if cfg.pace_control and time.time() <= last_tstamp + step_duration:
                continue
            last_tstamp = time.time()

            obs = refresh_obs(obs if isinstance(obs, dict) else {}, env)
            replay_images.append(np.asarray(obs["full_image"]))
            processed = resize_image_for_policy(obs["full_image"], cfg.resize_size)

            action = np.asarray(
                get_action({**obs, "full_image": processed}, task_description),
                np.float32,
            )
            if action.ndim > 1:
                action = action[0]

            if cfg.save_data:
                rollout["orig_images"].append(replay_images[-1])
                rollout["images"].append(processed)
                rollout["states"].append(np.asarray(obs["proprio"]))
                rollout["actions"].append(action)

            step_out = env.step(action)
            obs = step_out[0] if isinstance(step_out, tuple) else step_out
            t += 1
            if getattr(env, "done", False):
                break
        except KeyboardInterrupt:
            break

    if cfg.save_video_dir and replay_images:
        tag = f"ep{episode_idx}_" + task_description.lower().replace(" ", "_")[:50]
        save_rollout_video(replay_images, cfg.save_video_dir, tag,
                           bool(getattr(env, "done", False)), fps=5)
    if cfg.save_data and rollout["actions"]:
        save_rollout_data(rollout["orig_images"], rollout["images"],
                          rollout["states"], rollout["actions"],
                          episode_idx, cfg.save_dir)
    return {
        "total_steps": t,
        "success": bool(env.is_success()) if hasattr(env, "is_success") else False,
    }


def run_eval(
    cfg: BridgeGenerateConfig,
    env: Any,
    get_action: Callable[[Dict[str, Any], str], np.ndarray],
    task_descriptions: List[str],
) -> Dict[str, Any]:
    """Episode loop (run_bridgev2_eval.eval_model_in_bridge_env:82-183),
    with the interactive task/redo prompts replaced by an injected task
    list so the same driver runs headless."""
    episodes = []
    for idx, task in enumerate(task_descriptions[: cfg.max_episodes]):
        stats = run_episode(cfg, env, task, get_action, episode_idx=idx)
        episodes.append({"task": task, **stats})
    succ = [e["success"] for e in episodes]
    return {
        "num_episodes": len(episodes),
        "num_successes": int(np.sum(succ)),
        "success_rate": float(np.mean(succ)) if episodes else 0.0,
        "episodes": episodes,
    }
