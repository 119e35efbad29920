"""LIBERO evaluation harness.

Port of vla_rft_tpu/eval/libero_eval.py (numpy only at import; PIL is
imported inside the functions that use it).  The MuJoCo push
env (eval/mujoco_push_env.py) runs behind the same env API.

Port of experiments/robot/libero/run_libero_eval.py: draccus-style config
(GenerateConfig :82-132), per-suite episode budgets (:64-70), the episode
loop with the 8-action open-loop queue (:281-366 `deque(maxlen=8)`), and
get_vla_action (openvla_utils.py:746-840).

MuJoCo/LIBERO stays host-side CPU exactly as in the reference (SURVEY §2.8);
the policy is served from a resident predict_action.  The env is
pluggable: `run_suite_eval` takes a factory of (env, language, init
states), such as eval/mujoco_push_env.py's `make_push_env`.  LIBERO's own
env factory, the scripted stand-in env and the letterbox resize are ported
with the LIBERO harness.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

# run_libero_eval.py:64-70
TASK_MAX_STEPS = {
    "libero_spatial": 220,
    "libero_object": 280,
    "libero_goal": 300,
    "libero_10": 520,
    "libero_90": 400,
}


@dataclasses.dataclass
class GenerateConfig:
    """Mirrors run_libero_eval.GenerateConfig (:82-132)."""

    task_suite_name: str = "libero_spatial"
    num_trials_per_task: int = 50
    num_steps_wait: int = 10  # wait for objects to settle
    num_open_loop_steps: int = 8
    resize_size: int = 224
    # cameras per VLA input: third-person (+ wrist when 2) — reference
    # default is 2 (run_libero_eval.py:99); must match the checkpoint's
    # vision backbone (model.num_images_in_input)
    num_images_in_input: int = 2
    # eval-time center crop, required when the checkpoint was trained with
    # random-crop image aug (run_libero_eval.py:102, validate_config :140)
    center_crop: bool = True
    seed: int = 7
    unnorm_key: Optional[str] = None
    # when set, each episode's frames are saved as an animated GIF named
    # like the reference's rollout videos (libero_utils.save_rollout_video
    # writes mp4; GIF keeps us dependency-free — PIL only)
    save_video_dir: Optional[str] = None


def resize_image_for_policy(img: np.ndarray, size: int) -> np.ndarray:
    """openvla_utils.resize_image_for_policy (:551-575): JPEG round-trip
    (training frames were JPEG — distribution matching) then an antialiased
    lanczos3 resize.  PIL's LANCZOS is the same 3-lobe kernel as
    tf.image.resize(method='lanczos3', antialias=True)."""
    import io

    from PIL import Image

    pil = Image.fromarray(np.asarray(img, np.uint8))
    buf = io.BytesIO()
    pil.save(buf, format="JPEG", quality=95)
    pil = Image.open(buf).convert("RGB")
    if pil.size != (size, size):
        pil = pil.resize((size, size), Image.LANCZOS)
    return np.asarray(pil, np.uint8)


def crop_and_resize(image: np.ndarray, crop_scale: float) -> np.ndarray:
    """openvla_utils.crop_and_resize (:577-624) without TF: center-crop a
    float [0,1] image to a box of side sqrt(crop_scale) (of the normalized
    square) and resize back to (H, W) with tf.image.crop_and_resize's
    bilinear sampling (box corners land on corner pixel CENTERS — the
    align-corners grid, NOT tf.image.resize's half-pixel grid).

    image: (H, W, C) or (B, H, W, C) float32 in [0, 1].
    """
    squeeze = image.ndim == 3
    if squeeze:
        image = image[None]
    b, h, w, c = image.shape
    s = float(np.clip(np.sqrt(crop_scale), 0.0, 1.0))
    y1, x1 = (1.0 - s) / 2.0, (1.0 - s) / 2.0
    y2, x2 = y1 + s, x1 + s

    def grid(n_out, n_in, lo, hi):
        # crop_and_resize sampling: lo*(n_in-1) .. hi*(n_in-1) inclusive
        if n_out > 1:
            return lo * (n_in - 1) + np.arange(n_out) * (hi - lo) * (n_in - 1) / (n_out - 1)
        return np.full(1, 0.5 * (lo + hi) * (n_in - 1))

    ys = grid(h, h, y1, y2)
    xs = grid(w, w, x1, x2)
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1i = np.minimum(y0 + 1, h - 1)
    x1i = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0).astype(np.float32)[None, :, None, None]
    wx = (xs - x0).astype(np.float32)[None, None, :, None]
    im = image.astype(np.float32)
    top = im[:, y0][:, :, x0] * (1 - wx) + im[:, y0][:, :, x1i] * wx
    bot = im[:, y1i][:, :, x0] * (1 - wx) + im[:, y1i][:, :, x1i] * wx
    out = top * (1 - wy) + bot * wy
    return out[0] if squeeze else out


def center_crop_image(image: np.ndarray) -> np.ndarray:
    """openvla_utils.center_crop_image (:627-657): 0.9-area center crop +
    resize back, uint8 in/out (convert_image_dtype saturate semantics)."""
    x = np.asarray(image)
    orig_uint8 = x.dtype == np.uint8
    xf = x.astype(np.float32) / 255.0 if orig_uint8 else x.astype(np.float32)
    out = np.clip(crop_and_resize(xf, 0.9), 0.0, 1.0)
    if orig_uint8:
        # tf.image.convert_image_dtype float->uint8: saturate_cast(x * 255.5)
        return np.clip(np.floor(out * 255.5), 0, 255).astype(np.uint8)
    return out


def quat2axisangle(quat: np.ndarray) -> np.ndarray:
    """libero_utils.quat2axisangle (xyzw convention)."""
    q = np.asarray(quat, np.float64)
    w = np.clip(q[3], -1.0, 1.0)
    den = np.sqrt(1.0 - w * w)
    if den < 1e-8:
        return np.zeros(3)
    return (q[:3] * 2.0 * np.arccos(w)) / den


def prepare_observation(
    obs: Dict[str, Any], resize_size: int, num_images_in_input: int = 1
) -> Dict[str, np.ndarray]:
    """run_libero_eval.prepare_observation (:246-262): flip the rendered
    image(s) (agentview + wrist cam when num_images_in_input > 1,
    libero_utils.get_libero_image/get_libero_wrist_image :34-45), resize,
    and assemble proprio = [eef_pos, axis-angle, gripper]."""
    img = obs["agentview_image"][::-1, ::-1]  # LIBERO renders upside down
    img = resize_image_for_policy(img, resize_size)
    proprio = np.concatenate(
        [
            obs["robot0_eef_pos"],
            quat2axisangle(obs["robot0_eef_quat"]),
            obs["robot0_gripper_qpos"],
        ]
    )
    out = {"full_image": img, "proprio": proprio}
    if num_images_in_input > 1 and "robot0_eye_in_hand_image" in obs:
        wrist = obs["robot0_eye_in_hand_image"][::-1, ::-1]
        out["wrist_image"] = resize_image_for_policy(wrist, resize_size)
    return out


def save_rollout_video(
    frames: List[np.ndarray], out_dir: str, tag: str, success: bool, fps: int = 30
) -> str:
    """Animated-GIF analog of libero_utils.save_rollout_video (mp4 there);
    filename carries the success flag the same way."""
    import os

    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"rollout_{tag}_success={success}.gif")
    imgs = [Image.fromarray(np.asarray(f, np.uint8)) for f in frames]
    if imgs:
        imgs[0].save(
            path, save_all=True, append_images=imgs[1:],
            duration=max(1, 1000 // fps), loop=0,
        )
    return path


def run_episode(
    env,
    get_action_chunk: Callable[[Dict[str, np.ndarray]], np.ndarray],
    cfg: GenerateConfig,
    max_steps: int,
    initial_state=None,
    video_tag: Optional[str] = None,
    task_description: Optional[str] = None,
) -> bool:
    """Episode loop with the open-loop action queue
    (run_libero_eval.py:281-366).

    When `task_description` is given the policy is called as
    `get_action_chunk(observation, task_description)` — the reference
    prompts the VLA with the task language (run_libero_eval.py:330,
    get_vla_action's task_label arg); single-arg policies (tests, scripted
    experts) keep working with task_description=None."""
    env.reset()
    if initial_state is not None:
        obs = env.set_init_state(initial_state)
    else:
        obs = env.reset()

    action_queue: deque = deque(maxlen=cfg.num_open_loop_steps)
    t = 0
    success = False
    replay: List[np.ndarray] = []
    record = cfg.save_video_dir is not None
    dummy = np.zeros(7)
    dummy[-1] = -1  # gripper open no-op while settling
    while t < max_steps + cfg.num_steps_wait:
        if t < cfg.num_steps_wait:
            obs, reward, done, info = env.step(dummy.tolist())
            t += 1
            continue
        observation = prepare_observation(
            obs, cfg.resize_size, cfg.num_images_in_input
        )
        if record and "full_image" in observation:
            replay.append(observation["full_image"])
        if len(action_queue) == 0:
            if task_description is not None:
                chunk = get_action_chunk(observation, task_description)
            else:
                chunk = get_action_chunk(observation)  # (chunk, 7)
            action_queue.extend(chunk)
        action = action_queue.popleft()
        obs, reward, done, info = env.step(np.asarray(action).tolist())
        if done:
            success = True
            break
        t += 1
    if record and replay:
        save_rollout_video(
            replay, cfg.save_video_dir, video_tag or "episode", success
        )
    return success


def run_suite_eval(
    cfg: GenerateConfig,
    get_action_chunk: Callable[[Dict[str, np.ndarray]], np.ndarray],
    env_factory: Callable[[int], Tuple[Any, str, Any]],
    num_tasks: int,
) -> Dict[str, float]:
    """run_libero_eval.main loop: 50 trials/task, suite-level success rate."""
    max_steps = TASK_MAX_STEPS.get(cfg.task_suite_name, 300)
    total, success = 0, 0
    per_task: Dict[int, float] = {}
    # policies that take the task language get it (reference behavior);
    # single-arg scripted policies don't
    import inspect

    try:
        accepts_task = len(inspect.signature(get_action_chunk).parameters) >= 2
    except (TypeError, ValueError):
        accepts_task = False
    for task_id in range(num_tasks):
        env, lang, init_states = env_factory(task_id)
        task_success = 0
        for ep in range(cfg.num_trials_per_task):
            init = init_states[ep % len(init_states)] if init_states is not None else None
            ok = run_episode(
                env, get_action_chunk, cfg, max_steps, init,
                video_tag=f"task{task_id}_ep{ep}",
                task_description=lang if accepts_task else None,
            )
            task_success += int(ok)
            total += 1
            success += int(ok)
        per_task[task_id] = task_success / cfg.num_trials_per_task
    return {
        "success_rate": success / max(total, 1),
        **{f"task_{k}/success": v for k, v in per_task.items()},
    }
