"""WidowX gym-style wrapper over the bridge_data_robot service client.

Port of vla_rft_tpu/eval/widowx_gym.py (numpy and the standard library
only).  Counterpart of experiments/robot/bridge/widowx_env.py:1-160 (itself derived
from Octo's example env).  gym is an optional robot-workstation dependency,
so this wrapper is a plain class with the gym step/reset 5-tuple protocol
instead of subclassing gym.Env — the eval loop (eval/bridge_eval.py) only
needs reset/step/get_observation.

Behavior kept from the reference:
- convert_obs (:42-53): the service's flat CHW float image becomes an HWC
  uint8 `image_primary`; proprio is padded [state[:6], 0, state[-1]] to the
  8-dim RLDS training layout.
- a None observation after step means the service connection dropped —
  return a null obs and flag truncation (:100-108).
- reset() moves to the configured start transform with blocking=True (the
  controller re-reads qpos immediately after the call; non-blocking moves
  corrupt the initial state — widowx_env.py:150-155).  The reference asks
  for the XYZ interactively (:131-141); here the cfg pose is used directly
  and interactive nudging belongs to the operator script.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np


def state_to_start_transform(init_ee_pos) -> np.ndarray:
    """The fixed ~15-degree-pitched start orientation with the configured
    XYZ translation (widowx_env.py:142-149)."""
    t = np.array(
        [
            [0.267, 0.000, 0.963, float(init_ee_pos[0])],
            [0.000, 1.000, 0.000, float(init_ee_pos[1])],
            [-0.963, 0.000, 0.267, float(init_ee_pos[2])],
            [0.000, 0.000, 0.000, 1.000],
        ]
    )
    return t


def convert_obs(raw: Dict[str, Any], im_size: int) -> Dict[str, np.ndarray]:
    image = (
        np.asarray(raw["image"]).reshape(3, im_size, im_size).transpose(1, 2, 0) * 255
    ).astype(np.uint8)
    state = np.asarray(raw["state"], np.float64)
    proprio = np.concatenate([state[:6], [0.0], state[-1:]])
    return {
        "image_primary": image,
        "full_image": np.asarray(raw["full_image"]),
        "proprio": proprio,
    }


def null_obs(im_size: int) -> Dict[str, np.ndarray]:
    return {
        "image_primary": np.zeros((im_size, im_size, 3), np.uint8),
        "full_image": np.zeros((480, 640, 3), np.uint8),
        "proprio": np.zeros((8,), np.float64),
    }


def wait_for_obs(client, poll_s: float = 1.0):
    obs = client.get_observation()
    while obs is None:
        time.sleep(poll_s)
        obs = client.get_observation()
    return obs


class WidowXGym:
    def __init__(self, widowx_client, cfg, im_size: int = 256,
                 blocking: bool = True):
        self.client = widowx_client
        self.cfg = cfg
        self.im_size = im_size
        self.blocking = blocking
        self.done = False

    def step(self, action):
        self.client.step_action(np.asarray(action, np.float64),
                                blocking=self.blocking)
        raw = self.client.get_observation()
        truncated = raw is None
        obs = null_obs(self.im_size) if truncated else convert_obs(raw, self.im_size)
        if truncated:
            self.done = True
        return obs, 0.0, False, truncated, {}

    def reset(self, seed: Optional[int] = None, options=None):
        self.done = False
        self.client.reset()
        self.client.move(state_to_start_transform(self.cfg.init_ee_pos),
                         duration=0.8, blocking=True)
        return convert_obs(wait_for_obs(self.client), self.im_size), {}

    def get_observation(self):
        return convert_obs(wait_for_obs(self.client), self.im_size)
