"""Real-physics eval environment: a MuJoCo push task behind the LIBERO
`OffScreenRenderEnv` API surface.

Port of vla_rft_tpu/eval/mujoco_push_env.py (numpy only at import: `mujoco`
and PIL are imported inside the functions that use them, so this module
imports where neither is installed).

LIBERO itself is not installable in this image and MuJoCo's GL renderers
(OSMesa/EGL) have no usable context here, so this env pairs REAL MuJoCo
dynamics (contacts, friction, a weld-driven effector — the same physics
engine LIBERO runs on) with a dependency-free pinhole software renderer
(PIL polygon rasterization of the camera-projected scene geometry).

It exposes exactly the API the eval glue consumes
(run_libero_eval.py:281-366 / libero_utils.get_libero_env):

  env.reset() / env.set_init_state(state) -> obs
  env.step(list[7]) -> (obs, reward, done, info)
  obs keys: agentview_image (H, W, 3 uint8, rendered upside-down like
  OffScreenRenderEnv), robot0_eef_pos, robot0_eef_quat (xyzw),
  robot0_gripper_qpos

so `prepare_observation`'s flip, the proprio assembly, `run_episode`'s
double-reset + set_init_state, and `run_suite_eval` all run unchanged
against genuine physics.  Task: push the red cube into the green target
zone; actions follow the LIBERO convention (dx,dy,dz, 3 rot dims, gripper).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

_PUSH_XML = """
<mujoco model="push">
  <option timestep="0.004" integrator="implicitfast"/>
  <worldbody>
    <geom name="table" type="plane" size="0.6 0.6 0.05" pos="0 0 0"
          friction="0.8 0.005 0.0001" rgba="0.55 0.45 0.35 1"/>
    <site name="target" type="cylinder" size="{target_r} 0.001"
          pos="{tx} {ty} 0.001" rgba="0.1 0.8 0.1 0.5"/>
    <body name="cube" pos="{cx} {cy} 0.025">
      <freejoint name="cube_free"/>
      <geom name="cube_geom" type="box" size="0.025 0.025 0.025" mass="0.1"
            friction="0.8 0.005 0.0001" rgba="0.85 0.1 0.1 1"/>
    </body>
    <body name="pusher" mocap="true" pos="{px} {py} 0.03">
      <geom name="pusher_geom" type="sphere" size="0.02" density="0"
            contype="1" conaffinity="1" rgba="0.2 0.3 0.9 1"/>
    </body>
  </worldbody>
</mujoco>
"""


# Observation-distribution version: bumped whenever the camera framing,
# marker sizes, or anything else that changes rendered pixels changes.
# v1 = original oblique view (round-3 artifacts); v2 = round-4 near-top-down
# zoom + enlarged cube/pusher markers.  Segment archives record this tag
# (the reference's push_data.save_segments) so stale datasets are detected
# at load.
RENDER_VERSION = 2


class _PinholeCamera:
    """Fixed perspective camera: world -> 2D pixel projection (the software
    'agentview').  The default is a near-top-down zoom framing the ±0.30
    task workspace: at low WM resolutions (32x32) the original oblique view
    (eye (0.85,0,0.75), f=1.2*res) left the cube under 2 pixels wide, which
    starves a world model of any action-conditioned visual signal."""

    def __init__(
        self,
        res: int,
        eye: Tuple[float, float, float] = (0.08, 0.0, 0.75),
        f_mult: float = 1.12,
    ):
        self.res = res
        self.eye = np.array(eye, np.float64)
        look = np.array([0.0, 0.0, 0.0])
        fwd = look - self.eye
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        self.rot = np.stack([right, up, fwd])  # world->cam rows
        self.f = res * f_mult  # focal in pixels

    def project(self, pts: np.ndarray) -> np.ndarray:
        """(N,3) world -> (N,2) pixel (x right, y down)."""
        cam = (np.asarray(pts, np.float64) - self.eye) @ self.rot.T
        z = np.maximum(cam[:, 2], 1e-4)
        x = self.f * cam[:, 0] / z + self.res / 2
        y = -self.f * cam[:, 1] / z + self.res / 2
        return np.stack([x, y], axis=1)


def _box_corners(center: np.ndarray, quat_wxyz: np.ndarray, half: float) -> np.ndarray:
    """8 world-space corners of a cube given MuJoCo's wxyz quaternion."""
    w, x, y, z = quat_wxyz
    R = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
    signs = np.array(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
        np.float64,
    )
    return center[None, :] + (signs * half) @ R.T


class MujocoPushEnv:
    """LIBERO-surface push task on real MuJoCo physics (see module doc)."""

    # cube start / target center per task variant (a tiny 'suite')
    TASKS: List[Tuple[Tuple[float, float], Tuple[float, float]]] = [
        ((0.05, 0.10), (0.00, -0.22)),
        ((-0.10, -0.05), (0.18, 0.15)),
        ((0.00, 0.00), (-0.22, 0.10)),
    ]

    def __init__(
        self,
        task_id: int = 0,
        camera_heights: int = 256,
        camera_widths: int = 256,
        target_radius: float = 0.07,
        action_scale: float = 0.02,
        sim_steps_per_action: int = 10,
        visual_cube_half: float = 0.045,
        visual_pusher_r: float = 0.035,
    ):
        import mujoco  # deferred heavy import (CPU-only)

        self._mujoco = mujoco
        assert camera_heights == camera_widths, "square cameras only"
        (cx, cy), (tx, ty) = self.TASKS[task_id % len(self.TASKS)]
        self._start = np.array([cx, cy])
        self._target = np.array([tx, ty])
        self.target_radius = target_radius
        self.action_scale = action_scale
        self.sim_steps_per_action = sim_steps_per_action
        self.res = camera_heights
        xml = _PUSH_XML.format(
            cx=cx, cy=cy, tx=tx, ty=ty, target_r=target_radius,
            px=cx - 0.09 * np.sign(cx - tx + 1e-9) if cx != tx else cx - 0.09,
            py=cy,
        )
        self.model = mujoco.MjModel.from_xml_string(xml)
        self.data = mujoco.MjData(self.model)
        self._cube_bid = mujoco.mj_name2id(
            self.model, mujoco.mjtObj.mjOBJ_BODY, "cube"
        )
        self._cube_jnt_qpos = self.model.jnt_qposadr[
            mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_JOINT, "cube_free")
        ]
        self.visual_cube_half = visual_cube_half
        self.visual_pusher_r = visual_pusher_r
        self._cam = _PinholeCamera(self.res)
        self._grip = 0.04  # virtual 2-finger opening, driven by action[6]
        mujoco.mj_forward(self.model, self.data)

    # ------------------------------------------------------------ state I/O
    @property
    def cube_pos(self) -> np.ndarray:
        return np.array(self.data.xpos[self._cube_bid])

    def _succeeded(self) -> bool:
        return bool(
            np.linalg.norm(self.cube_pos[:2] - self._target)
            < self.target_radius
        )

    def get_sim_state(self) -> np.ndarray:
        """Flat [qpos, qvel, mocap_xy] — the LIBERO init-state analog."""
        return np.concatenate(
            [self.data.qpos, self.data.qvel, self.data.mocap_pos[0, :2]]
        )

    def _obs(self) -> Dict[str, np.ndarray]:
        mp = self.data.mocap_pos[0]
        return {
            # OffScreenRenderEnv frames arrive upside-down; the glue's
            # [::-1, ::-1] flip undoes this
            "agentview_image": self._render()[::-1, ::-1],
            "robot0_eef_pos": np.array(mp),
            "robot0_eef_quat": np.array([0.0, 0.0, 0.0, 1.0]),  # xyzw
            "robot0_gripper_qpos": np.array([self._grip, -self._grip]),
        }

    # ------------------------------------------------------------- protocol
    def reset(self):
        self._mujoco.mj_resetData(self.model, self.data)
        self._grip = 0.04
        self._mujoco.mj_forward(self.model, self.data)
        return self._obs()

    def set_init_state(self, state):
        state = np.asarray(state, np.float64)
        nq, nv = self.model.nq, self.model.nv
        self.data.qpos[:] = state[:nq]
        self.data.qvel[:] = state[nq : nq + nv]
        self.data.mocap_pos[0, :2] = state[nq + nv : nq + nv + 2]
        self._mujoco.mj_forward(self.model, self.data)
        return self._obs()

    def step(self, action):
        a = np.asarray(action, np.float64)
        assert a.shape == (7,), f"LIBERO actions are 7-dim, got {a.shape}"
        delta = np.clip(a[:3], -1.0, 1.0) * self.action_scale
        # effector is position-driven (mocap weld = OSC-position analog);
        # keep it on the table and inside the workspace
        start = np.array(self.data.mocap_pos[0])
        tgt = start + delta
        tgt[0] = np.clip(tgt[0], -0.55, 0.55)
        tgt[1] = np.clip(tgt[1], -0.55, 0.55)
        tgt[2] = np.clip(tgt[2], 0.03, 0.3)
        self._grip = float(np.clip(self._grip - 0.01 * a[6], 0.0, 0.04))
        # move the effector gradually across the substeps (quasi-static
        # push) — teleporting the full delta imparts impulsive kicks
        n = self.sim_steps_per_action
        for k in range(n):
            self.data.mocap_pos[0] = start + (tgt - start) * (k + 1) / n
            self._mujoco.mj_step(self.model, self.data)
        done = self._succeeded()
        return self._obs(), float(done), done, {}

    def close(self):
        pass

    # ------------------------------------------------------------ rendering
    def _render(self) -> np.ndarray:
        """Software agentview: PIL-rasterized pinhole projection of the real
        simulator state (table, target zone, cube faces, pusher)."""
        from PIL import Image, ImageDraw

        img = Image.new("RGB", (self.res, self.res), (138, 158, 178))  # sky
        draw = ImageDraw.Draw(img)

        def poly(world_pts, color):
            px = self._cam.project(np.asarray(world_pts, np.float64))
            draw.polygon([tuple(p) for p in px], fill=color)

        s = 0.6
        poly(
            [[-s, -s, 0], [s, -s, 0], [s, s, 0], [-s, s, 0]],
            (140, 115, 90),
        )  # table
        th = np.linspace(0, 2 * np.pi, 24)
        ring = np.stack(
            [
                self._target[0] + self.target_radius * np.cos(th),
                self._target[1] + self.target_radius * np.sin(th),
                np.full_like(th, 0.002),
            ],
            axis=1,
        )
        poly(ring, (40, 190, 40))  # target zone

        # visual marker sizes are LARGER than the physical geoms (cube half
        # 0.025, pusher r 0.02): a fiducial-marker-style observation choice
        # so the objects survive 32x32 WM downsampling; physics, the scripted
        # expert's clearances, and success detection are untouched
        corners = _box_corners(
            self.cube_pos, np.array(self.data.xquat[self._cube_bid]),
            self.visual_cube_half,
        )
        # painter's order: top face last; faces as corner-index quads
        faces = [
            (0, 1, 3, 2), (4, 5, 7, 6), (0, 1, 5, 4),
            (2, 3, 7, 6), (1, 3, 7, 5),
        ]
        shades = [(150, 20, 20), (220, 40, 40), (180, 30, 30),
                  (180, 30, 30), (235, 60, 60)]
        order = np.argsort(
            [corners[list(f)][:, 2].mean() for f in faces]
        )
        for i in order:
            poly(corners[list(faces[i])], shades[i])

        mp = self.data.mocap_pos[0]
        c = self._cam.project(mp[None, :])[0]
        r = max(
            3.0,
            self._cam.f
            * self.visual_pusher_r
            / max(np.linalg.norm(mp - self._cam.eye), 1e-3),
        )
        draw.ellipse([c[0] - r, c[1] - r, c[0] + r, c[1] + r], fill=(50, 70, 230))
        return np.asarray(img, np.uint8)


def make_push_env(
    task_id: int, resolution: int = 256, num_init_states: int = 8, seed: int = 0
):
    """An env factory for `run_suite_eval`, shaped as LIBERO's
    (libero_utils.get_libero_env): (env, language, init_states).

    Init states perturb the cube start position slightly, mirroring LIBERO's
    per-task recorded init-state bank."""
    env = MujocoPushEnv(
        task_id, camera_heights=resolution, camera_widths=resolution
    )
    rng = np.random.default_rng((seed, task_id))
    base = env.reset()
    del base
    states = []
    for _ in range(num_init_states):
        env.reset()
        jitter = rng.uniform(-0.02, 0.02, 2)
        env.data.qpos[env._cube_jnt_qpos : env._cube_jnt_qpos + 2] += jitter
        env._mujoco.mj_forward(env.model, env.data)
        states.append(env.get_sim_state())
    env.reset()
    lang = "push the red cube into the green target zone"
    return env, lang, np.stack(states)


def scripted_push_expert(env: MujocoPushEnv, chunk: int = 8) -> "np.ndarray":
    """Privileged scripted expert emitting LIBERO-convention action chunks:
    line up behind the cube (relative to the target), then push through it.
    Used to produce a success=True artifact exercising the full glue."""
    actions = np.zeros((chunk, 7), np.float32)
    cube = env.cube_pos[:2]
    eff = np.array(env.data.mocap_pos[0][:2])  # kinematic preview
    z = float(env.data.mocap_pos[0][2])
    to_tgt = env._target - cube
    d = np.linalg.norm(to_tgt)
    if d < 1e-6:
        return actions
    dir_t = to_tgt / d
    perp = np.array([-dir_t[1], dir_t[0]])
    far_behind = cube - dir_t * 0.12
    # phase is fixed for the whole chunk (the open-loop queue replans only
    # when it drains) — per-step phase flips oscillate at the boundary
    along = float(np.dot(eff - cube, dir_t))  # <0 = behind the cube
    lateral = float(np.dot(eff - cube, perp))
    aligned = along < -0.05 and abs(lateral) < 0.03
    tgt2 = None
    if not aligned:
        # stage at far_behind; detour laterally first if the straight path
        # would clip the cube (clearance = cube half-diag + pusher radius)
        seg = far_behind - eff
        seg_n = np.linalg.norm(seg)
        t = np.clip(np.dot(cube - eff, seg) / max(seg_n**2, 1e-9), 0, 1)
        closest = eff + t * seg
        tgt2 = far_behind
        if np.linalg.norm(closest - cube) < 0.075 and seg_n > 0.04:
            side = np.sign(lateral) or 1.0
            way = cube + perp * side * 0.13
            if np.linalg.norm(eff - way) > 0.02:
                tgt2 = way
    push_remaining = d + 0.01  # stop the push once the cube should be home
    for i in range(chunk):
        if tgt2 is None:
            if push_remaining <= 0:
                break
            move = dir_t * min(1.0, push_remaining / env.action_scale)
            push_remaining -= env.action_scale
        else:
            move = tgt2 - eff
        # preserve direction under the per-dim action clip: scale by the
        # inf-norm instead of clipping each component
        m = np.max(np.abs(move))
        step = (
            move / max(m, 1e-9) * min(1.0, m / env.action_scale)
            if m > 0
            else np.zeros(2)
        )
        actions[i, :2] = step
        actions[i, 2] = np.clip((0.03 - z) / env.action_scale, -1, 1)
        actions[i, 6] = -1.0
        eff = eff + step * env.action_scale
        z = float(np.clip(z + actions[i, 2] * env.action_scale, 0.03, 0.3))
    return actions
