"""The `push` preset, its data, its MuJoCo env and its trained policy in the
port, against the JAX package, on the CPU.

* The port's `push` preset builds the reference's shapes (every Flax leaf
  of `build_models(..., "push")` loads strictly); on a CUDA device it runs
  the f32 instances of the kernels (tests/test_torch_cuda.py).
* `data/push_data.py` (the prompt row and the resize),
  `eval/mujoco_push_env.py` (observations for the same task, seed and
  actions: images bit-equal, states within 1e-6) and `eval/libero_eval.py`
  (the image helpers, the episode and suite loops) give the reference's
  outputs; the scripted expert succeeds on every task through the port's
  `run_suite_eval`, as artifacts/EVAL_mujoco.json records.
* The trained push policy (artifacts/rft_evidence32/bc_vla.npz +
  rft_expert.npz, the layout of tools/rft_evidence.py's `save_tree`) gives
  JAX's action chunk on recorded frames (segments.npz) with injected flow
  noise within ACTION_ATOL.
* Slow tier: the replay of tools/rft_evidence.py's evaluation protocol in
  the port's env with the port's policy (3 tasks x 20 held-out episodes,
  init states from seed 100, 220 steps in chunks of 8, 10 flow steps, 64 px
  views, proprio = eef pos + axis-angle + gripper): the RFT expert's
  success rate beats the BC expert's by at least 0.25 (JAX's run: 32/60
  against 3/60).  The reference starts every chunk's flow from
  jax.random.key(0)'s point; the port's protocol starts it from a
  torch.Generator seeded with 0 (the same point every chunk), and two more
  cases start it from the reference's own point and from a new point every
  chunk (one generator for the whole replay).  The last case fails: with
  fresh noise every chunk the BC expert succeeds more often than the RFT
  expert (48/60 against 42/60), so the evidence's gain belongs to the one
  start point its protocol uses.
"""
import dataclasses
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vla_rft_tpu.config import vla_rft_default_config as j_default_config
from vla_rft_tpu.data import push_data as j_push
from vla_rft_tpu.eval import libero_eval as j_libero
from vla_rft_tpu.models.factory import build_models as j_build_models
from vla_rft_tpu.models.factory import init_params
from vla_rft_tpu.workers.predict import predict_action as j_predict_action
from vla_rft_tpu_torch.config import vla_rft_default_config
from vla_rft_tpu_torch.convert import flax_to_torch
from vla_rft_tpu_torch.data import push_data as t_push
from vla_rft_tpu_torch.eval import libero_eval as t_libero
from vla_rft_tpu_torch.eval.policy import build_policy_fn
from vla_rft_tpu_torch.models.factory import build_models, build_policy
from vla_rft_tpu_torch.workers.predict import predict_action

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVIDENCE = os.path.join(ROOT, "artifacts", "rft_evidence32")
FAMILIES = ("vla", "expert", "wm", "tokenizer", "lpips")
# tools/rft_evidence.py's make_config: the push data shapes
PUSH = ["data.train_batch_size=8", "data.video.segment_length=9",
        "data.max_prompt_length=87", "data.max_response_length=184",
        "processor.tokens_per_frame=16", "world_model_rollout.rollout.interact_max_tokens=16",
        "actor_rollout_ref.rollout.num_flow_steps=10"]
# the Euler chain is bf16 in both: one bf16 ulp near its largest value
# (|x| ~ 1.2) is 2^-7; measured difference: 0
ACTION_ATOL = 2.0 ** -7
STATE_ATOL = 1e-6


@pytest.fixture(scope="module")
def j_push_bundle():
    bundle = j_build_models(j_default_config().apply_overrides(PUSH), "push")
    shapes = jax.eval_shape(lambda k: init_params(bundle, k), jax.random.key(0))
    return bundle, shapes


def _load_tree(path, like):
    """tools/rft_evidence.py's layout: leaves p0..pN in tree-flatten order."""
    with np.load(path) as z:
        leaves, treedef = jax.tree_util.tree_flatten(like)
        assert len(z.files) == len(leaves)
        return jax.tree_util.tree_unflatten(
            treedef, [np.asarray(z[f"p{i}"], l.dtype) for i, l in enumerate(leaves)])


# ------------------------------------------------------------------ preset
def test_push_preset_matches_the_reference(j_push_bundle):
    jb, shapes = j_push_bundle
    b = build_models(vla_rft_default_config().apply_overrides(PUSH), "push", device="cpu")
    assert (b.policy_image_size, b.image_size, b.policy_seq_len) == (
        jb.policy_image_size, jb.wm_image_size, jb.policy_seq_len) == (64, 32, 32)
    assert b.vla_cfg.num_patches == jb.vla_cfg.num_patches == 64
    assert b.expert_cfg.num_actions_chunk == jb.expert_cfg.num_actions_chunk == 8
    assert b.expert_cfg.num_flow_steps == jb.expert_cfg.num_flow_steps == 10
    assert (b.roll_cfg.prompt_length, b.roll_cfg.response_length) == (87, 184)
    assert b.wm_cfg.hd == 64 and b.vla_cfg.llm.hd == 32
    for m in FAMILIES:
        zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes[m])
        getattr(b, m).load_state_dict(flax_to_torch(zeros, m), strict=True)
        assert all(p.dtype == torch.float32 for p in getattr(b, m).parameters()), m
    # the WM size overrides (the trained push WM is 256 wide x 6 layers)
    ov = ["world_model_rollout.model.size_overrides.hidden_size=256",
          "world_model_rollout.model.size_overrides.num_layers=6"]
    b = build_models(vla_rft_default_config().apply_overrides(PUSH + ov), "push", device="cpu")
    assert (b.wm_cfg.hidden_size, b.wm_cfg.num_layers) == (256, 6)


def test_push_policy_fn_serves_push_views():
    fn = build_policy_fn(preset="push", device="cpu", seed=1)
    obs = {"full_image": np.random.default_rng(0).integers(0, 255, (128, 128, 3), np.uint8),
           "proprio": np.zeros(8, np.float32)}
    assert fn.bundle.policy_image_size == 64
    assert fn.make_batch(obs, "push the cube")["pixels"].shape == (1, 64, 64, 6)
    actions = fn(obs, "push the red cube into the green target zone")
    assert actions.shape == (8, 7) and np.isfinite(actions).all()


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("seq_len,num_tokens,size", [(32, 8, 64), (48, 8, 32), (20, 4, 128)])
def test_push_data_matches_the_reference(seq_len, num_tokens, size):
    for a, b in zip(t_push.build_push_prompt(seq_len, num_tokens),
                    j_push.build_push_prompt(seq_len, num_tokens)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    img = np.random.default_rng(1).integers(0, 255, (128, 128, 3), np.uint8)
    np.testing.assert_array_equal(t_push.resize_uint8(img, size),
                                  j_push.resize_uint8(img, size))


# --------------------------------------------------------------------- env
@pytest.fixture(scope="module")
def envs():
    pytest.importorskip("mujoco")
    from vla_rft_tpu.eval import mujoco_push_env as j_env
    from vla_rft_tpu_torch.eval import mujoco_push_env as t_env

    return t_env, j_env


@pytest.mark.parametrize("task", [0, 1, 2])
def test_push_env_matches_the_reference(envs, task):
    t_env, j_env = envs
    assert t_env.RENDER_VERSION == j_env.RENDER_VERSION
    (te, tl, ts), (je, jl, js) = (m.make_push_env(task, resolution=64, num_init_states=3, seed=5)
                                  for m in (t_env, j_env))
    assert tl == jl
    np.testing.assert_array_equal(ts, js)
    rng = np.random.default_rng(task)

    def same(to, jo):
        np.testing.assert_array_equal(to["agentview_image"], jo["agentview_image"])
        for k in ("robot0_eef_pos", "robot0_eef_quat", "robot0_gripper_qpos"):
            np.testing.assert_allclose(to[k], jo[k], atol=STATE_ATOL, rtol=0)
        np.testing.assert_allclose(te.get_sim_state(), je.get_sim_state(), atol=STATE_ATOL,
                                   rtol=0)

    te.reset(), je.reset()
    same(te.set_init_state(ts[2]), je.set_init_state(js[2]))
    for i in range(24):
        if i % 8 == 0:  # the scripted expert's chunk, then noise on it
            chunk = t_env.scripted_push_expert(te)
            np.testing.assert_allclose(chunk, j_env.scripted_push_expert(je), atol=STATE_ATOL)
        a = np.clip(chunk[i % 8] + rng.normal(scale=0.5, size=7), -1, 1).tolist()
        (to, tr, td, _), (jo, jr, jd, _) = te.step(a), je.step(a)
        assert (tr, td) == (jr, jd)
        same(to, jo)


def test_scripted_expert_succeeds_through_run_suite_eval(envs, tmp_path):
    """artifacts/EVAL_mujoco.json's expert run: 3 tasks x 2 trials at 128 px
    through run_suite_eval, success 1.0 on each; the reference's loop gives
    the same metrics; rollout GIFs written."""
    t_env, j_env = envs
    out = {}
    for name, libero, env_mod, video in (("port", t_libero, t_env, str(tmp_path)),
                                         ("ref", j_libero, j_env, None)):
        cfg = libero.GenerateConfig(task_suite_name="libero_spatial", num_trials_per_task=2,
                                    num_steps_wait=2, resize_size=128, save_video_dir=video)
        live = {}

        def factory(tid, env_mod=env_mod, live=live):
            env, lang, states = env_mod.make_push_env(tid, resolution=128, num_init_states=2)
            live["env"] = env
            return env, lang, states

        def make_expert(env_mod, live):
            # one parameter: run_suite_eval then passes no task language
            return lambda obs: env_mod.scripted_push_expert(live["env"])

        out[name] = libero.run_suite_eval(cfg, make_expert(env_mod, live), factory, 3)
    assert out["port"] == out["ref"]
    assert out["port"]["success_rate"] == 1.0 and all(
        out["port"][f"task_{t}/success"] == 1.0 for t in range(3)), out
    assert len(list(tmp_path.glob("rollout_task*_success=True.gif"))) == 6


def test_libero_eval_helpers_match_the_reference(monkeypatch):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 255, (96, 96, 3), np.uint8)
    np.testing.assert_array_equal(t_libero.resize_image_for_policy(img, 64),
                                  j_libero.resize_image_for_policy(img, 64))
    np.testing.assert_array_equal(t_libero.center_crop_image(img),
                                  j_libero.center_crop_image(img))
    f = rng.random((2, 32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(t_libero.crop_and_resize(f, 0.7),
                                  j_libero.crop_and_resize(f, 0.7))
    for q in ([0, 0, 0, 1.0], [0.1, -0.3, 0.2, 0.9], [1.0, 0, 0, 0]):
        np.testing.assert_array_equal(t_libero.quat2axisangle(np.array(q)),
                                      j_libero.quat2axisangle(np.array(q)))
    assert dataclasses.asdict(t_libero.GenerateConfig()) == dataclasses.asdict(
        j_libero.GenerateConfig())
    assert t_libero.TASK_MAX_STEPS == j_libero.TASK_MAX_STEPS
    # the reference's stand-in env drives both loops
    obs = j_libero.ScriptedEnv(image_size=40).reset()
    for n in (1, 2):
        got = t_libero.prepare_observation(obs, 32, n)
        ref = j_libero.prepare_observation(obs, 32, n)
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
    # the episode loop on the stand-in env: same success, same policy calls
    for succeed_at in (20, None):
        calls = {"port": [], "ref": []}
        for name, lib in (("port", t_libero), ("ref", j_libero)):
            cfg = lib.GenerateConfig(num_steps_wait=3, resize_size=16, num_open_loop_steps=4)
            env = j_libero.ScriptedEnv(horizon=40, succeed_at=succeed_at, image_size=16)
            policy = lambda o, task, c=calls[name]: (c.append((task, float(o["full_image"].mean())))
                                                     or np.zeros((4, 7)))
            calls[name].append(lib.run_episode(env, policy, cfg, 30, initial_state=0,
                                               task_description="t"))
        assert calls["port"] == calls["ref"]


# ------------------------------------------------------ the trained policy
@pytest.fixture(scope="module")
def trained(j_push_bundle):
    """The JAX trees of bc_vla.npz, bc_expert.npz and rft_expert.npz."""
    _, shapes = j_push_bundle
    return {"vla": _load_tree(os.path.join(EVIDENCE, "bc_vla.npz"), shapes["vla"]),
            "bc": _load_tree(os.path.join(EVIDENCE, "bc_expert.npz"), shapes["expert"]),
            "rft": _load_tree(os.path.join(EVIDENCE, "rft_expert.npz"), shapes["expert"])}


@pytest.fixture(scope="module")
def recorded_frames():
    """Six recorded policy views and proprio states of segments.npz."""
    with np.load(os.path.join(EVIDENCE, "segments.npz")) as z:
        rows = np.arange(0, 1536, 197)[:6]
        return z["policy_pixels"][rows], z["proprio"][rows]


def _port_policy(trained, expert):
    p = build_policy("push", device="cpu")
    p.vla.load_state_dict(flax_to_torch(trained["vla"], "vla"), strict=True)
    p.expert.load_state_dict(flax_to_torch(trained[expert], "expert"), strict=True)
    return p


def _policy_batch(pixels64_u8, proprio):
    """tools/rft_evidence.py's `_policy_batch` on the port's prompt."""
    ids, attn, labels = t_push.build_push_prompt(32, 8)
    B = pixels64_u8.shape[0]
    px = pixels64_u8.astype(np.float32) / 255.0
    return {"input_ids": np.tile(ids, (B, 1)), "attention_mask": np.tile(attn, (B, 1)),
            "labels": np.tile(labels, (B, 1)), "pixels": np.concatenate([px, px], axis=-1),
            "proprio": proprio.astype(np.float32)}


def test_trained_push_policy_matches_jax(j_push_bundle, trained, recorded_frames):
    jb, _ = j_push_bundle
    batch = _policy_batch(*recorded_frames)
    key = jax.random.key(0)
    ref = np.asarray(jax.jit(j_predict_action, static_argnums=(0, 1, 6))(
        jb.vla, jb.expert, trained["vla"], trained["rft"], key,
        {k: jnp.asarray(v) for k, v in batch.items()}, 10), np.float32)
    # predict_action draws its start point exactly so: f32 normal -> bf16
    noise = np.array(jax.random.normal(key, ref.shape, jnp.float32))
    p = _port_policy(trained, "rft")
    with torch.no_grad():
        out = predict_action(p.vla, p.expert, {k: torch.as_tensor(v) for k, v in batch.items()},
                             10, noise=torch.from_numpy(noise)).float().numpy()
    assert out.shape == (6, 8, 7) and np.isfinite(out).all() and np.abs(ref).max() > 0.5
    np.testing.assert_allclose(out, ref, atol=ACTION_ATOL, rtol=0)


def replay_success_rate(policy, draw_noise, episodes_per_task=20, max_steps=220, seed=0):
    """tools/rft_evidence.py's `_eval_policy` in the port: per task, held-out
    init states (seed + 100), 128 px renders flipped and resized to 64 px,
    chunks of 8 clipped to [-1, 1], 10 flow steps from the start point
    `draw_noise()` gives for each chunk."""
    from vla_rft_tpu_torch.eval.mujoco_push_env import make_push_env

    successes, total = 0, 0
    for task_id in range(3):
        env, _, init_states = make_push_env(task_id, resolution=128,
                                            num_init_states=episodes_per_task, seed=seed + 100)
        for ep in range(episodes_per_task):
            env.reset()
            obs = env.set_init_state(init_states[ep % len(init_states)])
            done = False
            for _ in range(max_steps // 8):
                img = t_push.resize_uint8(obs["agentview_image"][::-1, ::-1], 64)
                proprio = np.concatenate([obs["robot0_eef_pos"],
                                          t_libero.quat2axisangle(obs["robot0_eef_quat"]),
                                          obs["robot0_gripper_qpos"]])[None]
                batch = {k: torch.as_tensor(v) for k, v in _policy_batch(img[None], proprio).items()}
                with torch.no_grad():
                    chunk = predict_action(policy.vla, policy.expert, batch, 10,
                                           noise=draw_noise()).float().numpy()[0]
                for a in np.clip(chunk, -1, 1):
                    obs, _, done, _ = env.step(a.tolist())
                    if done:
                        break
                if done:
                    break
            successes += int(done)
            total += 1
    return successes / total


def _noise_scheme(name):
    """The start point of each chunk's flow (1, 8, 7).  The reference's
    protocol draws it from jax.random.key(0) for every chunk, so every chunk
    starts from the same point; `torch_seed0_each_chunk` does the same from
    a torch.Generator seeded with 0 (the port's protocol), `jax_key0_each_chunk`
    uses the reference's own point, and `torch_one_stream` draws a new point
    for every chunk from one generator seeded with 0."""
    shape = (1, 8, 7)
    if name == "torch_seed0_each_chunk":
        return lambda: torch.randn(shape, generator=torch.Generator().manual_seed(0))
    if name == "jax_key0_each_chunk":
        point = torch.from_numpy(np.array(jax.random.normal(jax.random.key(0), shape)))
        return lambda: point
    gen = torch.Generator().manual_seed(0)
    return lambda: torch.randn(shape, generator=gen)


@pytest.mark.slow
@pytest.mark.parametrize("noise", ["torch_seed0_each_chunk", "jax_key0_each_chunk",
                                   "torch_one_stream"])
def test_trained_policy_replay_rft_beats_bc(envs, trained, noise):
    rates, seconds = {}, {}
    for expert in ("bc", "rft"):
        t0 = time.perf_counter()
        rates[expert] = replay_success_rate(_port_policy(trained, expert), _noise_scheme(noise))
        seconds[expert] = time.perf_counter() - t0
    print(f"push replay, noise {noise} (3 tasks x 20 episodes): success {rates}, "
          f"wall s {seconds}")
    assert rates["rft"] - rates["bc"] >= 0.25, rates
