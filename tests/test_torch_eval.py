"""The port's eval surface against the JAX package on the CPU.

* The multi-view policy (tiny preset, 2 and 3 camera views): the port's
  `encode_context` / `predict_action` against the jitted JAX functions with
  the same weights (converted by `convert.flax_to_torch`) and the same
  injected flow noise, at `tests/test_torch_policy.py`'s tolerances; the
  serving glue (`eval/policy.py`: pixels, prompt, proprio, action
  post-processing) against the reference's at 2 and 3 views.
* `eval/libero_eval.py`'s `ScriptedEnv`, `make_libero_env` (under stand-in
  `libero` modules) and `letterbox_image`, bit for bit.
* `eval/main_eval.py`: both CLIs at `--preset tiny --scripted_env`, each
  package's `build_policy_fn` wrapped to record what it is given and what
  its policy is handed; the flag parsing and the device guard.
* `eval/aloha_eval.py`, `eval/bridge_eval.py`, `eval/widowx_gym.py`: both
  packages' harnesses driven by the same fake rigs and the same
  deterministic chunk function, and one ALOHA run through the port's
  `ActionServer` serving the tiny 3-view policy.
"""
import argparse
import json
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vla_rft_tpu.config import vla_rft_default_config
from vla_rft_tpu.data import prompting as j_prompting
from vla_rft_tpu.eval import aloha_eval as j_aloha
from vla_rft_tpu.eval import bridge_eval as j_bridge
from vla_rft_tpu.eval import libero_eval as j_libero
from vla_rft_tpu.eval import main_eval as j_main
from vla_rft_tpu.eval import policy as j_policy
from vla_rft_tpu.eval import widowx_gym as j_widowx
from vla_rft_tpu.models import factory as j_factory
from vla_rft_tpu.workers import predict as j_predict
from vla_rft_tpu.workers.flow_actor import encode_context as j_encode_context
from vla_rft_tpu_torch.config import PolicyConfig
from vla_rft_tpu_torch.convert import flax_to_torch
from vla_rft_tpu_torch.eval import aloha_eval as t_aloha
from vla_rft_tpu_torch.eval import bridge_eval as t_bridge
from vla_rft_tpu_torch.eval import libero_eval as t_libero
from vla_rft_tpu_torch.eval import main_eval as t_main
from vla_rft_tpu_torch.eval import policy as t_policy
from vla_rft_tpu_torch.eval import widowx_gym as t_widowx
from vla_rft_tpu_torch.models.factory import build_policy
from vla_rft_tpu_torch.serving.action_server import ActionServer, get_action_from_server
from vla_rft_tpu_torch.workers import predict as t_predict

from test_torch_policy import ACTION_ATOL, ATOL, RTOL, _batch, _random_tree

VIEWS = [2, 3]
ALOHA_KEYS = ("full_image", "left_wrist_image", "right_wrist_image")

_j_encode = jax.jit(j_encode_context, static_argnums=0)
_j_predict = jax.jit(j_predict.predict_action, static_argnums=(0, 1, 6))


def _jax_bundle(views):
    config = vla_rft_default_config()
    config.actor_rollout_ref.model.num_images_in_input = views
    return j_factory.build_models(config, preset="tiny")


@pytest.fixture(scope="module")
def policies():
    """The JAX package's tiny VLA + expert at 2 and 3 views and the port's
    tiny policies carrying the same weights (the views share the towers and
    the projector, so one tree serves every view count)."""
    one = _jax_bundle(1)
    shapes = jax.eval_shape(lambda key: j_factory.init_params(one, key), jax.random.key(0))
    vp, ep = _random_tree(shapes["vla"], 0), _random_tree(shapes["expert"], 1)
    out = {"vp": vp, "ep": ep}
    for views in VIEWS:
        port = build_policy("tiny", PolicyConfig(num_images_in_input=views), device="cpu")
        port.vla.load_state_dict(flax_to_torch(vp, "vla"), strict=True)
        port.expert.load_state_dict(flax_to_torch(ep, "expert"), strict=True)
        out[views] = {"jax": _jax_bundle(views), "port": port}
    return out


@pytest.mark.parametrize("views", VIEWS)
def test_multi_view_encode_context_matches_jax(policies, views):
    p = policies[views]
    jb, tb = _batch(10 + views, p["port"].vla_cfg, views=views)
    ref = np.asarray(_j_encode(p["jax"].vla, policies["vp"], jb))
    with torch.no_grad():
        out = t_predict.encode_context(p["port"].vla, tb).numpy()
    # every view's 4 patches, then the 8 action queries
    assert out.shape == ref.shape == (2, 4 * views + 8, 32)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("views", VIEWS)
def test_multi_view_predict_action_matches_jax(policies, views):
    p = policies[views]
    jb, tb = _batch(20 + views, p["port"].vla_cfg, views=views)
    key = jax.random.key(views)
    ref = np.asarray(_j_predict(p["jax"].vla, p["jax"].expert, policies["vp"], policies["ep"],
                                key, jb, 10), np.float32)
    noise = np.array(jax.random.normal(key, (2, 8, 7), jnp.float32))
    with torch.no_grad():
        out = t_predict.predict_action(p["port"].vla, p["port"].expert, tb, 10,
                                       noise=torch.from_numpy(noise)).float().numpy()
    assert out.shape == (2, 8, 7) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=ACTION_ATOL, rtol=0)


def _camera(seed, h=224, w=224):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _aloha_request(seed):
    """An ALOHA observation as the harness sends it: three views in the
    harness's key order, then the 14-dof state."""
    obs = {k: _camera(seed + i) for i, k in enumerate(ALOHA_KEYS)}
    obs["state"] = np.random.default_rng(seed).normal(size=14).astype(np.float32)
    return obs


@pytest.mark.parametrize("center_crop", [False, True])
def test_assemble_pixels_on_aloha_views_matches_reference(center_crop):
    obs = _aloha_request(3)
    for views in (1, 2, 3):
        got = t_policy.assemble_pixels(obs, views, center_crop)
        np.testing.assert_array_equal(got, j_policy.assemble_pixels(obs, views, center_crop))
        assert got.shape == (224, 224, 6 * views)


@pytest.mark.parametrize("views", VIEWS)
def test_multi_view_policy_glue_matches_reference(policies, views):
    """`build_policy_fn`'s request -> tensors step and its action
    post-processing against the reference's policy_fn body (the same JAX
    package calls in the same order: build_vla_sample, pad_collate,
    assemble_pixels, the bilinear resize to the preset's 28 px, proprio cut
    or padded to 8), then predict_action on each package's batch with the
    same weights and noise."""
    p = policies[views]
    policy_fn = t_policy.build_policy_fn(num_images=views, center_crop=True, preset="tiny",
                                         device="cpu")
    policy_fn.bundle.vla.load_state_dict(p["port"].vla.state_dict())
    policy_fn.bundle.expert.load_state_dict(p["port"].expert.state_dict())
    obs, task = _aloha_request(30 + views), "fold the towel in half"
    batch = policy_fn.make_batch(obs, task)

    bundle = p["jax"]
    s = j_prompting.build_vla_sample(t_policy._StubTokenizer(), task, None,
                                     num_tokens=bundle.vla_cfg.num_tokens)
    coll = j_prompting.pad_collate([s], pad_token_id=151643,
                                   max_length=max(bundle.policy_seq_len, len(s["input_ids"])))
    six = j_policy.assemble_pixels(obs, views, True)
    P = bundle.policy_image_size
    six = np.asarray(jax.image.resize(jnp.asarray(six), (P, P, six.shape[-1]), "bilinear"))
    proprio = np.asarray(obs["state"], np.float32)[:bundle.vla_cfg.proprio_dim]
    jb = {"input_ids": jnp.asarray(coll["input_ids"], jnp.int32),
          "labels": jnp.asarray(coll["labels"], jnp.int32),
          "attention_mask": jnp.asarray(coll["attention_mask"], jnp.int32),
          "pixels": jnp.asarray(six)[None], "proprio": jnp.asarray(proprio)[None]}
    for k in ("input_ids", "labels", "attention_mask", "proprio"):
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(jb[k]), err_msg=k)
    assert batch["pixels"].shape == (1, 28, 28, 6 * views)
    np.testing.assert_allclose(batch["pixels"].numpy(), np.asarray(jb["pixels"]),
                               atol=1e-5, rtol=1e-5)

    key = jax.random.key(40 + views)
    ref = np.asarray(_j_predict(bundle.vla, bundle.expert, policies["vp"], policies["ep"],
                                key, jb, 10), np.float32)[0]
    noise = torch.from_numpy(np.array(jax.random.normal(key, (1, 8, 7), jnp.float32)))
    with torch.no_grad():
        got = t_predict.predict_action(policy_fn.bundle.vla, policy_fn.bundle.expert, batch,
                                       10, noise=noise).float().numpy()[0]
    np.testing.assert_allclose(got, ref, atol=ACTION_ATOL, rtol=0)
    stats = {"q01": -np.linspace(1, 2, 7), "q99": np.linspace(1, 3, 7)}
    post = lambda m, a: m.invert_gripper_action(
        m.normalize_gripper_action(m.unnormalize_actions(a, stats), binarize=True))
    np.testing.assert_array_equal(post(t_predict, got), post(j_predict, got))


# ------------------------------------------------------------ libero_eval


@pytest.mark.parametrize("shape", [(40, 24, 3), (24, 40, 3), (32, 32, 3)],
                         ids=["tall", "wide", "square"])
def test_letterbox_image_bit_equal(shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    got = t_libero.letterbox_image(img, 20)
    np.testing.assert_array_equal(got, j_libero.letterbox_image(img, 20))
    assert got.shape == (20, 20, 3) and got.dtype == np.uint8


def test_scripted_env_observations_equal():
    envs = [m.ScriptedEnv(succeed_at=6, image_size=16) for m in (t_libero, j_libero)]
    seqs = [[e.reset(), e.set_init_state(None)] for e in envs]
    for e, seq in zip(envs, seqs):
        for k in range(7):
            obs, reward, done, info = e.step([0.0] * 7)
            seq.append((obs, reward, done, info))
    for a, b in zip(*seqs):
        obs_a, obs_b = (a[0], b[0]) if isinstance(a, tuple) else (a, b)
        assert obs_a.keys() == obs_b.keys()
        for k in obs_a:
            np.testing.assert_array_equal(obs_a[k], obs_b[k])
            assert obs_a[k].dtype == obs_b[k].dtype
        if isinstance(a, tuple):
            assert a[1:] == b[1:]
    assert seqs[0][-2][2] is True  # done at step 6


class _FakeOffScreenRenderEnv:
    def __init__(self, **kwargs):
        self.kwargs = kwargs


@pytest.fixture()
def fake_libero(monkeypatch):
    """Stand-in `libero` modules with the import surface make_libero_env
    uses (as tests/test_libero_glue.py installs)."""

    class _Task:
        language = "pick up the black bowl"

    class _Suite:
        def get_task(self, task_id):
            return _Task()

        def get_task_bddl_file_path(self, task_id):
            return f"/fake/task_{task_id}.bddl"

        def get_task_init_states(self, task_id):
            return [np.full(8, task_id, np.float32), np.full(8, task_id + 10, np.float32)]

    benchmark = types.ModuleType("libero.libero.benchmark")
    benchmark.get_benchmark_dict = lambda: {"libero_goal": _Suite}
    envs = types.ModuleType("libero.libero.envs")
    envs.OffScreenRenderEnv = _FakeOffScreenRenderEnv
    pkg, sub = types.ModuleType("libero"), types.ModuleType("libero.libero")
    sub.benchmark, pkg.libero = benchmark, sub
    for name, mod in [("libero", pkg), ("libero.libero", sub),
                      ("libero.libero.benchmark", benchmark), ("libero.libero.envs", envs)]:
        monkeypatch.setitem(sys.modules, name, mod)


def test_make_libero_env_matches_reference(fake_libero):
    got = [m.make_libero_env("libero_goal", 3, resolution=128) for m in (t_libero, j_libero)]
    (env_t, lang_t, init_t), (env_j, lang_j, init_j) = got
    assert type(env_t) is type(env_j) is _FakeOffScreenRenderEnv
    assert env_t.kwargs == env_j.kwargs == {"bddl_file_name": "/fake/task_3.bddl",
                                            "camera_heights": 128, "camera_widths": 128}
    assert lang_t == lang_j == "pick up the black bowl"
    for a, b in zip(init_t, init_j, strict=True):
        np.testing.assert_array_equal(a, b)


def test_make_libero_env_raises_without_libero(monkeypatch):
    monkeypatch.setitem(sys.modules, "libero", None)
    for m in (t_libero, j_libero):
        with pytest.raises(ImportError):
            m.make_libero_env("libero_spatial", 0)


# -------------------------------------------------------------- main_eval


def _recording_build(real, record):
    """`build_policy_fn` wrapped: records its keyword arguments, and every
    (observation, task) its policy is handed, then runs the real policy."""

    def build(**kwargs):
        record["build_kwargs"] = kwargs
        policy_fn = real(**kwargs)

        def policy(observation, task_description):
            record["calls"].append(({k: np.array(v) for k, v in observation.items()},
                                    task_description))
            chunk = np.asarray(policy_fn(observation, task_description))
            record["chunks"].append(chunk)
            return chunk

        return policy

    return build


@pytest.fixture()
def tiny_jax_build(policies, monkeypatch):
    """The reference's build_policy_fn at the tiny preset, made cheap: its
    parameters come from the module fixture (its own init_params initialises
    every model of the bundle, about 80 s on the CPU) and `transformers` is
    left unimported (the stub tokenizer serves, as without a checkpoint)."""
    monkeypatch.setattr(j_factory, "init_params", lambda bundle, key: {
        "vla": policies["vp"], "expert": policies["ep"]})
    monkeypatch.setitem(sys.modules, "transformers", None)


def _run_cli(module, policy_module, argv, monkeypatch, capsys):
    record = {"calls": [], "chunks": []}
    monkeypatch.setattr(policy_module, "build_policy_fn",
                        _recording_build(policy_module.build_policy_fn, record))
    module.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1]), record


def test_main_eval_scripted_env_matches_reference(tiny_jax_build, monkeypatch, capsys):
    argv = ["--preset", "tiny", "--scripted_env"]
    ref, j_rec = _run_cli(j_main, j_policy, argv, monkeypatch, capsys)
    got, t_rec = _run_cli(t_main, t_policy, argv + ["--device", "cpu"], monkeypatch, capsys)
    assert got == ref == {"success_rate": 1.0, "task_0/success": 1.0}
    assert t_rec["build_kwargs"] == {**j_rec["build_kwargs"], "device": "cpu"}
    assert j_rec["build_kwargs"] == {"ckpt": "", "seed": 7, "num_images": 2, "center_crop": True,
                                "preset": "tiny"}
    # ScriptedEnv succeeds at its step 12: 2 settling steps, then 10 policy
    # steps from queues of 8 actions -> 2 queries
    assert len(t_rec["calls"]) == len(j_rec["calls"]) == 2
    for (obs_t, task_t), (obs_j, task_j) in zip(t_rec["calls"], j_rec["calls"]):
        assert task_t == task_j == "scripted"
        assert list(obs_t) == list(obs_j) == ["full_image", "proprio", "wrist_image"]
        for k in obs_t:
            np.testing.assert_array_equal(obs_t[k], obs_j[k])
            assert obs_t[k].dtype == obs_j[k].dtype
    for chunk in t_rec["chunks"] + j_rec["chunks"]:
        assert chunk.shape == (8, 7) and np.isfinite(chunk).all()


def test_main_eval_center_crop_flag_and_image_aug_assertion(monkeypatch, capsys):
    for m in (t_main, j_main):
        assert [m._strict_bool(s) for s in ("true", "1", "YES", "False", "0", "no")] == [
            True, True, True, False, False, False]
        with pytest.raises(argparse.ArgumentTypeError):
            m._strict_bool("maybe")
        with pytest.raises(AssertionError, match="center_crop==True"):
            m.main(["--ckpt", "/ckpts/libero_image_aug", "--center_crop", "0"])
    calls = []

    def stop(**kwargs):
        calls.append(kwargs)
        raise RuntimeError("stop after build_policy_fn")

    for m, pm in ((t_main, t_policy), (j_main, j_policy)):
        monkeypatch.setattr(pm, "build_policy_fn", stop)
        with pytest.raises(RuntimeError, match="stop after build_policy_fn"):
            m.main(["--center_crop", "0", "--num_images_in_input", "3", "--device", "cpu"]
                   if m is t_main else ["--center_crop", "0", "--num_images_in_input", "3"])
    assert calls[0] == {**calls[1], "device": "cpu"}
    assert calls[1]["center_crop"] is False and calls[1]["num_images"] == 3
    with pytest.raises(SystemExit):  # argparse refuses what _strict_bool refuses
        t_main.main(["--center_crop", "maybe"])
    capsys.readouterr()


def test_main_eval_needs_cuda_unless_asked_for_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_main.main(["--preset", "tiny", "--scripted_env"])
    t_main.main(["--preset", "tiny", "--scripted_env", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["success_rate"] == 1.0


# ------------------------------------------------------------------ ALOHA


class _TimeStep:
    def __init__(self, obs):
        self.observation = obs


class FakeAlohaEnv:
    """dm_env-shaped ALOHA rig: cam_high / cam_left_wrist / cam_right_wrist
    frames (480 x 640 unless `size` says otherwise) that change every step,
    and a qpos that tracks the command; done once qpos[0] passes
    `succeed_at_qpos`."""

    def __init__(self, succeed_at_qpos=np.inf, dof=14, size=(480, 640)):
        self.succeed_at_qpos, self.dof, self.size = succeed_at_qpos, dof, size
        self.reset()

    def _obs(self, t):
        rng = np.random.default_rng(1000 + t)
        cams = {c: rng.integers(0, 256, (*self.size, 3), dtype=np.uint8)
                for c in ("cam_high", "cam_left_wrist", "cam_right_wrist")}
        return _TimeStep({"images": cams, "qpos": self.qpos.copy()})

    def reset(self):
        self.qpos, self.commands, self.done = np.zeros(self.dof), [], False
        return self._obs(0)

    def get_qpos(self):
        return self.qpos.copy()

    def get_observation(self, t=0):
        return self._obs(t)

    def step(self, action):
        self.commands.append(np.asarray(action))
        self.qpos = np.asarray(action, np.float64)
        self.done = bool(self.qpos[0] >= self.succeed_at_qpos)
        return self._obs(len(self.commands))

    def is_success(self):
        return self.done


def _aloha_chunk(obs, task):
    """A deterministic (30, 14) chunk read off the observation."""
    views = np.mean([obs[k].astype(np.float64).mean() for k in ALOHA_KEYS])
    state = np.resize(np.asarray(obs["state"], np.float64), 14)
    rows = np.arange(30)[:, None] * 1e-2 + np.arange(14)[None] * 1e-4
    return (1e-4 * views + 1e-3 * len(task) + rows + 0.1 * state[None]).astype(np.float32)


def _recording(fn, calls):
    def policy(obs, task):
        calls.append(({k: np.array(v) for k, v in obs.items()}, task))
        return fn(obs, task)

    return policy


def test_aloha_prepare_observation_matches_reference():
    ts = FakeAlohaEnv()._obs(5)
    np.testing.assert_array_equal(
        t_aloha.resize_image_for_preprocessing(ts.observation["images"]["cam_high"]),
        j_aloha.resize_image_for_preprocessing(ts.observation["images"]["cam_high"]))
    (obs_t, views_t), (obs_j, views_j) = (m.prepare_observation(ts, 224)
                                          for m in (t_aloha, j_aloha))
    assert list(obs_t) == list(obs_j) == [*ALOHA_KEYS, "state"]
    for k in obs_t:
        np.testing.assert_array_equal(obs_t[k], obs_j[k])
        assert obs_t[k].dtype == obs_j[k].dtype
    for a, b in zip(views_t, views_j, strict=True):
        np.testing.assert_array_equal(a, b)
        assert a.shape == (224, 224, 3)


@pytest.mark.parametrize("relative", [False, True], ids=["absolute", "relative"])
def test_aloha_run_episode_matches_reference(relative):
    out = []
    for m in (t_aloha, j_aloha):
        env, calls = FakeAlohaEnv(succeed_at_qpos=0.5 if relative else np.inf), []
        cfg = m.AlohaGenerateConfig(num_open_loop_steps=5, max_steps=12, resize_size=64,
                                    use_relative_actions=relative, pace_control=False)
        stats, frames = m.run_episode(cfg, env, "fold the towel", _recording(_aloha_chunk, calls))
        out.append((stats, frames, env.commands, calls))
    (st_t, fr_t, cmd_t, calls_t), (st_j, fr_j, cmd_j, calls_j) = out
    wall = ("model_query_time", "episode_duration")
    assert {k: v for k, v in st_t.items() if k not in wall} == \
        {k: v for k, v in st_j.items() if k not in wall}
    assert st_t.keys() == st_j.keys()
    if relative:  # targets integrate the commanded targets: done before max_steps
        assert st_t["success"] and st_t["total_steps"] < 12
    else:  # queries at t = 0, 5, 10
        assert st_t["total_steps"] == 12 and len(calls_t) == 3
    assert len(cmd_t) == len(cmd_j) == len(fr_t) == st_t["total_steps"]
    for a, b in zip(cmd_t, cmd_j):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(fr_t, fr_j, strict=True):
        np.testing.assert_array_equal(a, b)
    assert len(calls_t) == len(calls_j)
    for (o_t, task_t), (o_j, task_j) in zip(calls_t, calls_j):
        assert task_t == task_j and list(o_t) == list(o_j)
        for k in o_t:
            np.testing.assert_array_equal(o_t[k], o_j[k])


def test_aloha_run_eval_matches_reference(tmp_path):
    out = []
    for m in (t_aloha, j_aloha):
        cfg = m.AlohaGenerateConfig(num_open_loop_steps=4, max_steps=6, num_rollouts_planned=2,
                                    resize_size=32, use_relative_actions=True,
                                    pace_control=False, save_video_dir=str(tmp_path / m.__name__))
        res = m.run_eval(cfg, _aloha_chunk, FakeAlohaEnv(succeed_at_qpos=0.2, size=(48, 64)),
                         ["win the task", "lose", "never run"])
        gifs = sorted((tmp_path / m.__name__).glob("*.gif"))
        out.append((res, [(g.name, g.read_bytes()) for g in gifs]))
    (res_t, gifs_t), (res_j, gifs_j) = out
    for res in (res_t, res_j):
        for e in res["episodes"]:
            del e["model_query_time"], e["episode_duration"]
    assert res_t == res_j and res_t["num_episodes"] == 2 and res_t["num_successes"] == 1
    assert gifs_t == gifs_j and len(gifs_t) == 2


def test_aloha_and_bridge_envs_need_their_robot_stacks(monkeypatch):
    monkeypatch.setitem(sys.modules, "aloha", None)
    monkeypatch.setitem(sys.modules, "widowx_envs", None)
    for m in (t_aloha, j_aloha):
        with pytest.raises(RuntimeError, match="ROS stack"):
            m.make_aloha_env()
    for m in (t_bridge, j_bridge):
        with pytest.raises(RuntimeError, match="widowx_envs"):
            m.make_widowx_env(m.BridgeGenerateConfig())


def test_aloha_over_http_with_the_tiny_three_view_policy():
    """The reference's server path: the port's ActionServer serves the tiny
    3-view policy on the CPU and the ALOHA harness queries it over HTTP."""
    policy_fn = t_policy.build_policy_fn(preset="tiny", num_images=3, device="cpu", seed=5)
    assert policy_fn.bundle.vla_cfg.num_images == 3
    served = []

    def serve(obs, task):
        served.append(list(obs))
        return policy_fn(obs, task)

    server = ActionServer(serve, host="127.0.0.1", port=0)
    server.start_background()
    chunks = []
    try:
        url = f"http://127.0.0.1:{server.port}/act"

        def query(obs, task):
            chunks.append(get_action_from_server({**obs, "instruction": task}, url, timeout=60))
            return chunks[-1]

        env = FakeAlohaEnv()
        cfg = t_aloha.AlohaGenerateConfig(max_steps=10, num_rollouts_planned=1,
                                          pace_control=False)
        res = t_aloha.run_eval(cfg, query, env, ["fold the towel"])
    finally:
        server.shutdown()
    # chunks of 8 from a 25-step open-loop queue: queries at t = 0 and 8
    assert len(chunks) == 2 and res["episodes"][0]["total_steps"] == len(env.commands) == 10
    assert served == [[*ALOHA_KEYS, "state"]] * 2
    for c in chunks:
        assert c.shape == (8, 7) and np.isfinite(c).all()
    for k, cmd in enumerate(env.commands):
        np.testing.assert_array_equal(cmd, chunks[k // 8][k % 8].astype(np.float32))


# ------------------------------------------------------- WidowX and Bridge


class FakeWidowXClient:
    """bridge_data_robot service protocol: a flat CHW float image in [0, 1],
    a 7-dim state and a 480 x 640 full image that change with every action;
    None after `drop_after` actions (a dropped connection), or for the first
    `none_first` polls."""

    def __init__(self, im_size=32, drop_after=None, none_first=0):
        self.im_size, self.drop_after, self.none_first = im_size, drop_after, none_first
        self.actions, self.moves, self.resets, self.polls = [], [], 0, 0

    def reset(self):
        self.resets += 1

    def move(self, transform, duration=0.8, blocking=True):
        self.moves.append((np.asarray(transform), duration, blocking))

    def step_action(self, action, blocking=False):
        self.actions.append((np.asarray(action), blocking))

    def get_observation(self):
        self.polls += 1
        if self.polls <= self.none_first:
            return None
        n = len(self.actions)
        if self.drop_after is not None and n >= self.drop_after:
            return None
        rng = np.random.default_rng(n)
        return {"image": rng.uniform(size=3 * self.im_size ** 2),
                "state": rng.normal(size=7),
                "full_image": rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)}


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.asarray(b).dtype
    else:
        assert a == b


def test_widowx_functions_match_reference():
    raw = FakeWidowXClient().get_observation()
    _assert_tree_equal(t_widowx.convert_obs(raw, 32), j_widowx.convert_obs(raw, 32))
    _assert_tree_equal(t_widowx.null_obs(32), j_widowx.null_obs(32))
    pos = (0.31, -0.05, 0.22)
    _assert_tree_equal(t_widowx.state_to_start_transform(pos),
                       j_widowx.state_to_start_transform(pos))
    clients = [FakeWidowXClient(none_first=3) for _ in range(2)]
    got = [m.wait_for_obs(c, poll_s=0.0) for m, c in zip((t_widowx, j_widowx), clients)]
    _assert_tree_equal(got[0], got[1])
    assert clients[0].polls == clients[1].polls == 4


def test_widowx_gym_reset_step_and_drop_match_reference():
    out = []
    for m, bm in ((t_widowx, t_bridge), (j_widowx, j_bridge)):
        client = FakeWidowXClient(drop_after=2)
        env = m.WidowXGym(client, bm.BridgeGenerateConfig(), im_size=32, blocking=False)
        trace = [env.reset()]
        for k in range(3):
            trace.append(env.step(np.full(7, 0.1 * k)))
            trace.append(env.done)
        out.append((trace, client.actions, client.moves, client.resets))
    _assert_tree_equal(out[0], out[1])
    trace = out[0][0]
    assert trace[1][3] is False and trace[3][3] is True and trace[4] is True  # dropped
    assert out[0][2][0][2] is True  # the reset move blocks


def test_bridge_run_eval_and_rollout_archives_match_reference(tmp_path):
    out = []
    for m, wm in ((t_bridge, t_widowx), (j_bridge, j_widowx)):
        client, calls = FakeWidowXClient(), []
        save = tmp_path / m.__name__
        cfg = m.BridgeGenerateConfig(max_steps=4, max_episodes=2, pace_control=False,
                                     resize_size=48, save_data=True, save_dir=str(save))
        env = wm.WidowXGym(client, cfg, im_size=32, blocking=False)

        def chunk(obs, task):  # an (8, 7) chunk: the harness executes row 0
            base = obs["full_image"].astype(np.float64).mean() * 1e-3 + 0.01 * len(task)
            return (base + np.arange(56).reshape(8, 7) * 1e-2 + np.resize(obs["proprio"], 7))

        res = m.run_eval(cfg, env, _recording(chunk, calls), ["put the carrot", "b", "c"])
        archives = {}
        for f in sorted(save.glob("*.npz")):
            with np.load(f) as z:
                archives[f.name] = {k: z[k] for k in sorted(z.files)}
        out.append((res, client.actions, calls, archives))
    _assert_tree_equal(out[0], out[1])
    res, actions, calls, archives = out[0]
    assert res["num_episodes"] == 2 and len(calls) == len(actions) == 8  # one query a step
    assert list(archives) == ["rollout-bridge-1.npz", "rollout-bridge-2.npz"]
    a = archives["rollout-bridge-1.npz"]
    assert a["images"].shape == (4, 48, 48, 3) and a["orig_images"].shape == (4, 480, 640, 3)
    assert a["states"].shape == (4, 8)
    for (obs, task), (action, _), row in zip(calls, actions, a["actions"]):
        expect = (obs["full_image"].astype(np.float64).mean() * 1e-3 + 0.01 * len(task)
                  + np.arange(7) * 1e-2 + np.resize(obs["proprio"], 7)).astype(np.float32)
        np.testing.assert_array_equal(action, expect)  # row 0 of the chunk
        assert obs["full_image"].shape == (48, 48, 3)


def test_bridge_refresh_obs_matches_reference():
    objs = []
    for m, wm in ((t_bridge, t_widowx), (j_bridge, j_widowx)):
        env = wm.WidowXGym(FakeWidowXClient(), m.BridgeGenerateConfig(), im_size=32)
        objs.append(m.refresh_obs({"keep": 1}, env))
    _assert_tree_equal(objs[0], objs[1])
    assert list(objs[0]) == ["keep", "full_image", "image_primary", "proprio"]
