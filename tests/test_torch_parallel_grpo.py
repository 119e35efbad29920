"""The GRPO step over ranks against the JAX trainer on a 2-device mesh.

One tiny `training_step` of the reference on a dp = 2 mesh (conftest's CPU
devices) and of the port over two gloo ranks (spawned processes, started
once for the file) at dp = 2, at fsdp = 2, and at fsdp = 2 with the FSDP
size floor lowered to 1024 so that FSDP2 shards the tiny expert too, from
the same weights, batch and pinned draws (greedy WM decode; the noise, the
flow draws and the rollout from the reference's keys, as in
tests/test_torch_grpo.py, whose bounds hold here: the step's metrics within
1e-3 relative + 1e-5 absolute, the expert's step within 1e-5 on >= 99.5 %
of the elements and never more than 2 lr off).  The two ranks' experts are
bit-identical, the frozen trees unchanged, and each 2-rank step is held to
the port's 1-rank step by the same bounds.  Then main_vla_rft_grpo under
two ranks: only rank 0 writes the checkpoint, and a second run resumes
from it.  A mesh the world cannot hold raises the reference's message."""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vla_rft_tpu.config import vla_rft_default_config as j_default_config
from vla_rft_tpu.models.factory import build_models as j_build_models, init_params
from vla_rft_tpu.parallel.mesh import MeshConfig, make_mesh
from vla_rft_tpu.trainer.grpo_trainer import VLARFTGRPOTrainer as JTrainer
from vla_rft_tpu_torch.config import vla_rft_default_config
from vla_rft_tpu_torch.convert import flax_to_torch
from vla_rft_tpu_torch.trainer.grpo_trainer import VLARFTGRPOTrainer as TTrainer

import torch_parallel_ranks
from test_torch_grpo import COMPARED, MODULES, _jax_flow_eps, _random_tree, _tiny_overrides

CASES = [("dp2", {"dp": 2, "fsdp": 1}, 2 ** 16), ("fsdp2", {"dp": 1, "fsdp": 2}, 2 ** 16),
         ("fsdp2_expert", {"dp": 1, "fsdp": 2}, 1024)]


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    cfg = j_default_config().apply_overrides(_tiny_overrides("/nonexistent"))
    bundle = j_build_models(cfg, preset="tiny")
    shapes = jax.eval_shape(lambda key: init_params(bundle, key), jax.random.key(0))
    params = {m: _random_tree(shapes[m], i, 0.1 if m in ("wm", "tokenizer", "lpips") else 0.05)
              for i, m in enumerate(MODULES)}
    lins = params["lpips"]["params"]
    for name in [k for k in lins if k.startswith("lin")]:
        lins[name]["kernel"] = np.abs(lins[name]["kernel"])

    argv = _tiny_overrides(tmp_path_factory.mktemp("j"))
    jcfg = j_default_config().apply_overrides(argv)
    jcfg.mesh = {"dp": 2, "fsdp": 1, "tp": 1, "sp": 1}
    tr = JTrainer(jcfg, preset="tiny", mesh=make_mesh(MeshConfig(dp=2), devices=jax.devices()[:2]),
                  params=params)
    batch = tr.dataset.next_batch()
    key = jax.random.key(11)
    r_noise, r_roll, _, _, _ = jax.random.split(key, 5)
    n = jcfg.actor_rollout_ref.rollout.n
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    hidden = jnp.repeat(tr._encode(tr.params["vla"], {
        "input_ids": jb["input_ids"], "attention_mask": jb["attention_mask"],
        "labels": jb["labels"], "pixels": jb["pixel_values"]}), n, axis=0)
    gt_rep = jnp.repeat(jb["actions"], n, axis=0)
    noise = tr._sample_noisy(r_noise, gt_rep)
    rollout = tr._rollout(tr.params["expert"], r_roll, hidden, noise["noise"],
                          jnp.repeat(jb["proprio"], n, axis=0))
    j_metrics = {k: float(v) for k, v in tr.training_step(batch, key).items()}
    j_expert = flax_to_torch(jax.tree_util.tree_map(np.asarray, tr.params["expert"]), "expert")

    bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    pinned = {"noise": {k: bf(v) for k, v in noise.items()},
              "flow_eps": torch.from_numpy(_jax_flow_eps(
                  r_roll, tr.bundle.expert_cfg.num_flow_steps, gt_rep.shape)),
              "rollout": {k: bf(v) for k, v in rollout.items()}}
    port_params = {m: flax_to_torch(params[m], m) for m in MODULES}
    one = TTrainer(vla_rft_default_config().apply_overrides(argv), preset="tiny", device="cpu",
                   params=port_params)
    before = {k: v.clone() for k, v in one.bundle.expert.state_dict().items()}
    one_metrics = one.training_step(batch, step=1, pinned=pinned)
    one_expert = {k: v.clone() for k, v in one.bundle.expert.state_dict().items()}
    outs = torch_parallel_ranks.spawn(2, "grpo", dict(argv=argv, params=port_params, batch=batch,
                                                       pinned=pinned, cases=CASES))
    return dict(j_metrics=j_metrics, j_expert=j_expert, before=before, one_metrics=one_metrics,
                one_expert=one_expert, outs=outs)


def _metrics_close(got, ref, what):
    for k in COMPARED:
        assert abs(got[k] - ref[k]) <= 1e-3 * abs(ref[k]) + 1e-5, (what, k, got[k], ref[k])


def _steps_close(got, ref, before, what):
    """The expert's step against a reference step (test_torch_grpo's bound)."""
    far, total = 0, 0
    for k, v in got.items():
        step_t = (v - before[k]).numpy()
        step_r = ref[k].numpy() - before[k].numpy()
        d = np.abs(step_t - step_r)
        lr = 2e-4 if k.startswith("sigma_net.") else 1e-4
        assert d.max() <= 2 * lr + 1e-5, (what, k)
        far += int((d > 1e-5).sum())
        total += d.size
        assert np.abs(step_t).max() > 0, f"{what}: {k} did not move"
    assert far / total <= 5e-3, (what, far / total)


def test_port_one_rank_step_matches_the_two_device_reference(steps):
    _metrics_close(steps["one_metrics"], steps["j_metrics"], "1 rank")
    _steps_close(steps["one_expert"], steps["j_expert"], steps["before"], "1 rank")


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_two_rank_step_matches_reference_and_one_rank(steps, case):
    r0, r1 = (o[case] for o in steps["outs"])
    for k, v in r0["expert"].items():  # the ranks' experts, bit for bit
        assert torch.equal(v, r1["expert"][k]), k
    for r in (r0, r1):
        assert all(r["frozen_same"].values()), r["frozen_same"]
        assert all(r["metrics"][k] == r0["metrics"][k] for k in COMPARED)  # global numbers
    _metrics_close(r0["metrics"], steps["j_metrics"], case)
    _steps_close(r0["expert"], steps["j_expert"], steps["before"], case)
    _metrics_close(r0["metrics"], steps["one_metrics"], f"{case} vs 1 rank")
    _steps_close(r0["expert"], steps["one_expert"], steps["before"], f"{case} vs 1 rank")
    placed = r0["placed"]
    if case == "dp2":
        assert not any(placed.values()) and not r0["sharded"]
    else:  # fsdp: the tiny towers' big leaves are sharded; the expert's only
        # below the reference's 2^16 floor
        assert placed["vla"] and placed["wm"] and placed["lpips"]
        assert bool(r0["sharded"]) == placed["expert"] == (case == "fsdp2_expert")


def test_cli_over_two_ranks_saves_on_rank0_and_resumes(tmp_path):
    ckpt = tmp_path / "ckpt"
    base = ["--preset=tiny", "--device=cpu"] + _tiny_overrides(ckpt) + [
        "trainer.save_freq=1", "mesh.dp=2"]
    first = torch_parallel_ranks.spawn(2, "cli",
                                       dict(argv=base + ["trainer.total_training_steps=1"]))
    assert [o["saved"] for o in first] == [[1], []]
    assert all(o["world"] == 2 and o["group_destroyed"] and o["global_steps"] == 2 for o in first)
    assert [o["data"] for o in first] == [(0, 2), (1, 2)]
    assert sorted(d for d in os.listdir(ckpt) if d.startswith("global_step_")) == [
        "global_step_1"]
    second = torch_parallel_ranks.spawn(2, "cli",
                                        dict(argv=base + ["trainer.total_training_steps=2"]))
    # resumed at step 1: only step 2 runs, and rank 0 saves it
    assert [o["saved"] for o in second] == [[2], []]
    assert all(o["global_steps"] == 3 for o in second)
    for o in (first, second):
        for k, v in o[0]["expert"].items():
            assert torch.equal(v, o[1]["expert"][k]), k
    assert any(not torch.equal(v, second[0]["expert"][k])
               for k, v in first[0]["expert"].items())


@pytest.mark.parametrize("mesh", [{"dp": 1, "fsdp": 2}, {"dp": 3, "fsdp": 3}, {"dp": -1, "tp": 2},
                                  {"dp": 2}])
def test_a_mesh_the_world_cannot_hold_raises_the_reference_message(mesh):
    with pytest.raises(ValueError) as want:
        MeshConfig(**mesh).resolve(1)
    cfg = vla_rft_default_config().apply_overrides(
        _tiny_overrides("/nonexistent") + [f"mesh.{k}={v}" for k, v in mesh.items()])
    with pytest.raises(ValueError) as got:
        TTrainer(cfg, preset="tiny", device="cpu")
    assert str(got.value) == str(want.value)
