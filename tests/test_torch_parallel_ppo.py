"""Text RL and text SFT over ranks against the JAX package's trainers on a
2-device mesh.

The tiny f32 Qwen-shaped decoder, the digit tokenizer, the toy scorer and
the injected rollouts are `tests/text_rl_data.py`'s (those of
test_torch_ppo.py), at 4 prompts x n = 4 = 16 rows and ppo_mini_batch_size
8: two global mini-batches, each split 4 / 4 over two data ranks.

* The reference: one `PPOTrainer.training_step` per case on a
  `MeshConfig(dp=2)` mesh (conftest's CPU devices), one trainer holding
  every case's models (each case is handed its family's, so that the
  stages compile once), its `_gen` / `_gen_greedy` replaced by the global
  rollout; the grpo case also on a `MeshConfig(dp=1, fsdp=2)` mesh, where
  its SPMD program gives the same numbers.
* The port: the same step over two gloo ranks (spawned processes, started
  once for the file), at dp = 2 and at fsdp = 2 with the FSDP size floor
  lowered to 1024 so that FSDP2 shards the tiny decoders, each rank's
  rollout its rows of the global one.  Cases: grpo with balance_batch
  (and validate()), gae with the critic, reinforce_plus_plus, rloo, remax,
  KL in the reward with kl_ctrl.type=adaptive (the reference's trainer
  reads kl_ctrl.kl_coef and updates no controller) against a perturbed
  reference policy, the value-head RM (a data source with no rule scorer
  in every other prompt), PRIME, and gae again with the port's decoders
  under remat.  Every metric and the updated actor, critic and PRIME RM
  hold against the reference within atol 1e-5 / rtol 1e-4
  (test_torch_ppo's TOL), the ranks' trees are bit-identical, the
  reference policy does not move, and the step holds against the port's
  1-rank step too (except with balance_batch, whose reorder the 1-rank
  step does not make, as the reference's 1-device program does not).
* `balance_batch` partitions over dp x fsdp: at (dp 1, fsdp 1, sp 2) over
  two ranks it leaves the rows in order (the 1-rank step's numbers).
* `SFTTrainer` over dp 2 and fsdp 2 against the reference's SFTTrainer on
  the dp 2 mesh, 2 steps.
* `main_ppo` and `main_sft` text under two ranks print on rank 0 only;
  `main_sft`'s VLA modes refuse a world above 1; a prompt batch the ranks
  cannot split raises local_batch_slice's error; a mesh the world cannot
  hold raises the reference's message in both trainers and both CLIs.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke as cs
import sft_data
import torch_parallel_ranks
from torch_parallel_suites import FixedBatch
from text_rl_data import (BASE, CFG, TOL, VOCAB, R, DigitTokenizer, PromptSet, fake_rollout,
                          toy_score)
from vla_rft_tpu.config import vla_rft_default_config as j_config
from vla_rft_tpu.models import transformer as j_tf
from vla_rft_tpu.parallel.mesh import MeshConfig, make_mesh
from vla_rft_tpu.trainer import sft_trainer as j_sft
from vla_rft_tpu.trainer.ppo_trainer import PPOTrainer as JPPOTrainer
from vla_rft_tpu.workers import prime_rm as j_prime
from vla_rft_tpu.workers.reward_manager import NaiveRewardManager as JNaive
from vla_rft_tpu_torch.config import vla_rft_default_config as t_config
from vla_rft_tpu_torch.convert import flax_to_torch
from vla_rft_tpu_torch.models import transformer as t_tf
from vla_rft_tpu_torch.models.factory import build_decoder
from vla_rft_tpu_torch.parallel import mesh as pm
from vla_rft_tpu_torch.trainer import main_ppo, main_sft
from vla_rft_tpu_torch.trainer.ppo_trainer import PPOTrainer
from vla_rft_tpu_torch.trainer.sft_trainer import SFTTrainer
from vla_rft_tpu_torch.workers.reward_manager import NaiveRewardManager

# 4 prompts x n 4, two mini-batches of 8 rows
SIZE = {"data.train_batch_size": 4, "data.val_batch_size": 4,
        "actor_rollout_ref.actor.ppo_mini_batch_size": 8}
UNSCORED = "custom/no_rule_scorer"
PRIME = {"algorithm.adv_estimator": "prime", "reward_model.enable": True,
         "reward_model.rm_type": "prime", "reward_model.lr": 1e-4}
# case -> (the reference trainer's family, settings, batch)
CASES = {
    "grpo_balance": ("grpo", {"trainer.balance_batch": True}, "main_validate"),
    "gae": ("gae", {"algorithm.adv_estimator": "gae"}, "main"),
    "reinforce_plus_plus": ("grpo", {"algorithm.adv_estimator": "reinforce_plus_plus"}, "main"),
    "rloo": ("grpo", {"algorithm.adv_estimator": "rloo"}, "main"),
    "remax": ("grpo", {"algorithm.adv_estimator": "remax"}, "main"),
    "kl_in_reward": ("grpo", {"algorithm.use_kl_in_reward": True, "algorithm.kl_ctrl.type":
                              "adaptive", "algorithm.kl_ctrl.kl_coef": 0.1}, "main"),
    "value_head_rm": ("rm", {"reward_model.enable": True}, "mixed"),
    "prime": ("prime", PRIME, "main"),
    # the port's decoders with remat (enable_gradient_checkpointing), the
    # layers recomputed inside FSDP2's unsharded window
    "remat_gae": ("gae", {"algorithm.adv_estimator": "gae"}, "main"),
}
FAMILIES = {"grpo": {}, "gae": {"algorithm.adv_estimator": "gae"},
            "rm": {"reward_model.enable": True}, "prime": PRIME}
# tests/test_sft.py's tiny decoder for SFT: without qkv bias, whose key
# bias gets a gradient of round-off only (the softmax ignores a shift of
# every key), which Adam's first step turns into up to lr
SFT_CFG = dict(vocab_size=50, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
               num_kv_heads=4)
MESHES = {"dp2": ({"dp": 2}, 2 ** 16), "fsdp2": ({"dp": 1, "fsdp": 2}, 1024)}
# the reference settings a case may change, at their defaults
DEFAULTS = {"algorithm.adv_estimator": "grpo", "trainer.balance_batch": False,
            "algorithm.use_kl_in_reward": False, "algorithm.kl_ctrl.type": "fixed",
            "algorithm.kl_ctrl.kl_coef": 0.001}


def _j_cfg():
    return j_tf.TransformerConfig(dtype=jnp.float32, param_dtype=jnp.float32, attn_impl="xla",
                                  **CFG)


def _t_cfg():
    return t_tf.TransformerConfig(dtype=torch.float32, param_dtype=torch.float32, **CFG)


def _state(tree, which):
    return flax_to_torch(jax.tree_util.tree_map(np.asarray, tree), which)


def _batches():
    main = PromptSet(seed=5).sample_batch(4)
    mixed = dict(main, data_sources=[("openai/gsm8k", UNSCORED)[i % 2] for i in range(4)])
    return {"main": main, "main_validate": main, "mixed": mixed,
            "three": PromptSet(seed=5).sample_batch(3)}


def _rollouts(batch, n=4):
    t = lambda g: {k: torch.from_numpy(v) for k, v in g.items()}
    return {"sample": t(fake_rollout(np.repeat(batch["input_ids"], n, axis=0))),
            "greedy": t(fake_rollout(batch["input_ids"]))}


def _reference(mesh_cfg, every_family: bool = True):
    """The reference's trainer on a 2-device mesh with every model a case
    needs (the critic, the value-head RM and, built as the trainer builds
    it, PRIME's worker; or the grpo family's alone), its rollouts replaced
    by the global injected ones; `_ref_step` hands each case the models of
    its family, so that the stages compile once for every case."""
    c = j_config().apply_overrides([f"{k}={v}" for k, v in {
        **BASE, **SIZE, **(dict(FAMILIES["gae"], **FAMILIES["rm"]) if every_family
                           else {})}.items()])
    c.mesh = {"dp": mesh_cfg.dp, "fsdp": mesh_cfg.fsdp, "tp": 1, "sp": 1}
    tr = JPPOTrainer(c, _j_cfg(), DigitTokenizer(), None,
                     mesh=make_mesh(mesh_cfg, devices=jax.devices()[:2]),
                     reward_manager=JNaive(DigitTokenizer(), compute_score=toy_score))
    tr._gen = tr._gen_greedy = lambda params, rng, prompts: {
        k: jnp.asarray(v) for k, v in fake_rollout(np.asarray(prompts)).items()}
    prime = every_family and j_prime.PRIMERewardWorker(_j_cfg(), j_prime.PRIMERMConfig(
        response_length=R, lr=PRIME["reward_model.lr"], n_samples=BASE[
            "actor_rollout_ref.rollout.n"]), tr.actor_params, tr.actor_params)
    tr.family_models = {"critic": tr.critic, "rm": tr.rm, "prime": prime}
    tr.start = {"actor": tr.actor_params, "critic": getattr(tr, "critic_params", None)}
    return tr


def _ref_step(tr, case, batch, ref_params=None):
    """One reference step of `case` from the trainer's starting state, with
    its family's models."""
    family, settings, key = CASES[case]
    start, models = tr.start, tr.family_models
    for k, v in {**DEFAULTS, **settings}.items():
        tr.config.set_path(k, v)
    tr.use_critic = family == "gae"
    tr.rm = models["rm"] if family == "rm" else None
    tr.prime_rm = models["prime"] if family == "prime" else None
    tr.actor_params, tr.ref_params = start["actor"], ref_params or start["actor"]
    tr.actor_opt_state = tr.actor_tx.init(start["actor"])
    if tr.use_critic:
        tr.critic_params, tr.critic_opt_state = start["critic"], tr.critic_tx.init(start["critic"])
    if tr.prime_rm is not None:
        tr.prime_rm.params = start["actor"]
        tr.prime_rm.opt_state = tr.prime_rm.tx.init(start["actor"])
    tr.global_steps = 0
    m = {k: float(v) for k, v in tr.training_step(batch, jax.random.key(0)).items()
         if not k.startswith("timing_s/")}
    out = {"metrics": m, "actor": _state(tr.actor_params, "decoder"),
           "critic": _state(tr.critic_params, "critic") if tr.use_critic else None,
           "prime": None if tr.prime_rm is None else _state(tr.prime_rm.params, "decoder")}
    if "validate" in key:
        tr.dataset = FixedBatch(batch)
        out["validate"] = tr.validate(jax.random.key(3))
    return out


def _port_one_rank(case, inputs, batch, rollouts):
    """The port's 1-rank step of `case` from the same weights and rollouts."""
    _, settings, _ = CASES[case]
    c = t_config().apply_overrides([f"{k}={v}" for k, v in {**BASE, **SIZE,
                                                           **settings}.items()])
    tr = PPOTrainer(c, dataclasses.replace(_t_cfg(), remat=case.startswith("remat")),
                    DigitTokenizer(), FixedBatch(batch),
                    reward_manager=NaiveRewardManager(DigitTokenizer(), compute_score=toy_score),
                    device="cpu")
    tr.load_actor(inputs["actor"])
    if case in inputs["ref"]:
        tr.ref.load_state_dict(inputs["ref"][case])
    for m, k in ((tr.critic, "critic"), (tr.rm, "rm")):
        if m is not None:
            m.load_state_dict(inputs[k])
    tr._gen = lambda prompts, gen: {k: v.clone() for k, v in rollouts["sample"].items()}
    tr._gen_greedy = lambda prompts, gen: {k: v.clone() for k, v in rollouts["greedy"].items()}
    m = tr.training_step(batch, torch.Generator().manual_seed(0))
    return {"metrics": {k: v for k, v in m.items() if not k.startswith("timing_s/")},
            "actor": tr.llm.state_dict(),
            "critic": None if tr.critic is None else tr.critic.state_dict(),
            "prime": None if tr.prime_rm is None else tr.prime_rm.model.state_dict()}


@contextlib.contextmanager
def _torch_threads(n: int):
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _cli_inputs(root):
    """A chat tokenizer, a prompt parquet and a checkpoint for main_ppo; a
    prompt / response parquet and a word tokenizer for main_sft."""
    written = build_decoder(_t_cfg(), device="cpu", seed=2)
    with torch.no_grad():
        cs.perturb_(written, 3)
    ckpt = root / "ckpt"
    sft_data.write_chat_tokenizer(str(ckpt), VOCAB)
    cs.write_safetensors(str(ckpt / "model.safetensors"),
                         cs.hf_decoder_names({k: v.detach() for k, v in
                                              written.state_dict().items()}))
    prompts = str(root / "prompts.parquet")
    sft_data.write_rlhf_parquet(prompts, [5, 11, 2, 30, 7], VOCAB - 8, seed=1)
    words = sft_data.write_sft_parquet(str(root / "sft.parquet"), 8, (4, 40), 30, seed=0)
    sft_data.write_word_tokenizer(str(root / "tok"), [" ".join(words)])
    mesh = ["mesh.dp=1", "mesh.fsdp=2"]
    ppo = ["--device=cpu", "--backend=gloo", f"actor_rollout_ref.model.ckpt_path={ckpt}",
           f"data.train_files={prompts}", "data.max_prompt_length=24",
           "data.train_batch_size=2", "actor_rollout_ref.rollout.n=2",
           "actor_rollout_ref.rollout.response_length=6",
           "actor_rollout_ref.actor.ppo_mini_batch_size=2",
           "actor_rollout_ref.actor.optim.lr=1e-3", "trainer.total_training_steps=2"] + mesh
    sft = ["--device=cpu", "--backend=gloo", "sft.mode=text", "trainer.total_training_steps=2",
           f"data.train_files={root / 'sft.parquet'}",
           f"actor_rollout_ref.model.ckpt_path={root / 'tok'}", "data.train_batch_size=4",
           "data.max_prompt_length=16", "data.max_response_length=8",
           "actor_rollout_ref.actor.optim.lr=1e-3"] + mesh
    vla = ["--device=cpu", "--backend=gloo", "--preset=tiny", "sft.mode=vla_flow",
           "trainer.total_training_steps=1"]
    return {"ppo": ppo, "sft": sft, "vla": vla,
            "ports": [torch_parallel_ranks.free_port() for _ in range(3)]}


def _sft_batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(2):
        ids = rng.integers(3, SFT_CFG["vocab_size"], (4, 12)).astype(np.int32)
        attn = np.ones((4, 12), np.int32)
        attn[1, 9:], attn[2, 5:], attn[3, 3:] = 0, 0, 0  # right padding, ragged
        labels = np.where(attn > 0, ids, -100).astype(np.int32)
        labels[:, :4] = -100  # the prompt
        out.append({"input_ids": ids, "labels": labels, "attention_mask": attn})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    batches = _batches()
    rollouts = {k: _rollouts(b) for k, b in batches.items()}
    ref = _reference(MeshConfig(dp=2))
    ref_fsdp2 = _reference(MeshConfig(dp=1, fsdp=2), every_family=False)
    rng = np.random.default_rng(1)
    # placed as the policy is, so that the reference's stages do not compile again
    perturbed = jax.tree_util.tree_map(lambda x: jax.device_put(
        np.asarray(x) + rng.normal(scale=0.05, size=x.shape).astype(np.float32), x.sharding),
        ref.start["actor"])
    inputs = {"actor": _state(ref.start["actor"], "decoder"),
              "critic": _state(ref.start["critic"], "critic"),
              "rm": _state(ref.rm_params, "reward_model"),
              "ref": {"kl_in_reward": _state(perturbed, "decoder")}}
    cases = [(f"{case}@{mesh}", m, floor, settings, key)
             for mesh, (m, floor) in MESHES.items()
             for case, (_, settings, key) in CASES.items()]
    cases += [("grpo_balance@sp2", {"dp": 1, "fsdp": 1, "sp": 2}, 2 ** 16,
               CASES["grpo_balance"][1], "main"),
              ("uneven@dp2", {"dp": 2}, 2 ** 16, {}, "three")]
    inputs_ppo = dict(inputs, base=SIZE, cases=cases, batches=batches, rollouts=rollouts,
                      ref={f"kl_in_reward@{m}": inputs["ref"]["kl_in_reward"] for m in MESHES})
    # SFT: the reference's decoder, 2 steps of 4 rows on each mesh
    j_cfg = j_tf.TransformerConfig(dtype=jnp.float32, param_dtype=jnp.float32, attn_impl="xla",
                                   **SFT_CFG)
    j_sft_tr = j_sft.SFTTrainer(j_cfg, lr=5e-3, warmup_steps=2,
                                mesh=make_mesh(MeshConfig(dp=2), devices=jax.devices()[:2]))
    sft_sd = _state(j_sft_tr.params, "decoder")
    sft_in = {"cfg": SFT_CFG, "sd": sft_sd, "lr": 5e-3, "warmup": 2, "batches": _sft_batches(),
              "cases": [(m, MESHES[m][0], MESHES[m][1]) for m in MESHES]}
    cli = _cli_inputs(tmp_path_factory.mktemp("cli"))
    # the ranks first and alone, then the references: the XLA compiles and
    # the rank processes do not contend for the cores
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(torch_parallel_ranks.spawn, 2, "text",
                            {"ppo": inputs_ppo, "sft": sft_in}, 600.0)
        cli_ranks = pool.submit(torch_parallel_ranks.spawn, 2, "text_cli", cli, 600.0)
        outs, cli_outs = ranks.result(), cli_ranks.result()
    want = {case: _ref_step(ref, case, batches[key], perturbed if case == "kl_in_reward" else None)
            for case, (_, _, key) in CASES.items()}
    want_fsdp2 = _ref_step(ref_fsdp2, "grpo_balance", batches["main_validate"])
    with _torch_threads(1):  # on these shapes a thread pool only contends
        one = {case: _port_one_rank(case, inputs, batches[key], rollouts[key])
               for case, (_, _, key) in CASES.items()}
    params, opt_state, j_losses = j_sft_tr.params, j_sft_tr.opt_state, []
    for b in sft_in["batches"]:
        params, opt_state, loss = j_sft_tr._step(params, opt_state,
                                                 {k: jnp.asarray(v) for k, v in b.items()})
        j_losses.append(float(loss))
    return dict(want=want, want_fsdp2=want_fsdp2, one=one, ppo=[o["ppo"] for o in outs],
                sft=[o["sft"] for o in outs], j_sft=(j_losses, _state(params, "decoder")),
                cli=cli_outs)


def _close(got: dict, want: dict, what: str):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=f"{what} {k}", **TOL)


def _metrics_close(got: dict, want: dict, what: str):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, err_msg=f"{what} {k}", **TOL)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", list(CASES))
def test_two_rank_ppo_step_matches_the_reference(runs, case, mesh):
    r0, r1 = (o[f"{case}@{mesh}"] for o in runs["ppo"])
    assert [r0["data"], r1["data"]] == [(0, 2), (1, 2)]
    for tree in ("actor", "critic", "prime"):  # the ranks' trees, bit for bit
        if r0[tree] is not None:
            assert all(torch.equal(v, r1[tree][k]) for k, v in r0[tree].items()), tree
    assert r0["metrics"] == r1["metrics"]  # the global batch's, on every rank
    assert r0["ref_unmoved"] and r1["ref_unmoved"]
    assert all(r0["sharded"].values()) == (mesh == "fsdp2")
    want = runs["want"][case]
    _metrics_close(r0["metrics"], want["metrics"], case)
    for tree, which in (("actor", "decoder"), ("critic", "critic"), ("prime", "decoder")):
        assert (r0[tree] is None) == (want[tree] is None), tree
        if want[tree] is not None:
            _close(r0[tree], want[tree], f"{case} {tree}")
    if case == "grpo_balance":
        assert {"global_seqlen/min", "global_seqlen/max"} <= set(r0["metrics"])
        if mesh == "fsdp2":  # the reference's fsdp 2 mesh gives the dp 2 mesh's numbers
            _metrics_close(runs["want_fsdp2"]["metrics"], want["metrics"], "reference fsdp2")
            _close(r0["actor"], runs["want_fsdp2"]["actor"], "fsdp2 vs reference fsdp2")
        return  # the 1-rank step makes no reorder
    one = runs["one"][case]
    _metrics_close(r0["metrics"], one["metrics"], f"{case} vs 1 rank")
    for tree in ("actor", "critic", "prime"):
        if one[tree] is not None:
            _close(r0[tree], one[tree], f"{case} {tree} vs 1 rank")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_validate_over_ranks_matches_the_reference(runs, mesh):
    got = [o[f"grpo_balance@{mesh}"]["validate"] for o in runs["ppo"]]
    want = runs["want"]["grpo_balance"]["validate"]
    assert got[0] == got[1] and set(got[0]) == set(want)
    _metrics_close(got[0], {k: float(v) for k, v in want.items()}, "validate")
    assert got[0]["val/test_score/mean"] > 0


def test_balance_batch_splits_over_dp_fsdp_not_the_world(runs):
    """At (dp 1, fsdp 1, sp 2) both ranks hold the whole batch: no reorder,
    no global_seqlen metrics, the 1-rank step's numbers."""
    r0, r1 = (o["grpo_balance@sp2"] for o in runs["ppo"])
    assert r0["data"] == r1["data"] == (0, 1)
    assert not any(k.startswith("global_seqlen/") for k in r0["metrics"])
    one = runs["one"]["grpo_balance"]
    assert not any(k.startswith("global_seqlen/") for k in one["metrics"])
    _metrics_close(r0["metrics"], one["metrics"], "sp2 vs 1 rank")
    _close(r0["actor"], one["actor"], "sp2 vs 1 rank")


def test_a_prompt_batch_the_ranks_cannot_split_raises(runs):
    for o in runs["ppo"]:
        assert o["uneven@dp2"] == {"error": "global batch 3 does not divide over 2 ranks"}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sft_over_ranks_matches_the_reference(runs, mesh):
    r0, r1 = (o[mesh] for o in runs["sft"])
    want_losses, want_llm = runs["j_sft"]
    assert [r0["data"], r1["data"]] == [(0, 2), (1, 2)]
    assert r0["losses"] == r1["losses"] and r0["sharded"] == (mesh == "fsdp2")
    assert all(torch.equal(v, r1["llm"][k]) for k, v in r0["llm"].items())
    np.testing.assert_allclose(r0["losses"], want_losses, **TOL)
    _close(r0["llm"], want_llm, f"sft {mesh}")


def test_main_ppo_and_main_sft_text_train_over_two_ranks_printing_on_rank0(runs):
    r0, r1 = runs["cli"]
    for name, line in (("ppo", "[step 1] "), ("sft", "[sft step 1] loss ")):
        assert [r0[name]["data"], r1[name]["data"]] == [(0, 2), (1, 2)]
        assert r0[name]["group_destroyed"] and r1[name]["group_destroyed"]
        assert line in r0[name]["printed"] and r1[name]["printed"] == "", name
        for k, v in r0[name]["llm"].items():
            assert torch.equal(v, r1[name]["llm"][k]), (name, k)
    assert len(r0["sft"]["losses"]) == 2 and r0["sft"]["losses"] == r1["sft"]["losses"]
    assert any(not torch.equal(v, r0["ppo"]["ref"][k]) for k, v in r0["ppo"]["llm"].items())


def test_main_sft_vla_modes_refuse_a_world_above_one(runs):
    for r in runs["cli"]:
        assert "only sft.mode=text trains over ranks" in r["vla_error"]
        assert r["vla_group_destroyed"]


MESH_ERRORS = [{"dp": 1, "fsdp": 2}, {"dp": 3, "fsdp": 3}, {"dp": -1, "tp": 2}, {"dp": 2}]


@pytest.mark.parametrize("mesh", MESH_ERRORS)
def test_a_mesh_the_world_cannot_hold_raises_the_reference_message(mesh, tmp_path):
    with pytest.raises(ValueError) as want:
        MeshConfig(**mesh).resolve(1)
    over = [f"mesh.{k}={v}" for k, v in mesh.items()]
    c = t_config().apply_overrides([f"{k}={v}" for k, v in BASE.items()] + over)
    with pytest.raises(ValueError) as got:
        PPOTrainer(c, _t_cfg(), DigitTokenizer(), None, device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        SFTTrainer(_t_cfg(), device="cpu", mesh=pm.MeshConfig(**mesh))
    assert str(got.value) == str(want.value)
    # the entry points, before any model is built
    with pytest.raises(ValueError) as got:
        main_ppo.run(["--device=cpu", "actor_rollout_ref.model.ckpt_path=/nonexistent"] + over)
    assert str(got.value) == str(want.value)
    tok = tmp_path / "tok"
    sft_data.write_word_tokenizer(str(tok), ["w0 w1 w2"])
    from transformers import PreTrainedTokenizerFast

    with pytest.raises(ValueError) as got:
        main_sft.run(["--device=cpu", "sft.mode=text", "data.train_files=/nonexistent"] + over,
                     tokenizer=PreTrainedTokenizerFast.from_pretrained(str(tok)))
    assert str(got.value) == str(want.value)
