"""The port's PRIME (`trainer/prime_core.py`, `workers/prime_rm.py` and the
PPO step with `reward_model.rm_type=prime` / `adv_estimator=prime`) against
the JAX package on the CPU.

The tiny f32 Qwen-shaped decoder, the prompts, the injected rollouts and
the tolerances (atol 1e-5 / rtol 1e-4) are `test_torch_ppo.py`'s.

* every `prime_core` function on numpy-seeded groups of 4 (ragged masks,
  0 / 1 and fractional outcomes, groups of one outcome), `bon_mode` a
  parametrised case of the DPO loss;
* `PRIMERewardWorker.compute_rm_score` and `update_rm` for `ce` and `dpo`
  (each `bon_mode`), `token` and `whole`, an RM off its reference: the
  port scores in chunks and accumulates the update over micro-batches of
  one group, the reference takes the whole batch in one program; scores,
  metrics and every parameter after the step within the tolerance;
* `PPOTrainer.training_step` with PRIME (update `after`, where step 1's
  process scores are exactly 0; `before`, where they are not) and with
  `adv_estimator=prime` alone: the same metrics, the policy's and PRIME
  RM's parameters after the step, PRIME's reference the frozen reference
  policy, untouched; at a rollout temperature other than 1, PRIME's own
  reference log-probs at temperature 1.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_ppo import (BASE, CFG, TOL, DigitTokenizer, PromptSet, _assert_close,
                            _perturbed, _port_trainer, _state, fake_rollout, toy_score)
from vla_rft_tpu.config import vla_rft_default_config as j_config
from vla_rft_tpu.models import transformer as j_tf
from vla_rft_tpu.parallel.mesh import MeshConfig, make_mesh
from vla_rft_tpu.trainer import prime_core as j_core
from vla_rft_tpu.trainer.ppo_trainer import PPOTrainer as JPPOTrainer
from vla_rft_tpu.workers import prime_rm as j_prime
from vla_rft_tpu.workers.reward_manager import NaiveRewardManager as JNaive
from vla_rft_tpu_torch.models import transformer as t_tf
from vla_rft_tpu_torch.models.factory import build_decoder
from vla_rft_tpu_torch.trainer import prime_core as t_core
from vla_rft_tpu_torch.workers import prime_rm as t_prime

N = 4  # samples per group (BASE's rollout.n)
PRIME = {"algorithm.adv_estimator": "prime", "reward_model.enable": True,
         "reward_model.rm_type": "prime", "reward_model.lr": 1e-4}


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **{**TOL, **kw})


def _core_inputs(seed=0, G=3, R=7):
    """Scores, a ragged response mask (one empty row), outcomes (a group of
    one outcome, a fractional one) and the broadcast group values.  The
    scores are multiples of 1/8, so that every row sum is exact in any
    order: `bon_rm` compares each row's Q with its own, a tie."""
    rng = np.random.default_rng(seed)
    B = G * N
    scores = (np.round(rng.normal(size=(B, R)) * 8) / 8).astype(np.float32)
    lengths = rng.integers(1, R + 1, B)
    lengths[5] = 0
    mask = (np.arange(R)[None] < lengths[:, None]).astype(np.float32)
    acc = np.array([1, 0, 0, 1, 0, 0, 0, 0, 0.5, 1, 0, 0.25], np.float32)[:B]
    q = (scores * mask).sum(-1)
    q_bc = np.repeat(q.reshape(G, N), N, axis=0)
    acc_bc = np.repeat(acc.reshape(G, N), N, axis=0)
    return scores, mask, acc, q_bc, acc_bc


def test_masked_rloo_matches_jax():
    scores, mask, *_ = _core_inputs()
    _close(t_core.masked_rloo(_t(scores), _t(mask), N),
           j_core.masked_rloo(_j(scores), _j(mask), N))


@pytest.mark.parametrize("sources", ["both", "process", "outcome", "lengths_given",
                                     "coef_zero"])
def test_compute_prime_advantage_matches_jax(sources):
    scores, mask, acc, *_ = _core_inputs(1)
    kw = {"both": dict(rm_scores=scores, acc=acc, reward_dpo_coef=5.0, reward_gt_coef=5.0),
          "process": dict(rm_scores=scores), "outcome": dict(acc=acc, reward_gt_coef=2.0),
          "lengths_given": dict(acc=acc, valid_response_length=mask.sum(-1).astype(np.int32)),
          "coef_zero": dict(rm_scores=scores, acc=acc, reward_dpo_coef=0.0)}[sources]
    want = j_core.compute_prime_advantage(_j(mask), N, **{
        k: _j(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    got = t_core.compute_prime_advantage(_t(mask), N, **{
        k: _t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    for g, w in zip(got, want):
        _close(g, w)
    assert np.abs(np.asarray(want[1])).max() > 0


def test_compute_ce_dpo_loss_rm_matches_jax():
    scores, mask, acc, *_ = _core_inputs(2)
    for beta in (0.05, 20.0):  # 20: q saturates into the clip
        _close(t_core.compute_ce_dpo_loss_rm(_t(scores), _t(acc), _t(mask), beta),
               j_core.compute_ce_dpo_loss_rm(_j(scores), _j(acc), _j(mask), beta))


@pytest.mark.parametrize("bon_mode", ["none", "bon_rm", "bon_acc"])
def test_compute_detach_dpo_loss_rm_matches_jax(bon_mode):
    scores, mask, acc, q_bc, acc_bc = _core_inputs(3)
    want = j_core.compute_detach_dpo_loss_rm(_j(scores), _j(acc), _j(q_bc), _j(acc_bc),
                                             _j(mask), 0.05, bon_mode)
    got = t_core.compute_detach_dpo_loss_rm(_t(scores), _t(acc), _t(q_bc), _t(acc_bc),
                                            _t(mask), 0.05, bon_mode)
    _close(got, want)
    with pytest.raises(NotImplementedError):
        t_core.compute_detach_dpo_loss_rm(_t(scores), _t(acc), _t(q_bc), _t(acc_bc),
                                          _t(mask), 0.05, "bon_other")


def test_compute_dpo_accuracy_matches_jax():
    scores, mask, acc, *_ = _core_inputs(4)
    want = j_core.compute_dpo_accuracy(_j(scores), _j(acc), _j(mask), N)
    _close(t_core.compute_dpo_accuracy(_t(scores), _t(acc), _t(mask), N), want)
    same = np.zeros_like(acc)  # every group of one outcome: 0.5
    assert float(t_core.compute_dpo_accuracy(_t(scores), _t(same), _t(mask), N)) == 0.5


@pytest.mark.parametrize("mode", ["batch_norm", "none"])
def test_prime_norm_matches_jax(mode):
    scores, mask, *_ = _core_inputs(5)
    _close(t_core.prime_norm(_t(scores * mask), mode), j_core.prime_norm(_j(scores * mask), mode))
    zeros = torch.zeros(4, 6)
    assert torch.equal(t_core.prime_norm(zeros, mode), zeros)


# ------------------------------------------------------------------ the worker
def _j_cfg():
    return j_tf.TransformerConfig(dtype=jnp.float32, param_dtype=jnp.float32, attn_impl="xla",
                                  **CFG)


def _t_cfg():
    return t_tf.TransformerConfig(dtype=torch.float32, param_dtype=torch.float32, **CFG)


@pytest.fixture(scope="module")
def rm_start():
    """A reference Decoder's parameters for the RM and, perturbed, for its
    reference; 8 rows (2 groups of 4) of the injected rollout and outcomes
    of both kinds in the first group."""
    params = j_tf.Decoder(_j_cfg()).init(jax.random.key(3), jnp.zeros((1, 8), jnp.int32))
    prompts = np.repeat(PromptSet(seed=5).sample_batch(2)["input_ids"], N, axis=0)
    g = fake_rollout(prompts)
    acc = np.array([1, 0, 1, 0, 0, 0, 0, 1], np.float32)
    return params, _perturbed(params, 7), g, acc


# case -> (loss_type, granularity, bon_mode)
WORKER_CASES = {"ce_token": ("ce", "token", "none"), "ce_whole": ("ce", "whole", "none"),
                "dpo_token": ("dpo", "token", "none"),
                "dpo_token_bon_rm": ("dpo", "token", "bon_rm"),
                "dpo_whole_bon_acc": ("dpo", "whole", "bon_acc")}


@pytest.mark.parametrize("case", list(WORKER_CASES))
def test_prime_worker_scores_and_update_match_jax(rm_start, case):
    loss_type, granularity, bon_mode = WORKER_CASES[case]
    params, ref_params, g, acc = rm_start
    R = g["responses"].shape[1]
    common = dict(response_length=R, granularity=granularity, loss_type=loss_type,
                  bon_mode=bon_mode, lr=1e-4, n_samples=N)
    jw = j_prime.PRIMERewardWorker(_j_cfg(), j_prime.PRIMERMConfig(**common), params, ref_params)
    model = build_decoder(_t_cfg(), device="cpu")
    model.load_state_dict(_state(params, "decoder"))
    ref = build_decoder(_t_cfg(), device="cpu")
    ref.load_state_dict(_state(ref_params, "decoder"))
    tw = t_prime.PRIMERewardWorker(model, ref, t_prime.PRIMERMConfig(
        **common, score_micro_batch=4, ref_micro_batch=2, update_micro_batch=6))
    assert tw._micro_batch(8) == 4  # whole groups
    seqs = [g[k] for k in ("input_ids", "attention_mask", "position_ids")]
    want = jw.compute_rm_score(*map(_j, seqs))
    got = tw.compute_rm_score(*map(_t, seqs))
    _close(got, want)
    assert np.abs(np.asarray(want)).max() > 0
    if granularity == "whole":  # one score per row, at its last valid token
        assert (np.count_nonzero(np.asarray(got), axis=1) <= 1).all()
    batch = dict(zip(("input_ids", "attention_mask", "position_ids"), seqs), acc=acc)
    want_m = jw.update_rm({k: _j(v) for k, v in batch.items()})
    got_m = tw.update_rm({k: _t(v) for k, v in batch.items()})
    assert got_m.keys() == want_m.keys() == {"prime/rm_loss", "prime/dpo_acc"}
    for k in want_m:
        _close(got_m[k], want_m[k], err_msg=k)
    _assert_close(tw.model, jw.params, "decoder")
    moved = [k for k, v in tw.model.state_dict().items()
             if not torch.equal(v, _state(params, "decoder")[k])]
    assert moved
    assert all(torch.equal(v, _state(ref_params, "decoder")[k])
               for k, v in tw.ref.state_dict().items())


def test_prime_worker_refuses_an_aliased_reference_and_split_groups():
    model = build_decoder(_t_cfg(), device="cpu")
    with pytest.raises(ValueError, match="copy of its own"):
        t_prime.PRIMERewardWorker(model, model, t_prime.PRIMERMConfig(response_length=4))
    tw = t_prime.PRIMERewardWorker(model, copy.deepcopy(model),
                                   t_prime.PRIMERMConfig(response_length=4, n_samples=4))
    assert not any(p.requires_grad for p in tw.ref.parameters())
    with pytest.raises(ValueError, match="whole groups"):
        tw.update_rm({"input_ids": torch.zeros(6, 8, dtype=torch.int32)})


# ----------------------------------------------------------------- the trainer
@pytest.fixture(scope="module")
def ref_prime_trainer():
    """The reference's trainer with PRIME (ce, token) and its starting
    state, its rollouts replaced by `fake_rollout`; one step compiles its
    stages here (each test starts it afresh)."""
    c = j_config().apply_overrides([f"{k}={v}" for k, v in {**BASE, **PRIME}.items()])
    c.mesh = {"dp": 1, "fsdp": 1, "tp": 1, "sp": 1}
    tr = JPPOTrainer(c, _j_cfg(), DigitTokenizer(), PromptSet(),
                     mesh=make_mesh(MeshConfig(dp=1), devices=jax.devices()[:1]),
                     reward_manager=JNaive(DigitTokenizer(), compute_score=toy_score))
    tr._gen = tr._gen_greedy = lambda params, rng, prompts: {
        k: jnp.asarray(v) for k, v in fake_rollout(np.asarray(prompts)).items()}
    start = tr.actor_params
    tr.training_step(PromptSet(seed=5).sample_batch(2), jax.random.key(0))
    return tr, start


# case -> the settings on both sides.  (An RM started off the policy is the
# worker test's: its parameters after a step sit within round-off of the
# reference's, but Adam's first step, g / (|g| + 1e-8), turns the round-off
# of a gradient element near 1e-8 into up to lr, which at the lr that moves
# a parameter past the tolerance exceeds it.)
TRAINER_CASES = {
    "prime_update_after": {"reward_model.update": "after"},
    "prime_update_before": {"reward_model.update": "before"},
    "prime_estimator_alone": {"reward_model.enable": False},
}


@pytest.mark.parametrize("case", list(TRAINER_CASES))
def test_training_step_with_prime_matches_jax(ref_prime_trainer, case):
    settings = TRAINER_CASES[case]
    ref, start = ref_prime_trainer
    ref.actor_params = ref.ref_params = start
    ref.actor_opt_state = ref.actor_tx.init(start)
    ref.global_steps = 0
    ref.config.set_path("reward_model.update", settings.get("reward_model.update", "after"))
    prime_rm, ref.prime_rm.params = ref.prime_rm, start
    ref.prime_rm.opt_state = ref.prime_rm.tx.init(start)
    if not settings.get("reward_model.enable", True):
        ref.prime_rm = None  # adv_estimator=prime alone: the outcome only
    port = _port_trainer(ref, {**PRIME, **settings})
    assert (port.prime_rm is None) == (ref.prime_rm is None)
    seen = []
    if port.prime_rm is not None:
        assert port.prime_rm.ref is port.ref and port.prime_rm.model is not port.llm
        score = port.prime_rm.compute_rm_score
        port.prime_rm.compute_rm_score = lambda *a, **kw: seen.append(score(*a, **kw)) or seen[-1]
    batch = PromptSet(seed=5).sample_batch(2)
    try:
        want = ref.training_step(batch, jax.random.key(0))
    finally:
        ref.prime_rm = prime_rm
    got = port.training_step(batch, torch.Generator().manual_seed(0))
    plain = {k for k in want if not k.startswith("timing_s/")}
    assert {k for k in got if not k.startswith("timing_s/")} == plain
    assert {k for k in want if k.startswith("timing_s/")} < set(got)
    for k in plain:
        np.testing.assert_allclose(got[k], float(want[k]), err_msg=k, **TOL)
    assert want["critic/score/mean"] > 0 and np.isfinite(list(got.values())).all()
    _assert_close(port.llm, ref.actor_params, "decoder")
    if port.prime_rm is None:
        assert "prime/rm_loss" not in got
        return
    # at temperature 1 the reference policy's log-probs are PRIME's
    assert {"timing_s/rm_score", "timing_s/rm_update"} < set(got)
    assert "timing_s/rm_ref_log_prob" not in got
    _assert_close(port.prime_rm.model, ref.prime_rm.params, "decoder")
    assert all(torch.equal(v, _state(start, "decoder")[k])
               for k, v in port.prime_rm.ref.state_dict().items())
    assert not any(p.requires_grad for p in port.prime_rm.ref.parameters())
    (scores,) = seen
    if case == "prime_update_after":  # step 1's RM is its reference: exactly 0
        assert torch.equal(scores, torch.zeros_like(scores))
    else:
        assert scores.abs().max() > 0


def test_prime_takes_its_own_reference_log_probs_off_temperature_1(ref_prime_trainer):
    """At rollout temperature 0.7 the reference policy's log-probs are not
    PRIME's: PRIME's reference forward runs again at temperature 1, so
    step 1's process scores (the RM is its reference) are exactly 0."""
    ref, start = ref_prime_trainer
    ref.actor_params = start
    port = _port_trainer(ref, {**PRIME, "actor_rollout_ref.rollout.temperature": 0.7})
    seen = []
    score = port.prime_rm.compute_rm_score
    port.prime_rm.compute_rm_score = lambda *a, **kw: seen.append(score(*a, **kw)) or seen[-1]
    got = port.training_step(PromptSet(seed=5).sample_batch(2),
                             torch.Generator().manual_seed(0))
    (scores,) = seen
    assert port.roll_cfg.temperature == 0.7 and "timing_s/rm_ref_log_prob" in got
    assert torch.equal(scores, torch.zeros_like(scores))
    assert np.isfinite(list(got.values())).all()
