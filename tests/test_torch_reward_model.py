"""The port's value-head reward model (`models/reward_model.py`) and the PPO
step that scores with it, against the JAX package on the CPU.

The tiny f32 Qwen-shaped decoder, the prompts, the injected rollouts and
the tolerances (atol 1e-5 / rtol 1e-4) are `test_torch_ppo.py`'s.

* `flax_to_torch(tree, "reward_model")` of a reference `SequenceRewardModel`
  loads with strict=True and gives its per-position scores;
* `compute_rm_score` on left-padded rows (pads of 73 or more keys) with
  ragged response ends: the score at the last valid token, zeros elsewhere;
* `PPOTrainer.training_step` with reward_model.enable (grpo), one prompt
  of a data source with a rule scorer and one without: the same metrics,
  the policy's parameters after the step, the RM untouched; the rule rows
  carry the rule scores and the others the RM's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_ppo import (BASE, CFG, PAD, TOL, DigitTokenizer, PromptSet, _assert_close,
                            _port_trainer, _state, fake_rollout, toy_score)
from vla_rft_tpu.config import vla_rft_default_config as j_config
from vla_rft_tpu.models import reward_model as j_rm
from vla_rft_tpu.models import transformer as j_tf
from vla_rft_tpu.parallel.mesh import MeshConfig, make_mesh
from vla_rft_tpu.trainer.ppo_trainer import PPOTrainer as JPPOTrainer
from vla_rft_tpu.workers.reward_manager import NaiveRewardManager as JNaive
from vla_rft_tpu_torch.models import reward_model as t_rm
from vla_rft_tpu_torch.models import transformer as t_tf
from vla_rft_tpu_torch.utils.reward_score import has_scorer

UNSCORED = "custom/no_rule_scorer"
RM_SETTINGS = {"reward_model.enable": True}


def _j_cfg():
    return j_tf.TransformerConfig(dtype=jnp.float32, param_dtype=jnp.float32, attn_impl="xla",
                                  **CFG)


def _t_cfg():
    return t_tf.TransformerConfig(dtype=torch.float32, param_dtype=torch.float32, **CFG)


class MixedPromptSet(PromptSet):
    """PromptSet's rows, the odd ones of a data source with no rule scorer."""

    def sample_batch(self, b):
        out = super().sample_batch(b)
        out["data_sources"] = [("openai/gsm8k", UNSCORED)[i % 2] for i in range(b)]
        return out


@pytest.fixture(scope="module")
def reference_rm():
    """A reference SequenceRewardModel, its parameters and the port's copy."""
    rm = j_rm.SequenceRewardModel(_j_cfg())
    params = rm.init(jax.random.key(4), jnp.zeros((1, 8), jnp.int32))
    port = t_rm.SequenceRewardModel(_t_cfg())
    port.load_state_dict(_state(params, "reward_model"), strict=True)
    return rm, params, port.eval()


def _rollout(rows):
    prompts = np.repeat(PromptSet(seed=5).sample_batch(2)["input_ids"], rows // 2, axis=0)
    return fake_rollout(prompts)


def test_reward_model_tree_loads_strict_and_scores_alike(reference_rm):
    rm, params, port = reference_rm
    ids = np.random.default_rng(0).integers(0, CFG["vocab_size"], (3, 20)).astype(np.int32)
    want = np.asarray(rm.apply(params, jnp.asarray(ids)))
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    assert got.shape == want.shape == (3, 20)
    np.testing.assert_allclose(got, want, **TOL)
    assert set(port.state_dict()) == set(_state(params, "reward_model"))
    assert "score_head.weight" in port.state_dict()


def test_compute_rm_score_matches_jax(reference_rm):
    rm, params, port = reference_rm
    g = _rollout(8)
    assert (g["input_ids"][:, :-g["responses"].shape[1]] == PAD).sum(1).max() >= 64
    R = g["responses"].shape[1]
    want = np.asarray(j_rm.compute_rm_score(rm, params, jnp.asarray(g["input_ids"]),
                                            jnp.asarray(g["attention_mask"]),
                                            jnp.asarray(g["position_ids"]), R))
    t = {k: torch.from_numpy(v) for k, v in g.items()}
    with torch.no_grad():
        got = t_rm.compute_rm_score(port, t["input_ids"], t["attention_mask"],
                                    t["position_ids"], R).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    lengths = g["response_mask"].sum(1)
    assert len(set(lengths.tolist())) > 1  # ragged ends
    for i, n in enumerate(lengths):  # one score, at the last valid token
        assert np.count_nonzero(got[i]) == 1 and got[i, n - 1] != 0


@pytest.fixture(scope="module")
def ref_rm_trainer():
    """The reference's grpo trainer with the value-head RM, its rollouts
    replaced by `fake_rollout`, and its starting policy; one step compiles
    its stages here (the test starts it afresh)."""
    c = j_config().apply_overrides([f"{k}={v}" for k, v in {**BASE, **RM_SETTINGS}.items()]
                                   + ["algorithm.adv_estimator=grpo"])
    c.mesh = {"dp": 1, "fsdp": 1, "tp": 1, "sp": 1}
    tr = JPPOTrainer(c, _j_cfg(), DigitTokenizer(), MixedPromptSet(),
                     mesh=make_mesh(MeshConfig(dp=1), devices=jax.devices()[:1]),
                     reward_manager=JNaive(DigitTokenizer(), compute_score=toy_score))
    tr._gen = tr._gen_greedy = lambda params, rng, prompts: {
        k: jnp.asarray(v) for k, v in fake_rollout(np.asarray(prompts)).items()}
    start = tr.actor_params
    tr.training_step(MixedPromptSet(seed=5).sample_batch(2), jax.random.key(0))
    return tr, start


def test_training_step_with_the_value_head_rm_matches_jax(ref_rm_trainer):
    ref, start = ref_rm_trainer
    ref.actor_params = ref.ref_params = start
    ref.actor_opt_state = ref.actor_tx.init(start)
    ref.global_steps = 0
    port = _port_trainer(ref, RM_SETTINGS, data=MixedPromptSet())
    assert port.rm is not None and port.prime_rm is None
    assert not any(p.requires_grad for p in port.rm.parameters())
    port.rm.load_state_dict(_state(ref.rm_params, "reward_model"), strict=True)
    rm_start = {k: v.clone() for k, v in port.rm.state_dict().items()}
    seen = {}
    scores_fn = port._scores
    port._scores = lambda g, sources, gts, timing: seen.setdefault(
        "scores", (g, sources, gts, scores_fn(g, sources, gts, timing)))[3]
    batch = MixedPromptSet(seed=5).sample_batch(2)
    want = ref.training_step(batch, jax.random.key(0))
    got = port.training_step(batch, torch.Generator().manual_seed(0))
    plain = {k for k in want if not k.startswith("timing_s/")}
    assert {k for k in got if not k.startswith("timing_s/")} == plain
    assert set(want) - plain < set(got) and "timing_s/rm_score" in got
    for k in plain:
        np.testing.assert_allclose(got[k], float(want[k]), err_msg=k, **TOL)
    _assert_close(port.llm, ref.actor_params, "decoder")
    assert all(torch.equal(v, rm_start[k]) for k, v in port.rm.state_dict().items())
    # rule rows: the reward manager's scores; the others: the RM's
    g, sources, gts, scores = seen["scores"]
    rule = np.asarray([has_scorer(s) for s in sources])
    assert rule.any() and (~rule).any()
    with torch.no_grad():
        model = t_rm.compute_rm_score(port.rm, g["input_ids"], g["attention_mask"],
                                      g["position_ids"], g["responses"].shape[1])
    rules = port.reward_manager(g["responses"].numpy(), g["response_mask"].numpy(), sources,
                                gts)
    np.testing.assert_array_equal(scores.numpy()[rule], rules[rule])
    assert torch.equal(scores[torch.from_numpy(~rule)], model[torch.from_numpy(~rule)])
    assert scores[torch.from_numpy(~rule)].abs().sum() > 0
