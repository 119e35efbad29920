"""The port's text-RL PPO trainer (`trainer/ppo_trainer.py`) and its entry
point (`trainer/main_ppo.py`) against the JAX package, on the CPU.

Both trainers hold the same tiny f32 Qwen-shaped policy (2 layers, GQA 4/2
heads of 16, qkv bias, tied embeddings) and critic, initialised by the
reference and carried across by `flax_to_torch`, and see the same
generated sequences: the test replaces each trainer's `_gen` /
`_gen_greedy` on its instance with one numpy-seeded rollout (left-padded
prompts of 8-95 tokens in 96, pads of 73 or more in every other row, so
they cover a whole 64-key tile and more;
responses of 8 ending at an EOS in some rows; "#### 7" answers in others).
Nothing in the JAX package changes.  One JAX trainer per estimator family
(grpo's and gae's) is built per module and reset between cases.

* `training_step` for gae, grpo, rloo, reinforce_plus_plus and remax, grpo
  with the KL penalty in the reward (against a perturbed reference policy)
  and gae with critic_warmup: every metric within atol 1e-5 / rtol 1e-4,
  the same metric keys, and every actor and critic parameter after the
  step within atol 1e-5 / rtol 1e-4 (lr 1e-4; Adam moves an element whose
  gradient is round-off by at most about lr x its relative error);
* `validate()` on the same rollouts: the same metrics, bit for bit;
* the reference policy is its own frozen copy: its log-probs equal the
  policy's at step 1 and differ at step 2, its parameters bit-identical;
* `main_ppo.run` in process with the Qwen config patched tiny: a chat
  tokenizer, a gsm8k-style parquet and a checkpoint written here, 2 steps
  with enable_gradient_checkpointing (the decoder's remat), with grpo and
  with recipe/prime.sh's PRIME settings (whose RM and its reference load
  the checkpoint too); and its refusal without CUDA.

The reward models' steps are `test_torch_reward_model.py`'s and
`test_torch_prime.py`'s, which share this file's helpers.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke as cs
import sft_data
from vla_rft_tpu.config import vla_rft_default_config as j_config
from vla_rft_tpu.models import transformer as j_tf
from vla_rft_tpu.parallel.mesh import MeshConfig, make_mesh
from vla_rft_tpu.trainer.ppo_trainer import PPOTrainer as JPPOTrainer
from vla_rft_tpu.workers.reward_manager import NaiveRewardManager as JNaive
from vla_rft_tpu_torch.config import vla_rft_default_config as t_config
from vla_rft_tpu_torch.convert import flax_to_torch
from vla_rft_tpu_torch.models.factory import build_decoder
from vla_rft_tpu_torch.models import transformer as t_tf
from vla_rft_tpu_torch.trainer import main_ppo
from vla_rft_tpu_torch.trainer.ppo_trainer import PPOTrainer
from vla_rft_tpu_torch.workers.reward_manager import NaiveRewardManager

from text_rl_data import (BASE, CFG, EOS, PAD, P, R, TOL, VOCAB,  # noqa: F401
                          DigitTokenizer, PromptSet, fake_rollout, toy_score)

# case -> (the JAX trainer it runs on, its settings)
CASES = {
    "grpo": ("grpo", {}),
    "rloo": ("grpo", {"algorithm.adv_estimator": "rloo"}),
    "reinforce_plus_plus": ("grpo", {"algorithm.adv_estimator": "reinforce_plus_plus"}),
    "remax": ("grpo", {"algorithm.adv_estimator": "remax"}),
    "grpo_kl_in_reward": ("grpo", {"algorithm.use_kl_in_reward": True,
                                   "algorithm.kl_ctrl.kl_coef": 0.1}),
    "gae": ("gae", {}),
    "gae_critic_warmup": ("gae", {"trainer.critic_warmup": 1}),
}
# the settings a case may change, at their defaults
DEFAULTS = {"algorithm.use_kl_in_reward": False, "algorithm.kl_ctrl.kl_coef": 0.001,
            "trainer.critic_warmup": 0}


def _state(tree, which):
    return flax_to_torch(jax.tree_util.tree_map(np.asarray, tree), which)


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) + rng.normal(scale=0.05, size=x.shape)
                              .astype(np.float32)), tree)


@pytest.fixture(scope="module")
def ref_trainers():
    """The reference's grpo and gae trainers, each with its starting state,
    their rollouts replaced by `fake_rollout`."""
    out = {}
    for est in ("grpo", "gae"):
        c = j_config().apply_overrides([f"{k}={v}" for k, v in BASE.items()]
                                       + [f"algorithm.adv_estimator={est}"])
        c.mesh = {"dp": 1, "fsdp": 1, "tp": 1, "sp": 1}
        jcfg = j_tf.TransformerConfig(dtype=jnp.float32, param_dtype=jnp.float32,
                                      attn_impl="xla", **CFG)
        tr = JPPOTrainer(c, jcfg, DigitTokenizer(), PromptSet(),
                         mesh=make_mesh(MeshConfig(dp=1), devices=jax.devices()[:1]),
                         reward_manager=JNaive(DigitTokenizer(), compute_score=toy_score))
        tr._gen = tr._gen_greedy = lambda params, rng, prompts: {
            k: jnp.asarray(v) for k, v in fake_rollout(np.asarray(prompts)).items()}
        out[est] = (tr, tr.actor_params, getattr(tr, "critic_params", None))
    return out


def _reset(ref_trainers, family, settings):
    """The JAX trainer of `family` at its starting state with `settings`."""
    tr, actor, critic = ref_trainers[family]
    for k, v in {**DEFAULTS, "algorithm.adv_estimator": family, **settings}.items():
        tr.config.set_path(k, v)
    tr.actor_params, tr.ref_params = actor, actor
    tr.actor_opt_state = tr.actor_tx.init(actor)
    if critic is not None:
        tr.critic_params, tr.critic_opt_state = critic, tr.critic_tx.init(critic)
    tr.global_steps = 0
    return tr


def _port_trainer(ref, settings, data=None):
    """The port's trainer with the reference's weights, its rollouts
    replaced by `fake_rollout`."""
    c = t_config().apply_overrides(
        [f"{k}={v}" for k, v in {**BASE, "algorithm.adv_estimator":
                                 ref.config.algorithm.adv_estimator, **settings}.items()])
    tr = PPOTrainer(c, t_tf.TransformerConfig(dtype=torch.float32, param_dtype=torch.float32,
                                              **CFG), DigitTokenizer(), data or PromptSet(),
                    reward_manager=NaiveRewardManager(DigitTokenizer(), compute_score=toy_score),
                    device="cpu")
    tr.load_actor(_state(ref.actor_params, "decoder"))
    if tr.critic is not None:
        tr.critic.load_state_dict(_state(ref.critic_params, "critic"), strict=True)
    tr._gen = tr._gen_greedy = lambda prompts, gen: {
        k: torch.from_numpy(v) for k, v in fake_rollout(prompts.numpy()).items()}
    return tr


def _assert_close(port_module, tree, which):
    ref, got = _state(tree, which), port_module.state_dict()
    assert set(ref) == set(got)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), err_msg=k, **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_training_step_matches_jax(ref_trainers, case):
    family, settings = CASES[case]
    ref = _reset(ref_trainers, family, settings)
    start = ref.actor_params
    port = _port_trainer(ref, settings)
    if case == "grpo_kl_in_reward":  # a reference policy off the policy, on both sides
        ref.ref_params = _perturbed(start, 1)
        port.ref.load_state_dict(_state(ref.ref_params, "decoder"))
    batch = PromptSet(seed=5).sample_batch(2)
    assert (batch["input_ids"] == PAD).sum(1).max() >= 64
    want = ref.training_step(batch, jax.random.key(0))
    got = port.training_step(batch, torch.Generator().manual_seed(0))
    assert got.keys() == want.keys()
    for k in want:
        if not k.startswith("timing_s/"):
            np.testing.assert_allclose(got[k], float(want[k]), err_msg=k, **TOL)
    assert want["critic/score/mean"] > 0 and np.isfinite(list(got.values())).all()
    if case == "grpo_kl_in_reward":
        assert abs(got["critic/rewards/mean"] - got["critic/score/mean"]) > 1e-3
    _assert_close(port.llm, ref.actor_params, "decoder")
    moved = port.llm.state_dict()
    if case == "gae_critic_warmup":  # no actor update before the warmup step
        assert "actor/pg_loss" not in got and all(
            torch.equal(v, _state(start, "decoder")[k]) for k, v in moved.items())
    else:
        assert any(not torch.equal(v, _state(start, "decoder")[k]) for k, v in moved.items())
    if family == "gae":
        _assert_close(port.critic, ref.critic_params, "critic")
        assert "critic/vf_loss" in got


def test_validate_matches_jax(ref_trainers):
    ref = _reset(ref_trainers, "grpo", {})
    port = _port_trainer(ref, {}, data=PromptSet(seed=9))
    ref.dataset = PromptSet(seed=9)
    try:
        want = ref.validate(jax.random.key(3))
    finally:
        ref.dataset = PromptSet()
    got = port.validate()
    assert got == want
    assert got["val/test_score/mean"] > 0
    assert "val-core/openai/gsm8k/score/best@4/mean" in got


def test_reference_policy_is_a_frozen_copy(ref_trainers):
    """Its log-probs equal the policy's at step 1 and differ at step 2;
    its parameters stay bit-identical to the loaded weights."""
    ref = _reset(ref_trainers, "grpo", {})
    port = _port_trainer(ref, {"actor_rollout_ref.ref.log_prob_micro_batch_size_per_gpu": 4,
                               "actor_rollout_ref.actor.optim.lr": 1e-2})
    loaded = {k: v.clone() for k, v in port.ref.state_dict().items()}
    seen, logp = [], port._logp
    port._logp = lambda model, g, chunk: seen.append((model is port.ref, logp(model, g, chunk))) \
        or seen[-1][1]
    data, gen = PromptSet(seed=5), torch.Generator().manual_seed(0)
    for step in (1, 2):
        port.global_steps = step
        port.training_step(data.sample_batch(2), gen)
    (old1, ref1), (old2, ref2) = [[lp for _, lp in seen[i:i + 2]] for i in (0, 2)]
    assert [is_ref for is_ref, _ in seen] == [False, True, False, True]
    assert torch.equal(old1, ref1)
    assert (old2 - ref2).abs().max() > 1e-3
    assert all(torch.equal(v, loaded[k]) for k, v in port.ref.state_dict().items())
    assert not any(p.requires_grad for p in port.ref.parameters())


# ------------------------------------------------------------------ main_ppo
@pytest.fixture
def auto_tokenizer(monkeypatch):
    """transformers.AutoTokenizer as the PreTrainedTokenizerFast it gives for
    a directory written by sft_data (the auto classes take seconds to
    import on the CPU)."""
    import transformers
    from transformers import PreTrainedTokenizerFast

    class AutoTokenizer:
        @staticmethod
        def from_pretrained(path, *args, **kwargs):
            return PreTrainedTokenizerFast.from_pretrained(path, *args, **kwargs)

    monkeypatch.setitem(transformers.__dict__, "AutoTokenizer", AutoTokenizer)


# recipe/prime.sh's overrides (lr raised so that the RM moves in 2 steps)
PRIME_RECIPE = ["algorithm.adv_estimator=prime", "algorithm.reward_gt_coef=5.0",
                "algorithm.reward_dpo_coef=5.0", "reward_model.enable=True",
                "reward_model.rm_type=prime", "reward_model.prime_granularity=token",
                "reward_model.loss_type=ce", "reward_model.beta_train=0.05",
                "reward_model.lr=1e-3", "actor_rollout_ref.actor.use_kl_loss=False"]


@pytest.mark.parametrize("recipe", ["grpo", "prime"])
def test_main_ppo_trains_the_loaded_weights(tmp_path, monkeypatch, auto_tokenizer, recipe):
    cfg = t_tf.TransformerConfig(dtype=torch.float32, param_dtype=torch.float32, **CFG)
    written = build_decoder(cfg, device="cpu", seed=2)
    with torch.no_grad():
        cs.perturb_(written, 3)  # no norm or bias at its init constant
    written = {k: v.detach().clone() for k, v in written.state_dict().items()}
    ckpt = tmp_path / "ckpt"
    sft_data.write_chat_tokenizer(str(ckpt), VOCAB)
    cs.write_safetensors(str(ckpt / "model.safetensors"), cs.hf_decoder_names(written))
    prompts = str(tmp_path / "prompts.parquet")
    sft_data.write_rlhf_parquet(prompts, [5, 11, 2, 30, 7], VOCAB - 8, seed=1)
    monkeypatch.setattr(t_tf.TransformerConfig, "qwen25_0_5b", staticmethod(lambda: cfg))
    runs = []

    class Recording(PPOTrainer):
        def load_actor(self, state_dict):
            super().load_actor(state_dict)
            models = [self.llm, self.ref]
            if self.prime_rm is not None:  # PRIME's RM and its reference
                models += [self.prime_rm.model, self.prime_rm.ref]
            runs.append({"trainer": self, "steps": [], "models": len(models),
                         "loaded": all(torch.equal(v, written[k]) for m in models
                                       for k, v in m.state_dict().items())})

        def training_step(self, batch, gen):
            m = super().training_step(batch, gen)
            runs[-1]["steps"].append(m)
            return m

    monkeypatch.setattr(main_ppo, "PPOTrainer", Recording)
    main_ppo.run(["--device=cpu", f"actor_rollout_ref.model.ckpt_path={ckpt}",
                  f"data.train_files={prompts}", "data.max_prompt_length=24",
                  "data.train_batch_size=2", "actor_rollout_ref.rollout.n=2",
                  "actor_rollout_ref.rollout.response_length=6",
                  "actor_rollout_ref.actor.ppo_mini_batch_size=2",
                  "actor_rollout_ref.actor.optim.lr=1e-3", "trainer.total_training_steps=2",
                  "actor_rollout_ref.model.enable_gradient_checkpointing=true"]
                 + (PRIME_RECIPE if recipe == "prime" else []))
    (run,) = runs
    tr = run["trainer"]
    assert run["loaded"] and len(run["steps"]) == 2 and tr.global_steps == 3
    assert run["models"] == (4 if recipe == "prime" else 2)
    assert tr.llm.cfg.remat and not cfg.remat
    for m in run["steps"]:
        assert np.isfinite(list(m.values())).all() and "actor/pg_loss" in m
        assert ("prime/rm_loss" in m) == (recipe == "prime")
    assert tr.roll_cfg.pad_token_id == 0 and tr.roll_cfg.eos_token_id == 3  # the tokenizer's
    frozen, trained = [tr.ref], [tr.llm]
    if recipe == "prime":
        assert tr.prime_rm.model.cfg.remat
        frozen, trained = frozen + [tr.prime_rm.ref], trained + [tr.prime_rm.model]
    for m in frozen:
        assert all(torch.equal(v, written[k]) for k, v in m.state_dict().items())
    for m in trained:
        assert any(not torch.equal(v, written[k]) for k, v in m.state_dict().items())


def test_main_ppo_refuses_to_run_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main_ppo.run(["actor_rollout_ref.model.ckpt_path=/nonexistent"])
