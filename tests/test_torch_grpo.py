"""The port's GRPO slice against the JAX package, on the CPU.

Weights are random numpy leaves in the Flax trees' shapes, converted to the
port by `convert.flax_to_torch`; inputs come from numpy with fixed seeds.
All f32 (the tiny preset) unless a test says otherwise.  Tolerances:

* the sigma net and `predict_std` within 1e-5: the same f32 DiT, summed in
  another order;
* the flow rollout, fed the Gaussian draws JAX made (the test repeats
  `rollout_from_hidden`'s key splits): x_chain within one bf16 ulp (2^-7
  relative) per element: the chain is stored in bf16, so an f32 round-off
  on either side can move one rounding;
* the log-prob replay (`_replay_logp`, `logp_from_hidden`) in f32 within
  1e-4 absolute (sums over 10 steps of 56 dims) before the bf16 store;
* `policy_loss_fn`: loss and metrics within 1e-5 (relative, or absolute
  for values near 0), gradients within GRAD_REL of max|g| (see there);
* `core_algos` and the optimizer on fixed tensors within 1e-6 relative
  (the same f32 arithmetic in another order);
* one tiny `training_step` from the same parameters and batch with the
  sampling pinned (greedy WM decode; the sample_noisy_actions dict and the
  flow draws from JAX's keys; one PPO mini-batch), with weights_int8 off
  and on.  Its rollout stage fed those draws lands within one bf16 ulp of
  the reference's chain on >= 85 % of the values (XLA keeps some bf16
  intermediates of the jitted rollout in f32, and moved values move later
  steps), so the step itself runs from the reference's chain (pinned as
  "rollout"): the step's metrics within 1e-3 relative + 1e-5 absolute
  (rewards go through a WM rollout, the tokenizer and LPIPS, each within
  1e-4 (tests/test_torch_reward.py); pg_loss is a near-zero sum), and the
  updated expert parameters' steps within 1e-5 of JAX's on >= 99.5 % of
  the elements (learning rates 1e-4 and 2e-4, no warmup, so a wrong step is
  ~1e-4; Adam's first step is lr * sign(g) for all but the smallest
  gradients, and an element whose gradient is within round-off of zero may
  step the other way: 0.11 % measured, never more than 2 lr).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vla_rft_tpu.config import vla_rft_default_config as j_default_config
from vla_rft_tpu.models.factory import build_models as j_build_models, init_params
from vla_rft_tpu.parallel.mesh import MeshConfig, make_mesh
from vla_rft_tpu.trainer import core_algos as j_ca
from vla_rft_tpu.trainer import optim as j_optim
from vla_rft_tpu.trainer.grpo_trainer import VLARFTGRPOTrainer as JTrainer
from vla_rft_tpu.workers import flow_actor as j_fa
from vla_rft_tpu_torch.config import PolicyConfig, vla_rft_default_config
from vla_rft_tpu_torch.convert import flax_to_torch
from vla_rft_tpu_torch.models.factory import build_policy
from vla_rft_tpu_torch.ops import masked as t_masked
from vla_rft_tpu_torch.trainer import core_algos as t_ca
from vla_rft_tpu_torch.trainer import optim as t_optim
from vla_rft_tpu_torch.trainer.grpo_trainer import VLARFTGRPOTrainer as TTrainer
from vla_rft_tpu_torch.workers import flow_actor as t_fa

BF16_REL = 2.0 ** -7
# policy-loss gradients, max|d| / max|g| over the expert: each term alone
# (PPO, entropy, MSE, KL) is within 2.1e-7 of jax.grad; together the worst
# is 8.3e-4 (measured), from where the bf16 rounding of the log-probs'
# gradient falls when the PPO and KL terms share it
GRAD_REL = 2e-3
MODULES = ("vla", "expert", "wm", "tokenizer", "lpips")


def _random_tree(shapes, seed, scale=0.05):
    """Numpy leaves: N(0, scale), plus one for norm scales and gammas."""
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = str(getattr(path[-1], "key", path[-1])).lower()
        noise = rng.normal(scale=scale, size=sd.shape).astype(np.float32)
        return noise + 1.0 if name in ("scale", "weight") or "gamma" in name else noise

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _tiny_overrides(tmp):
    """The tiny CLI run of the reference (tests/test_trainer_e2e.py) with
    greedy WM decode, no warmup and learning rates that move every leaf."""
    return [
        "data.train_batch_size=2", "data.video.segment_length=3",
        "actor_rollout_ref.rollout.n=2", "actor_rollout_ref.rollout.num_flow_steps=3",
        "actor_rollout_ref.actor.ppo_mini_batch_size=4",
        "actor_rollout_ref.actor.ppo_micro_batch_size_per_gpu=2",
        "actor_rollout_ref.rollout.log_prob_micro_batch_size_per_gpu=4",
        "processor.tokens_per_frame=4", "data.max_prompt_length=75",
        "data.max_response_length=22", "world_model_rollout.rollout.interact_max_tokens=4",
        "world_model_rollout.rollout.do_sample=false",
        "actor_rollout_ref.actor.optim.lr_warmup_steps=0",
        "actor_rollout_ref.actor.optim.lr=1e-4", "actor_rollout_ref.actor.optim.sigma_lr=2e-4",
        "trainer.total_training_steps=2", "trainer.logger=[]",
        f"trainer.default_local_dir={tmp}",
    ]


@pytest.fixture(scope="module")
def tiny_params():
    """The reference's tiny bundle and one set of random weights for every tree."""
    cfg = j_default_config().apply_overrides(_tiny_overrides("/nonexistent"))
    bundle = j_build_models(cfg, preset="tiny")
    shapes = jax.eval_shape(lambda key: init_params(bundle, key), jax.random.key(0))
    params = {m: _random_tree(shapes[m], i, 0.1 if m in ("wm", "tokenizer", "lpips") else 0.05)
              for i, m in enumerate(MODULES)}
    lins = params["lpips"]["params"]
    for name in [k for k in lins if k.startswith("lin")]:
        lins[name]["kernel"] = np.abs(lins[name]["kernel"])  # trained LPIPS heads are >= 0
    return bundle, params


def _port_expert(bundle_params):
    bundle, params = bundle_params
    port = build_policy("tiny", PolicyConfig(segment_length=bundle.num_raw_frames), device="cpu",
                        trainable=True)
    port.expert.load_state_dict(flax_to_torch(params["expert"], "expert"), strict=True)
    return port.expert


def _ctx_inputs(seed, B, C=2, A=7, S=5, D=64, P=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, D)).astype(np.float32),
            rng.normal(size=(B, C, A)).astype(np.float32),
            rng.uniform(size=(B,)).astype(np.float32),
            rng.normal(size=(B, P)).astype(np.float32))


# ------------------------------------------------------------ sigma, rollout
def test_sigma_net_and_predict_std_match_jax(tiny_params):
    bundle, params = tiny_params
    t_exp = _port_expert(tiny_params)
    hid, x, t, prop = _ctx_inputs(0, 3, C=bundle.expert_cfg.num_actions_chunk,
                                  D=bundle.vla_cfg.llm.hidden_size)
    args = tuple(jnp.asarray(a) for a in (hid, x, t, prop))
    j_std, j_log = jax.jit(lambda ep: bundle.expert.apply(ep, *args, method=bundle.expert.predict_std))(
        params["expert"])
    j_flow, j_std2, _ = jax.jit(lambda ep: bundle.expert.apply(ep, *args))(params["expert"])
    with torch.no_grad():
        t_std, t_log = t_exp.predict_std(*(torch.from_numpy(a) for a in (hid, x, t, prop)))
        t_flow, t_std2, _ = t_exp(*(torch.from_numpy(a) for a in (hid, x, t, prop)))
    assert t_std.dtype == torch.float32
    np.testing.assert_allclose(t_std.numpy(), np.asarray(j_std), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(t_log.numpy(), np.asarray(j_log), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(t_std2.numpy(), np.asarray(j_std2), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(t_flow.numpy(), np.asarray(j_flow), atol=1e-5, rtol=1e-5)
    cfg = bundle.expert_cfg
    assert (t_std.numpy() >= cfg.min_std - 1e-6).all() and (t_std.numpy() <= cfg.max_std + 1e-6).all()


def _jax_flow_eps(key, K, shape):
    """The Gaussian draws of rollout_from_hidden: per step key, sub = split(key)."""
    out = []
    for _ in range(K):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return np.stack(out)


@pytest.mark.parametrize("deterministic", [False, True])
def test_flow_rollout_with_jax_draws_matches(tiny_params, deterministic):
    bundle, params = tiny_params
    t_exp = _port_expert(tiny_params)
    K, B = 4, 3
    hid, noise, _, prop = _ctx_inputs(1, B, C=bundle.expert_cfg.num_actions_chunk,
                                      D=bundle.vla_cfg.llm.hidden_size)
    key = jax.random.key(3)
    j_out = j_fa.rollout_from_hidden(bundle.expert, params["expert"], key, jnp.asarray(hid),
                                     jnp.asarray(noise), jnp.asarray(prop), K,
                                     deterministic=deterministic)
    eps = _jax_flow_eps(key, K, noise.shape)
    t_out = t_fa.rollout_from_hidden(t_exp, None, torch.from_numpy(hid), torch.from_numpy(noise),
                                     torch.from_numpy(prop), K, deterministic=deterministic,
                                     eps=torch.from_numpy(eps))
    jx = np.asarray(j_out["x_chain"], np.float32)
    tx = t_out["x_chain"].float().numpy()
    assert t_out["x_chain"].dtype == torch.bfloat16 and tx.shape == (B, K + 1) + noise.shape[1:]
    assert (np.abs(tx - jx) <= BF16_REL * np.abs(jx) + 1e-6).all()
    np.testing.assert_array_equal(t_out["predicted_actions"].float().numpy(), tx[:, -1])


def test_replay_logp_and_entropy_match_jax(tiny_params):
    bundle, params = tiny_params
    t_exp = _port_expert(tiny_params)
    K, B = 4, 3
    hid, noise, _, prop = _ctx_inputs(2, B, C=bundle.expert_cfg.num_actions_chunk,
                                      D=bundle.vla_cfg.llm.hidden_size)
    rng = np.random.default_rng(4)
    chain = np.asarray(jnp.asarray(noise[:, None] + 0.1 * rng.normal(
        size=(B, K + 1) + noise.shape[1:]), jnp.bfloat16), np.float32)
    jc, tc = jnp.asarray(chain, jnp.bfloat16), torch.from_numpy(chain).bfloat16()
    th, tp = torch.from_numpy(hid), torch.from_numpy(prop)
    def close(t, j):  # f32 within 1e-4, then one bf16 rounding each
        j = np.asarray(j, np.float32)
        assert (np.abs(t.float().numpy() - j) <= 1e-4 + BF16_REL * np.abs(j)).all()

    j_replay = jax.jit(lambda ep, chunks: j_fa._replay_logp(
        bundle.expert, ep, jnp.asarray(hid), jc, jnp.asarray(prop), True, step_chunks=chunks),
        static_argnums=1)
    with torch.no_grad():
        for chunks in (1, 2, 3):  # 3 does not divide K: the reference bumps it to 4
            jl, je = j_replay(params["expert"], chunks)
            tl, te = t_fa._replay_logp(t_exp, th, tc, tp, True, step_chunks=chunks)
            close(tl, jl)
            close(te, je)
        jl = jax.jit(lambda ep: j_fa.logp_from_hidden(bundle.expert, ep, jnp.asarray(hid), jc,
                                                      jnp.asarray(prop)))(params["expert"])
        tl = t_fa.logp_from_hidden(t_exp, th, tc, tp)
    assert tl.shape == (B, chain.shape[2] * chain.shape[3]) and tl.dtype == torch.bfloat16
    close(tl, jl)


def _loss_batch(bundle, seed, B, K):
    rng = np.random.default_rng(seed)
    C, A = bundle.expert_cfg.num_actions_chunk, bundle.expert_cfg.action_dim
    hid, noise, _, prop = _ctx_inputs(seed, B, C=C, D=bundle.vla_cfg.llm.hidden_size)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    chain = bf(noise[:, None] + 0.1 * rng.normal(size=(B, K + 1, C, A)))
    batch = {
        "x_chain": chain, "proprio": prop,
        "old_log_probs": bf(rng.normal(size=(B, C * A)) + 1.0),
        "advantages": rng.normal(size=(B, C * A)).astype(np.float32),
        "mb_mask": np.array([1.0] * (B - 1) + [0.0], np.float32),
        "flow": bf(rng.normal(size=(B, C, A))), "gt_noisy_actions": bf(rng.normal(size=(B, C, A))),
        "gt_timesteps": bf(rng.uniform(size=(B,))),
        "ref_log_probs": bf(rng.normal(size=(B, C * A))),
        "gt_actions": rng.uniform(-1, 1, (B, C, A)).astype(np.float32),
        "predicted_actions": bf(rng.uniform(-1, 1, (B, C, A))),
    }
    return hid, batch


def test_policy_loss_and_gradients_match_jax(tiny_params):
    bundle, params = tiny_params
    t_exp = _port_expert(tiny_params)
    cfg = j_default_config().actor_rollout_ref.actor
    cfg.use_kl_loss = True
    cfg.mse_kl_high = 1e6  # a gate strictly inside (0, 1), so the MSE term counts
    cfg.mse_kl_low = -1.0
    tcfg = vla_rft_default_config().actor_rollout_ref.actor
    for k in ("use_kl_loss", "mse_kl_high", "mse_kl_low"):
        tcfg[k] = cfg[k]
    hid, batch = _loss_batch(bundle, 5, 4, 4)
    bf16_keys = ("x_chain", "old_log_probs", "flow", "gt_noisy_actions", "gt_timesteps",
                 "ref_log_probs", "predicted_actions")
    jb = {k: jnp.asarray(v, jnp.bfloat16 if k in bf16_keys else jnp.float32)
          for k, v in batch.items()}
    tb = {k: torch.from_numpy(v).to(torch.bfloat16 if k in bf16_keys else torch.float32)
          for k, v in batch.items()}

    def j_loss(ep):
        return j_fa.policy_loss_fn(bundle.expert, ep, jnp.asarray(hid), jb, cfg)

    (j_val, j_m), j_g = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(params["expert"])
    params_t = dict(t_exp.named_parameters())
    t_val, t_m = t_fa.policy_loss_fn(t_exp, torch.from_numpy(hid), tb, tcfg)
    t_g = torch.autograd.grad(t_val, list(params_t.values()), allow_unused=True)
    assert set(t_m) == set(j_m)
    close = lambda a, b: abs(a - b) <= 1e-5 * max(abs(b), 1.0)
    assert close(float(t_val), float(j_val)), (float(t_val), float(j_val))
    for k in j_m:
        assert close(float(t_m[k]), float(j_m[k])), (k, float(t_m[k]), float(j_m[k]))
    ref = flax_to_torch(jax.tree_util.tree_map(np.asarray, j_g), "expert")
    assert set(ref) == set(params_t)
    gmax = max(np.abs(v.numpy()).max() for v in ref.values())
    for (name, _), g in zip(params_t.items(), t_g):
        r = ref[name].numpy()
        got = np.zeros_like(r) if g is None else g.numpy()
        assert np.abs(got - r).max() <= GRAD_REL * gmax, (name, np.abs(got - r).max(), gmax)


# ------------------------------------------------------------ core algos
def _t(a):
    return torch.from_numpy(np.asarray(a))


def _same(t, j, rtol=1e-6):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=rtol, atol=rtol * max(np.abs(j).max(), 1e-30))


@pytest.mark.parametrize("uniform_std", [False, True])
def test_outcome_advantages_match_jax(uniform_std):
    rng = np.random.default_rng(0)
    B, L, G = 12, 6, 4
    rew = rng.normal(size=(B, L)).astype(np.float32)
    mask = (rng.uniform(size=(B, L)) > 0.2).astype(np.float32)
    gid = np.array([0, 0, 0, 1, 1, 2, 2, 2, 2, 3, 0, 1], np.int32)  # group 3 of one sample
    ja, jr = j_ca.compute_grpo_outcome_advantage(jnp.asarray(rew), jnp.asarray(mask),
                                                 jnp.asarray(gid), G, uniform_std=uniform_std)
    ta, tr = t_ca.compute_grpo_outcome_advantage(_t(rew), _t(mask), _t(gid), G,
                                                 uniform_std=uniform_std)
    _same(ta, ja)
    _same(tr, jr)
    for fn in ("compute_rloo_outcome_advantage",
               "compute_reinforce_plus_plus_baseline_outcome_advantage"):
        ja, jr = getattr(j_ca, fn)(jnp.asarray(rew), jnp.asarray(mask), jnp.asarray(gid), G)
        ta, tr = getattr(t_ca, fn)(_t(rew), _t(mask), _t(gid), G)
        _same(ta, ja)
        _same(tr, jr)
    vals = rng.normal(size=(B, L)).astype(np.float32)
    for got, ref in zip(t_ca.compute_gae_advantage_return(_t(rew), _t(vals), _t(mask), 0.9, 0.8),
                        j_ca.compute_gae_advantage_return(jnp.asarray(rew), jnp.asarray(vals),
                                                          jnp.asarray(mask), 0.9, 0.8)):
        _same(got, ref, 1e-5)
    for got, ref in zip(t_ca.compute_reinforce_plus_plus_outcome_advantage(_t(rew), _t(mask), 0.9),
                        j_ca.compute_reinforce_plus_plus_outcome_advantage(
                            jnp.asarray(rew), jnp.asarray(mask), 0.9)):
        _same(got, ref, 1e-5)
    base = rng.normal(size=(B,)).astype(np.float32)
    for got, ref in zip(t_ca.compute_remax_outcome_advantage(_t(rew), _t(base), _t(mask)),
                        j_ca.compute_remax_outcome_advantage(jnp.asarray(rew), jnp.asarray(base),
                                                             jnp.asarray(mask))):
        _same(got, ref)


@pytest.mark.parametrize("mode", ["token-mean", "seq-mean-token-sum", "seq-mean-token-mean"])
@pytest.mark.parametrize("aggregated", [False, True])
def test_losses_and_penalties_match_jax(mode, aggregated):
    rng = np.random.default_rng(1)
    B, L = 6, 8
    old, new = (rng.normal(size=(B, L)).astype(np.float32) * 0.3 for _ in range(2))
    adv = rng.normal(size=(B, L)).astype(np.float32)
    mask = (rng.uniform(size=(B, L)) > 0.3).astype(np.float32)
    mask[2] = 0.0  # a fully-masked row (trainer padding)
    kw = dict(cliprange=0.2, cliprange_low=0.1, cliprange_high=0.3, clip_ratio_c=3.0,
              loss_agg_mode=mode, log_prob_aggregated=aggregated)
    ref = j_ca.compute_policy_loss(jnp.asarray(old), jnp.asarray(new), jnp.asarray(adv),
                                   jnp.asarray(mask if not aggregated else np.ones_like(mask)), **kw)
    got = t_ca.compute_policy_loss(_t(old), _t(new), _t(adv),
                                   _t(mask if not aggregated else np.ones_like(mask)), **kw)
    for g, r in zip(got, ref):
        _same(g, r)
    _same(t_ca.agg_loss(_t(adv), _t(mask), mode), j_ca.agg_loss(jnp.asarray(adv),
                                                                jnp.asarray(mask), mode))
    for pen in ("kl", "abs", "mse", "low_var_kl"):
        # low_var_kl = exp(kl) - kl - 1 cancels at 1.0: 2 f32 ulps of 1
        np.testing.assert_allclose(t_ca.kl_penalty(_t(new), _t(old), pen).numpy(),
                                   np.asarray(j_ca.kl_penalty(jnp.asarray(new), jnp.asarray(old),
                                                              pen)), rtol=1e-6, atol=2.4e-7)
    vp, ret, val = (rng.normal(size=(B, L)).astype(np.float32) for _ in range(3))
    for g, r in zip(t_ca.compute_value_loss(_t(vp), _t(ret), _t(val), _t(mask), 0.5),
                    j_ca.compute_value_loss(jnp.asarray(vp), jnp.asarray(ret), jnp.asarray(val),
                                            jnp.asarray(mask), 0.5)):
        _same(g, r)
    _same(t_ca.compute_rewards(_t(adv), _t(new), _t(old), 0.1),
          j_ca.compute_rewards(jnp.asarray(adv), jnp.asarray(new), jnp.asarray(old), 0.1))
    for fn in ("masked_mean", "masked_var", "masked_whiten"):
        _same(getattr(t_masked, fn)(_t(adv), _t(mask)),
              getattr(__import__("vla_rft_tpu.ops.masked", fromlist=[fn]), fn)(
                  jnp.asarray(adv), jnp.asarray(mask)), 1e-5)


def test_masked_helpers_and_kl_controllers_match_jax():
    from vla_rft_tpu.ops import masked as j_masked

    rng = np.random.default_rng(2)
    logits = rng.normal(size=(3, 5, 11)).astype(np.float32)
    _same(t_masked.entropy_from_logits(_t(logits)), j_masked.entropy_from_logits(
        jnp.asarray(logits)), 1e-5)
    ids = np.array([[3, 7, 1, 7, 2], [7, 7, 0, 1, 1], [1, 2, 3, 4, 5]], np.int32)
    np.testing.assert_array_equal(t_masked.get_response_mask(_t(ids), 7).numpy(),
                                  np.asarray(j_masked.get_response_mask(jnp.asarray(ids), 7)))
    kl = vla_rft_default_config().algorithm.kl_ctrl
    jkl = j_default_config().algorithm.kl_ctrl
    for typ in ("fixed", "adaptive"):
        kl.type = jkl.type = typ
        t, j = t_ca.get_kl_controller(kl), j_ca.get_kl_controller(jkl)
        for cur in (0.05, 0.5, 0.11):
            t.update(cur, 64)
            j.update(cur, 64)
            assert abs(t.value - j.value) <= 1e-12 * abs(j.value)


# ---------------------------------------------------------------- optimizer
def test_optimizer_groups_clip_and_skip_match_jax(tiny_params):
    bundle, params = tiny_params
    t_exp = _port_expert(tiny_params)
    ocfg = j_default_config().actor_rollout_ref.actor.optim
    ocfg.lr, ocfg.sigma_lr, ocfg.lr_warmup_steps = 1e-3, 3e-3, 2
    tcfg = vla_rft_default_config().actor_rollout_ref.actor.optim
    for k in ("lr", "sigma_lr", "lr_warmup_steps"):
        tcfg[k] = ocfg[k]
    tx = j_optim.make_optimizer(ocfg, 10)
    jp, js = params["expert"], tx.init(params["expert"])
    j_apply = jax.jit(lambda p, s, g: j_optim.apply_updates_with_skip(tx, p, s, g, 1.0))
    named = dict(t_exp.named_parameters())
    opt = t_optim.make_optimizer(named.items(), tcfg, 10)
    labels = t_optim.label_params(named)
    assert {n for n, l in labels.items() if l == "sigma"} == {n for n in named
                                                               if n.startswith("sigma_net.")}
    rng = np.random.default_rng(3)
    for step, scale in enumerate((0.5, 20.0, None, 1.0)):
        # gradients: a small set, a set every module clips, one with a NaN
        # (skipped: nothing moves), then a normal one after the warmup
        g = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32)
                                   * (scale or 1.0) / np.sqrt(a.size), jp)
        if scale is None:
            g["params"]["sigma_net"]["dit"]["final_linear"]["bias"][0] = np.nan
        jp, js, jn = j_apply(jp, js, g)
        tn = t_optim.apply_updates_with_skip(opt, {k: v for k, v in flax_to_torch(
            g, "expert").items()}, 1.0)
        if scale is None:
            assert np.isnan(float(jn)) and torch.isnan(tn)
        else:
            assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
        ref = flax_to_torch(jax.tree_util.tree_map(np.asarray, jp), "expert")
        for name, p in named.items():
            r = ref[name].numpy()
            assert np.abs(p.detach().numpy() - r).max() <= 1e-6 * np.abs(r).max(), (step, name)
    assert opt.groups["base"].count == opt.groups["sigma"].count == 3


def test_checkpoint_save_and_resume_restore_the_step(tmp_path):
    argv = _tiny_overrides(tmp_path / "ckpt") + ["trainer.total_training_steps=1"]
    cfg = vla_rft_default_config().apply_overrides(argv)
    first = TTrainer(cfg, preset="tiny", device="cpu")
    first.fit()
    saved = {k: v.clone() for k, v in first.bundle.expert.state_dict().items()}
    assert first.ckpt.latest_step() == 1 and first.dataset.state_dict() == {"step": 1}

    cfg2 = vla_rft_default_config().apply_overrides(argv[:-1] + ["trainer.total_training_steps=3"])
    second = TTrainer(cfg2, preset="tiny", device="cpu", seed=99)  # other random weights
    second._load_checkpoint()
    assert second.global_steps == 1 and second.dataset.state_dict() == {"step": 1}
    for k, v in second.bundle.expert.state_dict().items():
        assert torch.equal(v, saved[k]), k
    for g in ("base", "sigma"):
        a, b = first.opt.groups[g], second.opt.groups[g]
        assert a.count == b.count == 1
        assert all(torch.equal(x, y) for x, y in zip(a.mu + a.nu, b.mu + b.nu))


# ------------------------------------------------------------ the whole step
STAGE_FNS = ("_encode", "_sample_noisy", "_rollout", "_rollout_det", "_logp", "_process",
             "_reward", "_advantage", "_update", "_ctx_feats", "_reward_feats", "_detok_gtu",
             "_data_stats", "_advantage_remax", "_detokenize", "_wm_lp_reward")


@pytest.fixture(scope="module")
def jax_steps(tiny_params, tmp_path_factory):
    """The reference trainer's training_step at the tiny preset, weights_int8
    off and on, from the same weights and batch, the draws it made and its
    rollout.  The second trainer reuses the first one's compiled stages
    except the WM rollout (the only stage weights_int8 changes)."""
    bundle, params = tiny_params
    mesh = make_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    out, first = {}, None
    for int8 in (False, True):
        argv = _tiny_overrides(tmp_path_factory.mktemp("j")) + [
            f"world_model_rollout.rollout.weights_int8={str(int8).lower()}"]
        cfg = j_default_config().apply_overrides(argv)
        cfg.mesh = {"dp": 1, "fsdp": 1, "tp": 1, "sp": 1}
        tr = JTrainer(cfg, preset="tiny", mesh=mesh, params=params)
        if first is not None:
            for name in STAGE_FNS:
                setattr(tr, name, getattr(first, name))
        first = first or tr
        batch = tr.dataset.next_batch()
        key = jax.random.key(11)
        r_noise, r_roll, _, _, _ = jax.random.split(key, 5)
        n = cfg.actor_rollout_ref.rollout.n
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        hidden = jnp.repeat(tr._encode(tr.params["vla"], {
            "input_ids": jb["input_ids"], "attention_mask": jb["attention_mask"],
            "labels": jb["labels"], "pixels": jb["pixel_values"]}), n, axis=0)
        gt_rep = jnp.repeat(jb["actions"], n, axis=0)
        noise = tr._sample_noisy(r_noise, gt_rep)
        rollout = tr._rollout(tr.params["expert"], r_roll, hidden, noise["noise"],
                              jnp.repeat(jb["proprio"], n, axis=0))
        metrics = tr.training_step(batch, key)
        out[int8] = dict(argv=argv, batch=batch, metrics=metrics, noise=noise,
                         eps=_jax_flow_eps(r_roll, tr.bundle.expert_cfg.num_flow_steps,
                                           gt_rep.shape),
                         rollout={k: np.asarray(v, np.float32) for k, v in rollout.items()},
                         expert=jax.tree_util.tree_map(np.asarray, tr.params["expert"]))
    return out


COMPARED = ("critic/rewards/mean", "critic/rewards/max", "critic/rewards/min",
            "critic/advantages/max", "critic/advantages/min", "critic/recon_loss/mean",
            "critic/perceptual_loss/mean", "actor/pg_loss", "actor/grad_norm", "actor/entropy",
            "actor/ppo_kl", "actor/pg_clipfrac", "actor/mse_loss", "actor/l1_loss",
            "actor/old_log_prob_mean", "actor/predicted_action_abs_mean")


@pytest.mark.parametrize("int8,kv_layout", [
    pytest.param(False, "hd", id="False"), pytest.param(True, "hd", id="True"),
    pytest.param(False, "heads", id="heads-False"), pytest.param(True, "heads", id="heads-True")])
def test_tiny_training_step_matches_jax(tiny_params, jax_steps, int8, kv_layout):
    """The reference's tiny WM (4 heads of 16) always runs the 'heads'
    layout (its 'hd' needs 128 lanes), so one JAX step per int8 setting
    holds both of the port's layouts."""
    _, params = tiny_params
    s = jax_steps[int8]
    cfg = vla_rft_default_config().apply_overrides(
        s["argv"] + [f"world_model_rollout.rollout.kv_layout={kv_layout}"])
    port_params = {m: flax_to_torch(params[m], m) for m in MODULES}
    tr = TTrainer(cfg, preset="tiny", device="cpu", params=port_params)
    before = {k: v.clone() for k, v in tr.bundle.expert.state_dict().items()}
    bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    noise = {k: bf(v) for k, v in s["noise"].items()}
    # the rollout stage from the pinned draws: the chain equal to the
    # reference's on at least 85 % of its values (XLA keeps some bf16
    # intermediates of the jitted rollout in f32, and a moved value moves
    # the next step's input), elsewhere within 2^-6 of max|chain|
    with torch.no_grad():
        hid = tr.encode(tr.put_batch(s["batch"])).repeat_interleave(2, 0)
        own = t_fa.rollout_from_hidden(
            tr.bundle.expert, None, hid, noise["noise"],
            torch.from_numpy(s["batch"]["proprio"]).repeat_interleave(2, 0),
            tr.bundle.expert_cfg.num_flow_steps, eps=torch.from_numpy(s["eps"]))
    jx, tx = s["rollout"]["x_chain"], own["x_chain"].float().numpy()
    assert (tx == jx).mean() >= 0.85, (tx == jx).mean()
    assert np.abs(tx - jx).max() <= 2 ** -6 * np.abs(jx).max(), np.abs(tx - jx).max()
    # the rest of the step from the reference's rollout
    pinned = {"noise": noise, "flow_eps": torch.from_numpy(s["eps"]),
              "rollout": {k: bf(v) for k, v in s["rollout"].items()}}
    metrics = tr.training_step(s["batch"], step=1, pinned=pinned)
    assert tr.bundle.wm.cfg.kv_layout == kv_layout
    if int8:
        assert tr._wm_q is not None and tr._wm_q.cfg.weights_int8
        assert tr._wm_q.cfg.kv_layout == kv_layout
    for k in COMPARED:
        got, ref = metrics[k], float(s["metrics"][k])
        assert abs(got - ref) <= 1e-3 * abs(ref) + 1e-5, (k, got, ref)
    ref = flax_to_torch(s["expert"], "expert")
    far, total = 0, 0
    for k, v in tr.bundle.expert.state_dict().items():
        step_t = (v - before[k]).numpy()
        step_j = ref[k].numpy() - before[k].numpy()
        d = np.abs(step_t - step_j)
        lr = 2e-4 if k.startswith("sigma_net.") else 1e-4
        assert d.max() <= 2 * lr + 1e-5, k  # at worst a gradient sign apart
        far += int((d > 1e-5).sum())
        total += d.size
        assert np.abs(step_t).max() > 0, f"{k} did not move"
    # Adam's first step moves a parameter by lr * g / (|g| + 1e-8): a gradient
    # element within its f32 round-off of zero takes either sign (measured:
    # 0.11 % of the elements)
    assert far / total <= 5e-3, far / total


# ------------------------------------------------------------------ the CLI
@pytest.mark.parametrize("layout", [None, "hd", "heads"])
def test_kv_layout_override_reaches_the_wm(layout):
    """world_model_rollout.rollout.kv_layout reaches the WM's config, "hd"
    by default, as the reference's build_models reads it (factory.py:235-237)."""
    from vla_rft_tpu_torch.models.factory import build_models

    argv = _tiny_overrides("/nonexistent") + (
        [] if layout is None else [f"world_model_rollout.rollout.kv_layout={layout}"])
    bundle = build_models(vla_rft_default_config().apply_overrides(argv), "tiny", device="cpu")
    assert bundle.wm.cfg.kv_layout == bundle.wm_cfg.kv_layout == (layout or "hd")
    kv_shape = bundle.wm.init_cache(2, 8)[0].shape
    assert kv_shape == ((2, 2, 4, 8, 16) if layout == "heads" else (2, 2, 8, 64))


def test_cli_refuses_what_is_not_ported_and_runs_without_a_card_only_on_request(monkeypatch):
    from vla_rft_tpu_torch.trainer import main_vla_rft_grpo

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main_vla_rft_grpo.run(["--preset=tiny", "trainer.total_training_steps=1"])
    for override, what in (("data.video.dataset_path=/data/libero", "RLDS"),
                           ("algorithm.adv_estimator=remax", "remax"),
                           ("trainer.use_ac_reward=true", "use_ac_reward"),
                           ("trainer.reward_fn=wm_logprob", "wm_logprob"),
                           ("trainer.val_before_train=true", "validation"),
                           ("world_model_rollout.model.path=/ckpt/wm", "not ported")):
        with pytest.raises(NotImplementedError, match=what):
            main_vla_rft_grpo.run(["--preset=tiny", "--device=cpu", override])
