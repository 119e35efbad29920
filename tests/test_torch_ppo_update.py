"""One actor update and one critic update of the port's `PPOTrainer` against
the reference trainer's jitted `_actor_update` / `_critic_update`, on the
CPU.

A tiny f32 Qwen-shaped decoder (2 layers, GQA 4/2 heads of 16, qkv bias,
tied embeddings) and critic are initialised by the reference and carried
across by `flax_to_torch`.  The mini-batch is fixed and numpy-seeded: 4
left-padded rows of 100 prompt + 12 response tokens whose pads (0, 70, 99
and 33 keys) cover a whole 64-key tile and more, responses ending early,
old and reference log-probs perturbed off the policy's own so that the
ratio clips, seeded advantages, returns and values.  Parametrised over
`loss_agg_mode` and `use_kl_loss`.  Tolerances (f32 round-off of the same
arithmetic summed in another order):
* losses, entropy, KL and clip fractions within atol 1e-5 / rtol 1e-4;
  the gradient norm (before clipping) within rtol 1e-5;
* every parameter after the update within atol 1e-5 / rtol 1e-4 at lr
  1e-4: Adam moves each element by about lr whatever its gradient's size,
  so the tolerance bounds the update of an element whose gradient is
  round-off, and the updates themselves (about 1e-4) are 10x the bound.
The decoder's `remat` (each layer recomputed in the backward) gives the
actor and critic updates of the same mini-batch bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vla_rft_tpu.config import vla_rft_default_config as j_config
from vla_rft_tpu.models import transformer as j_tf
from vla_rft_tpu.parallel.mesh import MeshConfig, make_mesh
from vla_rft_tpu.trainer.ppo_trainer import PPOTrainer as JPPOTrainer
from vla_rft_tpu_torch.config import vla_rft_default_config as t_config
from vla_rft_tpu_torch.convert import flax_to_torch
from vla_rft_tpu_torch.models import transformer as t_tf
from vla_rft_tpu_torch.trainer.ppo_trainer import PPOTrainer

TOL = dict(atol=1e-5, rtol=1e-4)
NORM_RTOL = 1e-5
VOCAB, P, R = 64, 100, 12
CFG = dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
           num_kv_heads=2, head_dim=16, rope_theta=1e6, qkv_bias=True, tie_word_embeddings=True)
OVERRIDES = ["algorithm.adv_estimator=gae", f"actor_rollout_ref.rollout.response_length={R}",
             "actor_rollout_ref.actor.optim.lr=1e-4", "critic.optim.lr=1e-4",
             "actor_rollout_ref.actor.kl_loss_coef=0.5", "actor_rollout_ref.actor.entropy_coeff=0.01"]


class _NoData:
    def sample_batch(self, n):
        raise AssertionError("the update tests draw no batch")


def _state(tree, which):
    return flax_to_torch(jax.tree_util.tree_map(np.asarray, tree), which)


@pytest.fixture(scope="module")
def ref_trainer():
    c = j_config().apply_overrides(OVERRIDES)
    c.mesh = {"dp": 1, "fsdp": 1, "tp": 1, "sp": 1}
    jcfg = j_tf.TransformerConfig(dtype=jnp.float32, param_dtype=jnp.float32, attn_impl="xla",
                                  **CFG)
    mesh = make_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    return JPPOTrainer(c, jcfg, tokenizer=None, dataset=_NoData(), mesh=mesh)


@pytest.fixture(scope="module")
def mini_batch(ref_trainer):
    """The fixed mini-batch (numpy), its old log-probs the policy's own
    (from the reference's `_logp`) plus N(0, 0.3)."""
    rng = np.random.default_rng(0)
    B, pads, lens = 4, np.asarray([0, 70, 99, 33]), np.asarray([R, 5, R, 1])
    ids = rng.integers(3, VOCAB, (B, P + R)).astype(np.int32)
    attn = np.concatenate([np.arange(P)[None] >= pads[:, None],
                           np.arange(R)[None] < lens[:, None]], 1).astype(np.int32)
    ids = np.where(attn == 1, ids, 0).astype(np.int32)
    pos = np.concatenate([np.clip(np.arange(P)[None] - pads[:, None], 0, None),
                          (P - pads)[:, None] + np.arange(R)[None]], 1).astype(np.int32)
    mask = attn[:, -R:]
    own = np.asarray(ref_trainer._logp(ref_trainer.actor_params, jnp.asarray(ids),
                                       jnp.asarray(attn), jnp.asarray(pos)))
    noise = lambda scale: rng.normal(scale=scale, size=(B, R)).astype(np.float32)
    old = own + noise(0.3)
    return {"input_ids": ids, "attention_mask": attn, "position_ids": pos,
            "response_mask": mask, "old_log_probs": old, "ref_log_probs": old + noise(0.5),
            "advantages": noise(1.0) * mask, "returns": noise(1.0) * mask,
            "values": noise(1.0) * mask}


def _port_trainer(ref_trainer, remat=False, **actor):
    c = t_config().apply_overrides(OVERRIDES + [f"actor_rollout_ref.actor.{k}={v}"
                                                for k, v in actor.items()])
    cfg = t_tf.TransformerConfig(dtype=torch.float32, param_dtype=torch.float32, remat=remat,
                                 **CFG)
    tr = PPOTrainer(c, cfg, tokenizer=None, dataset=_NoData(), device="cpu")
    tr.load_actor(_state(ref_trainer.actor_params, "decoder"))
    tr.critic.load_state_dict(_state(ref_trainer.critic_params, "critic"), strict=True)
    return tr


def _assert_params_close(port_module, tree, which):
    ref, got = _state(tree, which), port_module.state_dict()
    assert set(ref) == set(got)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), err_msg=k, **TOL)


@pytest.mark.parametrize("use_kl_loss", [False, True], ids=["no_kl", "kl_loss"])
@pytest.mark.parametrize("mode", ["token-mean", "seq-mean-token-sum", "seq-mean-token-mean"])
def test_actor_update_matches_jax(ref_trainer, mini_batch, mode, use_kl_loss):
    actor = ref_trainer.config.actor_rollout_ref.actor
    actor.loss_agg_mode, actor.use_kl_loss = mode, use_kl_loss
    ref_trainer._build_stage_fns()  # the reference reads them when it traces
    start = ref_trainer.actor_params
    new, _, ref_m = ref_trainer._actor_update(
        start, ref_trainer.actor_tx.init(start),
        {k: jnp.asarray(v) for k, v in mini_batch.items()})
    tr = _port_trainer(ref_trainer, loss_agg_mode=mode, use_kl_loss=use_kl_loss)
    got = tr._actor_update({k: torch.from_numpy(v) for k, v in mini_batch.items()})
    ref_m = {k: float(v) for k, v in ref_m.items()}
    assert got.keys() == ref_m.keys()
    assert 0 < got["actor/pg_clipfrac"] < 1  # the ratio clips in some tokens
    np.testing.assert_allclose(got["actor/grad_norm"], ref_m["actor/grad_norm"], rtol=NORM_RTOL)
    for k in ref_m:
        np.testing.assert_allclose(got[k], ref_m[k], err_msg=k, **TOL)
    _assert_params_close(tr.llm, new, "decoder")
    before, after = _state(start, "decoder"), tr.llm.state_dict()
    assert max((after[k] - v).abs().max().item() for k, v in before.items()) > 10 * TOL["atol"]
    for k, v in tr.ref.state_dict().items():  # the reference policy did not move
        assert torch.equal(v, before[k]), k


def test_critic_update_matches_jax(ref_trainer, mini_batch):
    start = ref_trainer.critic_params
    new, _, ref_m = ref_trainer._critic_update(
        start, ref_trainer.critic_tx.init(start),
        {k: jnp.asarray(v) for k, v in mini_batch.items()})
    tr = _port_trainer(ref_trainer)
    got = tr._critic_update({k: torch.from_numpy(v) for k, v in mini_batch.items()})
    ref_m = {k: float(v) for k, v in ref_m.items()}
    assert got.keys() == ref_m.keys() == {"critic/vf_loss", "critic/vf_clipfrac"}
    assert 0 < got["critic/vf_clipfrac"] < 1
    for k in ref_m:
        np.testing.assert_allclose(got[k], ref_m[k], err_msg=k, **TOL)
    _assert_params_close(tr.critic, new, "critic")


def test_remat_updates_are_bit_equal(ref_trainer, mini_batch):
    mb = {k: torch.from_numpy(v) for k, v in mini_batch.items()}
    runs = []
    for remat in (False, True):
        tr = _port_trainer(ref_trainer, remat=remat, use_kl_loss=True)
        assert tr.llm.cfg.remat is remat and tr.critic.cfg.remat is remat
        runs.append((tr._critic_update(mb), tr._actor_update(mb), tr.llm.state_dict(),
                     tr.critic.state_dict()))
    (c0, a0, p0, q0), (c1, a1, p1, q1) = runs
    assert c0 == c1 and a0 == a1
    assert all(torch.equal(p0[k], p1[k]) for k in p0) and all(torch.equal(q0[k], q1[k]) for k in q0)
