"""The text-RL trainer's host-side parts and its critic, held against the
JAX package on the CPU.

Bit for bit, on the same numpy-seeded inputs:
* the reward managers' token-level arrays (naive, with a rule scorer and
  with a closure; DAPO's overlong penalty; a row with an empty response);
* `seqlen_balancing`'s partitions, micro-batches, reverse index and
  `log_seqlen_unbalance`;
* the validation metrics (`bootstrap_metric`, `calc_maj_val`,
  `process_validation_metrics`, `flatten_validation_metrics`);
* `ValidationGenerationsLogger`'s file;
* `TrajectoryTracker`'s files, each package reading the other's.
Within atol 1e-5 / rtol 1e-4 (f32 round-off of the same arithmetic):
`CriticModel` / `compute_values` on a left-padded batch whose pads cover a
whole 64-key tile and more, tied and untied, the weights carried across by
`flax_to_torch(..., "critic")`.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vla_rft_tpu.models import critic as j_critic
from vla_rft_tpu.models import transformer as j_tf
from vla_rft_tpu.trainer import metric_utils as j_metrics
from vla_rft_tpu.utils import generations_logger as j_genlog
from vla_rft_tpu.utils import seqlen_balancing as j_seqlen
from vla_rft_tpu.utils import trajectory_tracker as j_tracker
from vla_rft_tpu.workers import reward_manager as j_rm
from vla_rft_tpu_torch.convert import flax_to_torch
from vla_rft_tpu_torch.models import critic as t_critic
from vla_rft_tpu_torch.models import transformer as t_tf
from vla_rft_tpu_torch.trainer import metric_utils as t_metrics
from vla_rft_tpu_torch.utils import generations_logger as t_genlog
from vla_rft_tpu_torch.utils import seqlen_balancing as t_seqlen
from vla_rft_tpu_torch.utils import trajectory_tracker as t_tracker
from vla_rft_tpu_torch.workers import reward_manager as t_rm

TOL = dict(atol=1e-5, rtol=1e-4)
VOCAB = 64


class DigitTokenizer:
    """Ids as words, id 4 as "####" (the gsm8k answer marker)."""

    def decode(self, ids):
        return " ".join("####" if i == 4 else str(i) for i in ids)


# ------------------------------------------------------------ reward managers
def _responses(seed, B=9, R=12):
    rng = np.random.default_rng(seed)
    resp = rng.integers(5, VOCAB, (B, R)).astype(np.int32)
    resp[::3, 2:4] = [4, 7]  # "#### 7": a gsm8k answer in some rows
    lengths = rng.integers(1, R + 1, B)
    lengths[1] = 0  # an empty response
    lengths[2] = R  # full length: inside DAPO's overlong buffer
    mask = (np.arange(R)[None] < lengths[:, None]).astype(np.int32)
    return resp, mask


MANAGERS = {
    "naive_gsm8k": lambda m: m.NaiveRewardManager(DigitTokenizer()),
    "naive_closure": lambda m: m.NaiveRewardManager(
        DigitTokenizer(), compute_score=lambda src, text, gt, extra=None: len(text) % 5 / 4),
    "dapo": lambda m: m.DAPORewardManager(DigitTokenizer(), max_response_length=12,
                                          overlong_buffer=5, penalty_factor=0.7),
    "batch": lambda m: m.BatchRewardManager(DigitTokenizer()),
}


@pytest.mark.parametrize("name", sorted(MANAGERS))
def test_reward_managers_are_bit_equal(name):
    resp, mask = _responses(0)
    sources = ["openai/gsm8k", "gsm8k"] * 4 + ["openai/gsm8k"]
    gts = ["7", "8", "7"] * 3
    ref = MANAGERS[name](j_rm)(resp, mask, sources, gts)
    got = MANAGERS[name](t_rm)(resp, mask, sources, gts)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert not got[1].any()  # the empty response scores nothing
    if name == "dapo":
        assert got[2, -1] < 1.0 and ref[2, -1] == got[2, -1]  # penalised, scored at its end


# --------------------------------------------------------- seqlen balancing
@pytest.mark.parametrize("k,equal", [(2, True), (4, True), (3, False), (5, False)])
def test_seqlen_balanced_partitions_are_bit_equal(k, equal):
    lens = np.random.default_rng(k).integers(20, 1663, 60).tolist()
    ref = j_seqlen.get_seqlen_balanced_partitions(lens, k, equal_size=equal)
    got = t_seqlen.get_seqlen_balanced_partitions(lens, k, equal_size=equal)
    assert got == ref and sorted(i for p in got for i in p) == list(range(60))
    assert (t_seqlen.log_seqlen_unbalance(lens, got, "global_seqlen")
            == j_seqlen.log_seqlen_unbalance(lens, ref, "global_seqlen"))
    assert (t_seqlen.rearrange_micro_batches(lens, 4000)
            == j_seqlen.rearrange_micro_batches(lens, 4000))
    order = [i for p in got for i in p]
    assert t_seqlen.get_reverse_idx(order) == j_seqlen.get_reverse_idx(order)
    with pytest.raises(ValueError):
        t_seqlen.karmarkar_karp(lens[:7], 2, equal_size=True)


# -------------------------------------------------------- validation metrics
def _val_inputs(seed, n=6, prompts=5):
    rng = np.random.default_rng(seed)
    sources = [("openai/gsm8k", "math")[p % 2] for p in range(prompts) for _ in range(n)]
    inputs = [f"prompt {p}" for p in range(prompts) for _ in range(n)]
    score = rng.integers(0, 2, len(sources)).astype(float).tolist()
    pred = [str(x) for x in rng.integers(0, 3, len(sources))]
    return sources, inputs, {"score": score, "pred": pred,
                             "acc": rng.uniform(size=len(sources)).tolist(),
                             "final_reward": score}


@pytest.mark.parametrize("n", [1, 3, 6])
def test_validation_metrics_are_bit_equal(n):
    sources, inputs, infos = _val_inputs(n, n=n)
    ref = j_metrics.process_validation_metrics(sources, inputs, infos)
    got = t_metrics.process_validation_metrics(sources, inputs, infos)
    assert got == ref
    assert t_metrics.flatten_validation_metrics(got) == j_metrics.flatten_validation_metrics(ref)
    no_pred = {k: v for k, v in infos.items() if k != "pred"}
    assert (t_metrics.process_validation_metrics(sources, inputs, no_pred)
            == j_metrics.process_validation_metrics(sources, inputs, no_pred))
    records = [{"val": v, "pred": p} for v, p in zip(infos["score"], infos["pred"])]
    fns = [lambda a: max(d["val"] for d in a),
           lambda a: t_metrics.calc_maj_val(a, "pred", "val")]
    assert (t_metrics.bootstrap_metric(records, 4, fns, n_bootstrap=50, seed=3)
            == j_metrics.bootstrap_metric(records, 4, fns, n_bootstrap=50, seed=3))
    assert (t_metrics.calc_maj_val(records, "pred", "val")
            == j_metrics.calc_maj_val(records, "pred", "val"))


# ------------------------------------------------------------- files
def test_validation_generations_logger_writes_the_reference_file(tmp_path):
    samples = [("q 1", "a #### 7", 1.0), ("q \"2\"\n", "", 0), ("q3", "ünïcode", 0.25)]
    j_genlog.ValidationGenerationsLogger(str(tmp_path / "ref")).log(samples, 3)
    t_genlog.ValidationGenerationsLogger(str(tmp_path / "port")).log(samples, 3)
    got = (tmp_path / "port" / "step_3.jsonl").read_bytes()
    assert got == (tmp_path / "ref" / "step_3.jsonl").read_bytes()
    assert [json.loads(line)["score"] for line in got.decode().splitlines()] == [1.0, 0.0, 0.25]


def test_trajectory_files_are_read_across_packages(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"logp": rng.normal(size=(4, 8)).astype(np.float32),
            "ids": rng.integers(0, 9, (4, 8)).astype(np.int32)}
    port, ref = (t_tracker.TrajectoryTracker(str(tmp_path / "port")),
                 j_tracker.TrajectoryTracker(str(tmp_path / "ref")))
    port.dump("rollout", 2, {"logp": torch.from_numpy(tree["logp"]), "ids": tree["ids"]})
    ref.dump("rollout", 2, tree)
    for reader, root in ((j_tracker.TrajectoryTracker(str(tmp_path / "port")), "port"),
                         (t_tracker.TrajectoryTracker(str(tmp_path / "ref")), "ref")):
        back = reader.load("rollout", 2)
        assert back.keys() == tree.keys()
        for k in tree:
            np.testing.assert_array_equal(back[k], tree[k], err_msg=f"{root}: {k}")
        shifted = {"logp": tree["logp"] + 0.5}
        assert reader.diff("rollout", 2, shifted) == {"logp": pytest.approx(0.5, abs=1e-6)}
        manifest = [json.loads(x) for x in (tmp_path / root / "manifest.jsonl").read_text()
                    .splitlines()]
        assert [(m["name"], m["step"], m["keys"]) for m in manifest] == [
            ("rollout", 2, ["ids", "logp"])]
    assert t_tracker.TrajectoryTracker(str(tmp_path / "off"), enabled=False).dump(
        "x", 0, tree) is None


# ------------------------------------------------------------------- critic
def _left_padded(seed, B=4, P=100, R=12, pads=(0, 70, 99, 33)):
    """Left-padded prompts (pads of 70 and 99 keys cover a 64-key tile),
    responses ending early in two rows; the rollout's tensor contract."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, VOCAB, (B, P + R)).astype(np.int32)
    pads = np.asarray(pads[:B])
    lens = np.asarray([R, 5, R, 1])[:B]
    pmask = np.arange(P)[None] >= pads[:, None]
    rmask = np.arange(R)[None] < lens[:, None]
    attn = np.concatenate([pmask, rmask], 1).astype(np.int32)
    ids = np.where(attn == 1, ids, 0).astype(np.int32)
    pos = np.concatenate([np.clip(np.arange(P)[None] - pads[:, None], 0, None),
                          (P - pads)[:, None] + np.arange(R)[None]], 1).astype(np.int32)
    return ids, attn, pos, R


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_critic_values_match_jax(tied):
    cfg = dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=128, num_layers=2,
               num_heads=4, num_kv_heads=2, head_dim=16, rope_theta=1e6, qkv_bias=True,
               tie_word_embeddings=tied)
    jcfg = j_tf.TransformerConfig(dtype=jnp.float32, param_dtype=jnp.float32, attn_impl="xla",
                                  **cfg)
    jmodel = j_critic.CriticModel(jcfg)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
    rng = np.random.default_rng(1)  # norms and biases away from their init constants
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(scale=0.05, size=x.shape).astype(np.float32),
        params)
    model = t_critic.CriticModel(t_tf.TransformerConfig(dtype=torch.float32,
                                                        param_dtype=torch.float32, **cfg))
    model.load_state_dict(flax_to_torch(params, "critic"), strict=True)
    assert model.backbone.lm_head is None and model.value_head.weight.dtype == torch.float32
    ids, attn, pos, R = _left_padded(2)
    ref = np.asarray(jax.jit(lambda p, *a: j_critic.compute_values(jmodel, p, *a, R))(
        params, jnp.asarray(ids), jnp.asarray(attn), jnp.asarray(pos)))
    with torch.no_grad():
        got = t_critic.compute_values(model, *map(torch.from_numpy, (ids, attn, pos)), R)
    assert got.dtype == torch.float32 and got.shape == (4, R)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    assert (got.numpy()[attn[:, -R:] == 0] == 0).all() and np.abs(ref).max() > 1e-2
