"""The port's world-model rollout against the JAX package, on the CPU.

* The cached decoder (prefill, tail prefill over a shared prefix, decode
  steps, 7-token chunks, and 12- and 33-token chunks, which go through
  attention() over the cache) against `Decoder.apply`, f32 weights: logits
  within atol/rtol 1e-4 with an f32 cache, 2e-3 with an int8 cache (one
  f32 ulp of difference in k or v can move a value across an int8 rounding
  boundary, a change of one quantisation step).
* Greedy `generate_sequences` tokens equal to JAX's, for the plain and the
  shared-prefix route, one and four cache segments, the interleaved n + 1
  groups and a per-row prefix_map; and for one frame on the trained push
  world model (artifacts/rft_evidence32/wm.npz, loaded in the layout of
  tools/rft_evidence.py's `save_tree`).
* `filtered_logits` equal to JAX's exactly, ties included; `sample_token`
  frequencies within 5 standard errors of the filtered softmax.
* Token ids come back as int32, the reference's dtype, from `sample_token`
  (greedy and sampled) and `generate_sequences`.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vla_rft_tpu.models import transformer as j_tf
from vla_rft_tpu.ops import sampling as j_sampling
from vla_rft_tpu.workers import wm_rollout as j_roll
from vla_rft_tpu_torch.convert import flax_to_torch
from vla_rft_tpu_torch.models import transformer as t_tf
from vla_rft_tpu_torch.ops import sampling as t_sampling
from vla_rft_tpu_torch.workers import wm_rollout as t_roll

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVIDENCE = os.path.join(ROOT, "artifacts", "rft_evidence32")
TOL = {"bf16": dict(atol=1e-4, rtol=1e-4), "int8": dict(atol=2e-3, rtol=2e-3)}


def _random_params(module, seed, shape_ids=(1, 4)):
    shapes = jax.eval_shape(lambda r: module.init(r, jnp.zeros(shape_ids, jnp.int32)),
                            jax.random.key(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (rng.normal(scale=0.05, size=s.shape) + (1.0 if len(s.shape) == 1 else 0.0))
        .astype(np.float32), shapes)


def _pair(kv, vocab=256, layers=2, seed=0):
    kw = dict(vocab_size=vocab, hidden_size=128, intermediate_size=256, num_layers=layers,
              num_heads=2, num_kv_heads=2, kv_cache_dtype=kv)
    jm = j_tf.Decoder(j_tf.TransformerConfig(dtype=jnp.float32, param_dtype=jnp.float32,
                                             attn_impl="xla", **kw))
    params = _random_params(jm, seed)
    tm = t_tf.Decoder(t_tf.TransformerConfig(dtype=torch.float32, param_dtype=torch.float32, **kw))
    tm.load_state_dict(flax_to_torch(params, "wm"), strict=True)
    return jm, params, tm.eval()


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("shared", [False, True])
def test_cached_decoder_matches_jax(shared, kv):
    jm, params, tm = _pair(kv)
    rng = np.random.default_rng(1)
    B, P0, T, A = 4, 40, 7, 7
    prompt = rng.integers(0, 256, (B, P0 + T))
    steps = [rng.integers(0, 256, (B, 1)) for _ in range(3)] + [rng.integers(0, 256, (B, A))]
    # chunks longer than the decode kernels take (8 < S < 32, and S >= 32
    # over a shared prefix; the plain route's prompt is already 47 tokens):
    # the reference's XLA path, the port's attention() over the cache
    steps += [rng.integers(0, 256, (B, 12)), rng.integers(0, 256, (B, 33))][: 2 if shared else 1]
    jl, tl = [], []
    if shared:
        pm = np.array([0, 0, 1, 1], np.int32)
        head = prompt[::2, :P0]
        j_sh = jm.init_cache(2, P0)
        _, _, j_sh = jm.apply(params, jnp.asarray(head, jnp.int32), cache=j_sh, cache_index=0)
        t_sh = tm.init_cache(2, P0)
        with torch.no_grad():
            tm(torch.from_numpy(head), cache=t_sh, cache_index=0)
        jkw = dict(shared_cache=j_sh, shared_len=P0, prefix_map=jnp.asarray(pm))
        tkw = dict(shared_cache=t_sh, shared_len=P0, prefix_map=torch.from_numpy(pm))
        first, ci = prompt[:, P0:], P0
        jc, tc = jm.init_cache(B, T + 64), tm.init_cache(B, T + 64)
    else:
        jkw, tkw, first, ci = {}, {}, prompt, 0
        jc, tc = jm.init_cache(B, P0 + T + 64), tm.init_cache(B, P0 + T + 64)
    j_step = jax.jit(lambda p, ids, c, i: jm.apply(p, ids, cache=c, cache_index=i, **jkw))
    for ids in [first] + steps:
        lg, _, jc = j_step(params, jnp.asarray(ids, jnp.int32), jc, jnp.int32(ci))
        jl.append(np.asarray(lg))
        with torch.no_grad():
            tl.append(tm(torch.from_numpy(ids), cache=tc, cache_index=ci, **tkw)[0].numpy())
        ci += ids.shape[1]
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, **TOL[kv])


def _rollout_inputs(seed, B, n, P, F, A, vocab):
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, vocab, (B, P))
    prompt[n:2 * n, : P - A] = prompt[0, : P - A]  # groups share the prompt head
    return prompt, rng.integers(0, vocab, (B, F + 1, A))


ROLLOUTS = [
    # (name, kv, cache_segments, route)
    ("plain_1seg", "bf16", 1, "plain"),
    ("plain_4seg_int8", "int8", 4, "plain"),
    ("shared_4seg", "bf16", 4, "interleaved"),
    ("shared_1seg_int8", "int8", 1, "interleaved"),
    ("per_row_prefix", "int8", 4, "per_row"),
]


@pytest.mark.parametrize("name,kv,segs,route", ROLLOUTS)
def test_greedy_rollout_tokens_equal_jax(name, kv, segs, route):
    jm, params, tm = _pair(kv, seed=2)
    F, V, A, P0 = 4, 6, 7, 33
    P = P0 + A
    roll = dict(prompt_length=P, response_length=F * (V + A), num_frames=F,
                interact_max_tokens=V, action_dim=A, do_sample=False, cache_segments=segs)
    jcfg, tcfg = j_roll.WMRolloutConfig(**roll), t_roll.WMRolloutConfig(**roll)
    if route == "plain":
        prompt, actions = _rollout_inputs(3, 3, 1, P, F, A, 256)
        jkw = tkw = {}
        ids = prompt
    else:
        # "interleaved": 2 samples x (n = 2 policy rows + 1 gt row), the
        # training step's n + 1 groups; "per_row": every row its own prefix
        B, n1 = 6, 3
        heads = np.random.default_rng(4).integers(0, 256, (2 if route == "interleaved" else B, P0))
        pm = (np.repeat(np.arange(2), n1) if route == "interleaved" else np.arange(B)).astype(np.int32)
        _, actions = _rollout_inputs(5, B, n1, P, F, A, 256)
        ids = actions[:, 0]  # each row's own 7-token prompt tail
        jkw = dict(shared_prefix=jnp.asarray(heads, jnp.int32), prefix_map=jnp.asarray(pm),
                   prefix_run=3 if route == "interleaved" else 1)
        tkw = dict(shared_prefix=torch.from_numpy(heads), prefix_map=torch.from_numpy(pm))
    j_out = jax.jit(lambda p, i, a: j_roll.generate_sequences(jm, p, jax.random.key(0), i, a,
                                                              jcfg, **jkw))(
        params, jnp.asarray(ids, jnp.int32), jnp.asarray(actions, jnp.int32))
    t_out = t_roll.generate_sequences(tm, torch.Generator().manual_seed(0), torch.from_numpy(ids),
                                      torch.from_numpy(actions), tcfg, **tkw)
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))


def test_grow_cache_and_uniform_prefix_run_match_jax():
    tm = t_tf.Decoder(t_tf.TransformerConfig(vocab_size=8, hidden_size=128, intermediate_size=8,
                                             num_layers=2, num_heads=2, num_kv_heads=2,
                                             kv_cache_dtype="int8"))
    cache = tm.init_cache(3, 70)
    assert [tuple(c.shape) for c in cache] == [(2, 3, 128, 128)] * 2 + [(2, 3, 2, 128)] * 2
    cache[0][:, :, :5] = 7
    grown = t_roll.grow_cache(cache, 300, 128, tm.cache_seq_axes())
    j_grown = j_roll.grow_cache(tuple(jnp.asarray(c.float().numpy()) for c in cache), 300, 128,
                                (2, 2, 3, 3))
    for a, b in zip(grown, j_grown):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b))
    for pm in ([0] * 6, [0, 0, 1, 1, 2, 2], [0, 0, 0, 1, 1, 1], [0, 1, 1, 2], list(range(5))):
        assert t_roll.uniform_prefix_run(pm) == j_roll.uniform_prefix_run(pm)


@pytest.mark.parametrize("top_k,top_p,temp", [(-1, 0.8, 1.0), (-1, 0.5, 0.7), (20, 0.9, 1.0),
                                              (-1, 1.0, 1.0)])
def test_filtered_logits_equal_jax_exactly(top_k, top_p, temp):
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(16, 900)) * 3).astype(np.float32)
    logits[0, :10] = logits[0].max() + 1.0  # ten tied leaders
    logits[1, 100:400] = 0.5  # a wide tie at the nucleus boundary
    logits[2] = 0.0  # all tied
    j = np.asarray(j_sampling.filtered_logits(jnp.asarray(logits), temp, top_k, top_p))
    t = t_sampling.filtered_logits(torch.from_numpy(logits), temp, top_k, top_p).numpy()
    np.testing.assert_array_equal(t, j)
    assert (t[0, :10] == logits[0, :10] / np.float32(temp)).all()  # ties all kept


def test_sample_token_frequencies_and_greedy():
    rng = np.random.default_rng(6)
    logits = torch.from_numpy((rng.normal(size=(1, 12)) * 1.5).astype(np.float32))
    probs = torch.softmax(t_sampling.filtered_logits(logits, 1.0, -1, 0.8), -1)[0].numpy()
    n = 40000
    gen = torch.Generator().manual_seed(0)
    draws = t_sampling.sample_token(gen, logits.expand(n, 12), 1.0, -1, 0.8).numpy()
    freq = np.bincount(draws, minlength=12) / n
    se = np.sqrt(probs * (1 - probs) / n)
    assert (np.abs(freq - probs) <= 5 * se + 1e-12).all(), (freq, probs)
    assert (freq[probs == 0] == 0).all()  # nothing outside the nucleus
    greedy = t_sampling.sample_token(gen, logits, do_sample=False)
    assert greedy.item() == int(np.asarray(j_sampling.sample_token(
        jax.random.key(0), jnp.asarray(logits.numpy()), do_sample=False))[0])


def test_token_ids_are_int32_as_in_jax():
    logits = np.random.default_rng(8).normal(size=(3, 40)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    for kw in (dict(do_sample=False), dict(top_p=0.8)):
        j = np.asarray(j_sampling.sample_token(jax.random.key(0), jnp.asarray(logits), **kw))
        t = t_sampling.sample_token(gen, torch.from_numpy(logits), **kw)
        assert t.dtype == torch.int32 and j.dtype == np.int32
    jm, params, tm = _pair("int8", seed=2)
    F, V, A = 1, 2, 7
    roll = dict(prompt_length=20, response_length=F * (V + A), num_frames=F,
                interact_max_tokens=V, action_dim=A, do_sample=False)
    prompt, actions = _rollout_inputs(3, 2, 1, 20, F, A, 256)
    jcfg = j_roll.WMRolloutConfig(**roll)
    j_out = jax.jit(lambda p, i, a: j_roll.generate_sequences(jm, p, jax.random.key(0), i, a, jcfg))(
        params, jnp.asarray(prompt, jnp.int32), jnp.asarray(actions, jnp.int32))
    t_out = t_roll.generate_sequences(tm, torch.Generator(), torch.from_numpy(prompt),
                                      torch.from_numpy(actions), t_roll.WMRolloutConfig(**roll))
    assert t_out.dtype == torch.int32 and np.asarray(j_out).dtype == np.int32
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))


def _load_tree(path, like):
    """tools/rft_evidence.py's layout: leaves p0..pN in tree-flatten order."""
    with np.load(path) as z:
        leaves, treedef = jax.tree_util.tree_flatten(like)
        assert len(z.files) == len(leaves)
        return jax.tree_util.tree_unflatten(
            treedef, [np.asarray(z[f"p{i}"], l.dtype) for i, l in enumerate(leaves)])


def test_trained_push_wm_greedy_frame_equals_jax():
    """The push preset's WM as trained (hidden 256, 6 layers, 4 heads of 64,
    tools/rft_evidence.py --wm-* overrides), greedy on real token prompts
    (wm_tokens.npz: ctx 64 + dyn 16 + 7 actions = 87 prompt tokens)."""
    kw = dict(vocab_size=9008, hidden_size=256, intermediate_size=1024, num_layers=6,
              num_heads=4, num_kv_heads=4)
    jm = j_tf.Decoder(j_tf.TransformerConfig(dtype=jnp.float32, param_dtype=jnp.float32,
                                             attn_impl="xla", **kw))
    like = jax.eval_shape(lambda r: jm.init(r, jnp.zeros((1, 8), jnp.int32)), jax.random.key(0))
    params = _load_tree(os.path.join(EVIDENCE, "wm.npz"), like)
    tm = t_tf.Decoder(t_tf.TransformerConfig(dtype=torch.float32, param_dtype=torch.float32, **kw))
    tm.load_state_dict(flax_to_torch(params, "wm"), strict=True)
    with np.load(os.path.join(EVIDENCE, "wm_tokens.npz")) as z:
        rows = np.asarray(z["ids"][:: 4096][:4], np.int64)  # 4 segments
    P, V, A = 87, 16, 7
    prompt = rows[:, :P]
    resp = rows[:, P:].reshape(4, -1, V + A)
    actions = np.concatenate([prompt[:, None, P - A:], resp[:, :, V:]], axis=1)[:, :2]
    roll = dict(prompt_length=P, response_length=V + A, num_frames=1, interact_max_tokens=V,
                action_dim=A, do_sample=False, cache_segments=1)
    j_out = j_roll.generate_sequences(jm, params, jax.random.key(0), jnp.asarray(prompt, jnp.int32),
                                      jnp.asarray(actions, jnp.int32), j_roll.WMRolloutConfig(**roll))
    t_out = t_roll.generate_sequences(tm.eval(), torch.Generator(), torch.from_numpy(prompt),
                                      torch.from_numpy(actions), t_roll.WMRolloutConfig(**roll))
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    # a trained WM predicts the recorded frame far better than chance
    assert (t_out.numpy()[:, :V] == resp[:, 0, :V]).mean() > 0.2


def test_logprobs_and_position_ids_match_jax():
    from vla_rft_tpu.ops import masked as j_masked
    from vla_rft_tpu_torch.ops import masked as t_masked

    rng = np.random.default_rng(7)
    logits = (rng.normal(size=(3, 5, 300)) * 4).astype(np.float32)
    labels = rng.integers(0, 300, (3, 5))
    np.testing.assert_allclose(
        t_masked.logprobs_from_logits(torch.from_numpy(logits), torch.from_numpy(labels)).numpy(),
        np.asarray(j_masked.logprobs_from_logits(jnp.asarray(logits), jnp.asarray(labels))),
        atol=1e-5, rtol=1e-6)
    mask = np.array([[0, 0, 1, 1, 1], [1, 1, 1, 1, 1], [1, 1, 0, 0, 0]], np.float32)
    np.testing.assert_array_equal(
        t_masked.compute_position_id_with_mask(torch.from_numpy(mask)).numpy(),
        np.asarray(j_masked.compute_position_id_with_mask(jnp.asarray(mask))))
