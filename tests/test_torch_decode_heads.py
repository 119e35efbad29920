"""The port's decode attention over the 'heads' KV-cache layout (kernels
#6/#7) on the CPU.

The plain twins in `vla_rft_tpu_torch/ops/decode_attention.py`, which the
port runs for CPU tensors and holds the CUDA kernels to on the card, are
held to the JAX package with inputs made by numpy from fixed seeds:

* against `decode_attention_shared` / `decode_attention` in Pallas
  interpret mode over the cases of tests/test_ops.py:201-470 (GQA, ragged
  own lengths, shared_valid short of the prefix cache, shared_starts /
  kv_starts, block_b > 1), the JAX side on unpacked caches and on caches
  packed with `pack_kv_heads`: atol 0.15 / rtol 0.1 for int8 caches (the
  Pallas kernels requantise q and p to int8, the fallback does not) and
  0.02 for bf16 (the tolerances of tests/test_ops_hd.py);
* against the reference's XLA fallback, through a one-layer `Decoder.apply`
  decode call with kv_layout="heads" on planted caches (packed on the JAX
  side for 2 kv heads of 64, unpacked for 3): logits within atol 2e-5 /
  rtol 1e-4 (f32 round-off of the same arithmetic).

The port's int8 'heads' cache equals the JAX decoder's bit for bit after
`unpack_kv_heads`, and the port's 'heads' and 'hd' routes give the same
logits on the same weights.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kernel_mode import INTERPRET
from vla_rft_tpu.models import transformer as j_tf
from vla_rft_tpu.ops.decode_attention import (
    decode_attention as j_decode,
    decode_attention_shared as j_decode_shared,
)
from vla_rft_tpu_torch.convert import flax_to_torch
from vla_rft_tpu_torch.models import transformer as t_tf
from vla_rft_tpu_torch.ops import decode_attention as tdec

bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _caches(rng, rows, Hkv, S, D, int8):
    """K/V caches (rows, Hkv, S, D) with (rows, Hkv, S) scales (int8) or
    bf16-representable f32 values, as numpy."""
    if int8:
        k8, v8 = (rng.integers(-127, 128, (rows, Hkv, S, D)).astype(np.int8) for _ in range(2))
        sk, sv = (bf(rng.uniform(0.01, 0.05, (rows, Hkv, S))) for _ in range(2))
        return k8, v8, sk, sv
    return bf(rng.normal(size=(rows, Hkv, S, D))), bf(rng.normal(size=(rows, Hkv, S, D))), None, None


def _t_scales(sk, sv):
    return None if sk is None else (torch.from_numpy(sk).bfloat16(), torch.from_numpy(sv).bfloat16())


def _j_scales(sk, sv):
    return None if sk is None else (jnp.asarray(sk[None], jnp.bfloat16),
                                    jnp.asarray(sv[None], jnp.bfloat16))


def _j_cache(c, packed):
    c = jnp.asarray(c[None])
    return j_tf.pack_kv_heads(c) if packed else c


def _tol(int8):
    return dict(atol=0.15, rtol=0.1) if int8 else dict(atol=0.02, rtol=0.02)


# --------------------------------------------------- twins vs Pallas interpret
SHARED_CASES = [
    # (sq, g, D, per-row prefix_map and shared_starts, block_b)
    (1, 2, 32, False, 1),  # test_decode_attention_shared_matches_concat_xla
    (7, 2, 32, False, 1),
    (4, 2, 32, False, 2),  # ..._shared_starts_left_padding: starts per block of 2
    (3, 1, 64, True, 1),   # ..._shared_packed_int8, at the WM's head dim
    (7, 1, 64, True, 1),
]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("sq,g,D,per_row,block_b", SHARED_CASES)
def test_shared_twin_matches_pallas_interpret(sq, g, D, per_row, block_b, int8, packed):
    rng = np.random.default_rng(10 * sq + g + D)
    B, Sr, Sp, Hkv, B_u = 4, 32, 48, 2, 2
    Hq = Hkv * g
    shared_valid = 40  # < Sp: the padded tail is masked
    prefix_map = np.array([1, 0, 0, 1] if per_row else [0, 0, 1, 1], np.int32)
    shared_starts = np.array([3, 0, 5, 0] if per_row else [6, 6, 0, 0], np.int32)
    own_lens = np.array([sq, 10 + sq, 20 + sq, 32], np.int32)  # row 0: only its block
    q = rng.normal(size=(B, sq, Hq, D)).astype(np.float32) * 0.5
    ck, cv, sk, sv = _caches(rng, B, Hkv, Sr, D, int8)
    sck, scv, ssk, ssv = _caches(rng, B_u, Hkv, Sp, D, int8)

    ref = j_decode_shared(
        jnp.asarray(q), _j_cache(ck, packed), _j_cache(cv, packed), _j_cache(sck, packed),
        _j_cache(scv, packed), jnp.int32(0), jnp.asarray(own_lens), jnp.asarray(prefix_map),
        shared_valid, scales=_j_scales(sk, sv), shared_scales=_j_scales(ssk, ssv),
        interpret=INTERPRET, block_b=block_b, shared_starts=jnp.asarray(shared_starts),
    )
    kv_lens = shared_valid + own_lens
    out = tdec.decode_shared_plain(
        torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv), torch.from_numpy(sck),
        torch.from_numpy(scv), torch.from_numpy(prefix_map), shared_len=shared_valid,
        kv_lens=torch.from_numpy(kv_lens), q_offset=torch.from_numpy(kv_lens - sq),
        shared_starts=torch.from_numpy(shared_starts), scales=_t_scales(sk, sv),
        shared_scales=_t_scales(ssk, ssv),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32), **_tol(int8))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("g,D,block_b", [(2, 32, 1), (1, 64, 2)])
def test_plain_twin_matches_pallas_interpret(g, D, block_b, int8, packed):
    """test_decode_attention_kernel_matches_xla / _block_b_variants: one
    query token, ragged kv_lens and kv_starts."""
    rng = np.random.default_rng(100 + g + D)
    B, S, Hkv = 4, 64, 2
    Hq = Hkv * g
    kv_lens = np.array([40, 64, 17, 50], np.int32)
    kv_starts = np.array([0, 8, 0, 3], np.int32)
    q = rng.normal(size=(B, 1, Hq, D)).astype(np.float32) * 0.5
    ck, cv, sk, sv = _caches(rng, B, Hkv, S, D, int8)
    ref = j_decode(
        jnp.asarray(q), _j_cache(ck, packed), _j_cache(cv, packed), jnp.int32(0),
        jnp.asarray(kv_lens), kv_starts=jnp.asarray(kv_starts), scales=_j_scales(sk, sv),
        interpret=INTERPRET, block_b=block_b,
    )
    out = tdec.decode_plain(
        torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv),
        kv_lens=torch.from_numpy(kv_lens), q_offset=torch.from_numpy(kv_lens - 1),
        kv_starts=torch.from_numpy(kv_starts), scales=_t_scales(sk, sv),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32), **_tol(int8))


def test_kernels_refuse_cpu_tensors_and_the_front_ends_take_the_twins():
    """On the CPU the front ends run the twins; the kernel wrappers take
    CUDA tensors only and raise before any build."""
    rng = np.random.default_rng(5)
    ck, cv, sk, sv = (torch.from_numpy(a) for a in _caches(rng, 2, 2, 16, 64, True))
    q = torch.from_numpy(rng.normal(size=(2, 1, 2, 64)).astype(np.float32)).bfloat16()
    kw = dict(kv_lens=torch.tensor([9, 16]), q_offset=torch.tensor([8, 15]),
              scales=(sk.bfloat16(), sv.bfloat16()))
    before = (tdec.heads_launches, tdec.shared_heads_launches)
    torch.testing.assert_close(tdec.decode_attention(q, ck, cv, **kw),
                               tdec.decode_plain(q, ck, cv, **kw))
    with pytest.raises(ValueError, match="CUDA"):
        tdec.decode_kernel(q, ck, cv, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        tdec.decode_shared_kernel(q, ck, cv, ck, cv, torch.tensor([0, 1]), shared_len=4,
                                  kv_lens=kw["kv_lens"] + 4, q_offset=kw["q_offset"] + 4,
                                  scales=kw["scales"], shared_scales=kw["scales"])
    assert (tdec.heads_launches, tdec.shared_heads_launches) == before


# ------------------------------------- twins vs the XLA fallback (Decoder.apply)
def _one_layer(g, Hkv, int8):
    kw = dict(vocab_size=96, hidden_size=128, intermediate_size=128, num_layers=1,
              num_heads=Hkv * g, num_kv_heads=Hkv, head_dim=64, rope_theta=1e4)
    kv = "int8" if int8 else "bf16"
    jcfg = j_tf.TransformerConfig(dtype=jnp.float32, param_dtype=jnp.float32, kv_cache_dtype=kv,
                                  attn_impl="xla", kv_layout="heads", **kw)
    tcfg = t_tf.TransformerConfig(dtype=torch.float32, param_dtype=torch.float32,
                                  kv_cache_dtype=kv, kv_layout="heads", **kw)
    jm = j_tf.Decoder(jcfg)
    shapes = jax.eval_shape(lambda r: jm.init(r, jnp.zeros((1, 4), jnp.int32)), jax.random.key(0))
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda s: (rng.normal(scale=0.05, size=s.shape) + (1.0 if len(s.shape) == 1 else 0.0))
        .astype(np.float32), shapes)
    tm = t_tf.Decoder(tcfg)
    tm.load_state_dict(flax_to_torch(params, "wm"), strict=True)
    return jm, params, tm


def _planted(rng, rows, Hkv, S, int8, packed):
    """One layer's planted cache for both sides: JAX (1, rows, Hkv[/2], S,
    D[*2]) (packed as its decoder stores it) and the port's (1, rows, Hkv,
    S, D)."""
    ck, cv, sk, sv = _caches(rng, rows, Hkv, S, 64, int8)
    j = (_j_cache(ck, packed), _j_cache(cv, packed))
    t = (torch.from_numpy(ck[None].copy()), torch.from_numpy(cv[None].copy()))
    if int8:
        j += tuple(jnp.asarray(s[None], jnp.bfloat16) for s in (sk, sv))
        t += tuple(torch.from_numpy(s[None].copy()).bfloat16() for s in (sk, sv))
    return j, t


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("g,Hkv", [(1, 2), (2, 2), (1, 3)])
@pytest.mark.parametrize("sq", [1, 7])
@pytest.mark.parametrize("shared", [True, False])
def test_twins_match_xla_fallback_in_a_decode_call(shared, sq, g, Hkv, int8):
    jm, params, tm = _one_layer(g, Hkv, int8)
    assert jm.cfg.pack_kv == (Hkv % 2 == 0)
    packed = jm.cfg.pack_kv
    rng = np.random.default_rng(sq + 10 * g + 100 * int8 + Hkv)
    B = 4
    ids = rng.integers(0, 96, (B, sq))
    if shared:
        Sp, shared_len, Sr = 56, 50, 40
        ci = shared_len + 20  # 20 own positions already written
        jsh, tsh = _planted(rng, 2, Hkv, Sp, int8, packed)
        jc, tc = _planted(rng, B, Hkv, Sr, int8, packed)
        prefix_map = np.array([0, 1, 1, 0], np.int32)  # per-row, as the gt chunk
        kv_lens = np.array([ci + sq, ci + sq - 1, ci + 2, ci + sq], np.int32)
        starts = np.array([0, 4, 0, 9], np.int32)
        jkw = dict(shared_cache=jsh, shared_len=shared_len, prefix_map=jnp.asarray(prefix_map),
                   shared_starts=jnp.asarray(starts))
        tkw = dict(shared_cache=tsh, shared_len=shared_len,
                   prefix_map=torch.from_numpy(prefix_map), shared_starts=torch.from_numpy(starts))
    else:
        S, ci = 48, 30
        jc, tc = _planted(rng, B, Hkv, S, int8, packed)
        kv_lens = np.array([ci + sq, ci + 1, 12, ci + sq], np.int32)
        starts = np.array([0, 3, 0, 17], np.int32)
        jkw = dict(kv_starts=jnp.asarray(starts))
        tkw = dict(kv_starts=torch.from_numpy(starts))
    j_logits, _, _ = jm.apply(params, jnp.asarray(ids, jnp.int32), cache=jc, cache_index=ci,
                              kv_lens=jnp.asarray(kv_lens), **jkw)
    with torch.no_grad():
        t_logits, _ = tm(torch.from_numpy(ids), cache=tc, cache_index=ci,
                         kv_lens=torch.from_numpy(kv_lens), **tkw)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=2e-5, rtol=1e-4)


def test_int8_heads_cache_matches_the_jax_cache_bit_for_bit():
    """64 rows of 3 tokens from position 0 through the JAX decoder with an
    f32 and with an int8 'heads' cache (2 kv heads of 64: packed on the JAX
    side).  The f32 cache gives k and v exactly; the port's cached write
    path fed them must store, after `unpack_kv_heads`, the JAX int8 cache's
    values and bf16 scales bit for bit, in the (B, Hkv, S, D) layout."""
    B, S = 64, 3
    kw = dict(vocab_size=128, hidden_size=128, intermediate_size=128, num_layers=1,
              num_heads=2, num_kv_heads=2, head_dim=64)
    rng = np.random.default_rng(3)
    ids = jnp.asarray(rng.integers(0, 128, (B, S)), jnp.int32)
    caches = {}
    for kv in ("bf16", "int8"):
        m = j_tf.Decoder(j_tf.TransformerConfig(kv_cache_dtype=kv, kv_layout="heads",
                                                dtype=jnp.float32, param_dtype=jnp.float32, **kw))
        if kv == "bf16":
            shapes = jax.eval_shape(lambda r: m.init(r, ids), jax.random.key(0))
            params = jax.tree_util.tree_map(
                lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
        assert m.cfg.pack_kv
        _, _, caches[kv] = m.apply(params, ids, cache=m.init_cache(B, 8), cache_index=0)
    unpack = lambda a: np.asarray(j_tf.unpack_kv_heads(a))
    k, v = (torch.from_numpy(unpack(c)[0, :, :, :S].copy()).transpose(1, 2)
            for c in caches["bf16"])
    tm = t_tf.Decoder(t_tf.TransformerConfig(kv_cache_dtype="int8", kv_layout="heads",
                                             dtype=torch.float32, param_dtype=torch.float32, **kw))
    cache = tm.init_cache(B, 8)
    rows = lambda x: torch.full((B,), x, dtype=torch.int32)
    c = t_tf.CacheArgs(cache=cache, cache_index=0, kv_lens_eff=rows(S), q_offset=rows(0),
                       kv_starts=rows(0), shared_cache=None, shared_len=0, prefix_map=None,
                       shared_starts=rows(0))
    with torch.no_grad():
        tm.layers[0].self_attn._cached(torch.zeros(B, S, 2, 64), k, v, 0, c, "plain")
    jck, jcv, jsk, jsv = caches["int8"]
    assert cache[0].shape == unpack(jck).shape == (1, B, 2, 128, 64)
    np.testing.assert_array_equal(cache[0].numpy(), unpack(jck))
    np.testing.assert_array_equal(cache[1].numpy(), unpack(jcv))
    np.testing.assert_array_equal(cache[2].float().numpy(), np.asarray(jsk, np.float32))
    np.testing.assert_array_equal(cache[3].float().numpy(), np.asarray(jsv, np.float32))
    assert np.abs(unpack(jck)).max() == 127


@pytest.mark.parametrize("kv", ["int8", "bf16"])
def test_heads_and_hd_routes_give_the_same_logits(kv):
    """One decoder's weights with either cache layout: a shared-prefix
    prefill, the prompt tail, one-token steps and a 7-token chunk, then a
    prefix-free prefill and steps.  The two layouts hold the same numbers,
    so the logits are equal."""
    cfgs = {lay: t_tf.TransformerConfig(vocab_size=96, hidden_size=128, intermediate_size=128,
                                        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                                        kv_cache_dtype=kv, dtype=torch.float32,
                                        param_dtype=torch.float32, kv_layout=lay)
            for lay in ("hd", "heads")}
    torch.manual_seed(0)
    ref = t_tf.Decoder(cfgs["hd"])
    with torch.no_grad():
        for p in ref.parameters():
            p.normal_(0.0, 0.05).add_(1.0 if p.dim() == 1 else 0.0)
    rng = np.random.default_rng(4)
    head = torch.from_numpy(rng.integers(0, 96, (2, 24)))
    steps = [torch.from_numpy(rng.integers(0, 96, (4, s))) for s in (5, 1, 1, 7, 1)]
    pm = torch.tensor([0, 1, 1, 0])
    logits = {}
    for lay, cfg in cfgs.items():
        m = t_tf.Decoder(cfg)
        m.load_state_dict(ref.state_dict())
        out = []
        with torch.no_grad():
            shared = m.init_cache(2, 24)
            m(head, cache=shared, cache_index=0, compute_logits=False)
            cache, ci = m.init_cache(4, 16), 24
            for ids in steps:
                out.append(m(ids, cache=cache, cache_index=ci, shared_cache=shared, shared_len=24,
                             prefix_map=pm, shared_starts=torch.tensor([0, 2, 0, 1]))[0])
                ci += ids.shape[1]
            cache = m.init_cache(4, 48)
            out.append(m(head[pm], cache=cache, cache_index=0)[0])
            for ci, ids in enumerate(steps[1:3], start=24):
                out.append(m(ids, cache=cache, cache_index=ci,
                             kv_starts=torch.tensor([0, 3, 0, 0]))[0])
        logits[lay] = out
    for a, b in zip(logits["hd"], logits["heads"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------- the fused-route guard
def test_heads_int8_weight_rollout_takes_the_unfused_route(monkeypatch):
    """As in the reference (wm_rollout.py:198-206), only an 'hd' int8 cache
    takes decode_step_fused on the card; an int8-weight WM with a 'heads'
    cache decodes through Decoder.forward (QuantLinear), here on the CPU
    with the fused step made to fail if it were called."""
    from vla_rft_tpu_torch.workers import wm_rollout as t_roll

    base = dict(vocab_size=96, hidden_size=128, intermediate_size=128, num_layers=2,
                num_heads=4, num_kv_heads=2, head_dim=64, kv_cache_dtype="int8",
                weights_int8=True)
    hd, heads = (t_tf.TransformerConfig(kv_layout=lay, **base) for lay in ("hd", "heads"))
    assert t_roll.fused_route(hd, on_cuda=True)
    assert not t_roll.fused_route(heads, on_cuda=True)
    assert not t_roll.fused_route(hd, on_cuda=False)

    torch.manual_seed(0)
    bf16 = t_tf.Decoder(dataclasses.replace(heads, weights_int8=False))
    with torch.no_grad():
        for p in bf16.parameters():
            p.normal_(0.0, 0.05).add_(1.0 if p.dim() == 1 else 0.0)
    wm = t_tf.Decoder(heads)
    wm.load_state_dict(t_tf.quantize_decoder_params(bf16.state_dict(), heads), strict=True)

    def fused(*a, **k):
        raise AssertionError("decode_step_fused called for a 'heads' cache")

    calls = []
    forward = t_tf.Decoder.forward
    monkeypatch.setattr(t_roll, "decode_step_fused", fused)
    monkeypatch.setattr(t_tf.Decoder, "forward",
                        lambda self, *a, **k: calls.append(1) or forward(self, *a, **k))
    F, V, A = 2, 3, 7
    roll = t_roll.WMRolloutConfig(prompt_length=24 + A, response_length=F * (V + A),
                                  num_frames=F, interact_max_tokens=V, action_dim=A,
                                  do_sample=False, cache_segments=2)
    rng = np.random.default_rng(1)
    out = t_roll.generate_sequences(
        wm, torch.Generator().manual_seed(0), torch.from_numpy(rng.integers(0, 96, (4, A))),
        torch.from_numpy(rng.integers(0, 96, (4, F + 1, A))), roll,
        shared_prefix=torch.from_numpy(rng.integers(0, 96, (2, 24))),
        prefix_map=torch.tensor([0, 0, 1, 1]))
    assert out.shape == (4, F * (V + A))
    assert len(calls) == 2 + F * (V + 1)  # prefix prefill, tail, then V tokens + 1 chunk a frame
