"""The port's split-cache decode attention (kernels #4/#5) on the CPU.

The plain twins in `vla_rft_tpu_torch/ops/decode_attention_hd.py`, which the
port runs for CPU tensors and holds the CUDA kernels to on the card, are
held to the JAX package two ways, with inputs made by numpy from fixed seeds:

* against the reference's XLA fallback, through a one-layer `Decoder.apply`
  decode call on caches planted with random values (int8 with bf16 scales,
  or f32), ragged lengths, `kv_starts` / `shared_starts` and uniform or
  per-row `prefix_map`: logits within atol 2e-5 / rtol 1e-4 (f32 round-off
  of the same arithmetic);
* against `decode_attention_shared_hd` / `decode_attention_hd` in Pallas
  interpret mode: atol 0.15 / rtol 0.1 for int8 caches (the Pallas kernel
  requantises q and p to int8, the fallback does not) and 0.02 for bf16,
  the tolerances of tests/test_ops_hd.py.

The int8 KV quantisation is held to the JAX decoder's cache bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kernel_mode import INTERPRET
from vla_rft_tpu.models import transformer as j_tf
from vla_rft_tpu.ops.decode_attention_hd import (
    decode_attention_hd as j_decode_hd,
    decode_attention_shared_hd as j_decode_shared_hd,
)
from vla_rft_tpu_torch.convert import flax_to_torch
from vla_rft_tpu_torch.models import transformer as t_tf
from vla_rft_tpu_torch.ops import decode_attention_hd as tdec

D = 64


def _caches(rng, rows, S, Hkv, int8):
    """K/V caches (rows, S, Hkv*D) with (rows, Hkv, S) scales (int8) or
    bf16-representable f32 values, as numpy."""
    if int8:
        k8 = rng.integers(-127, 128, (rows, S, Hkv * D)).astype(np.int8)
        v8 = rng.integers(-127, 128, (rows, S, Hkv * D)).astype(np.int8)
        bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
        sk = bf(rng.uniform(0.01, 0.05, (rows, Hkv, S)))
        sv = bf(rng.uniform(0.01, 0.05, (rows, Hkv, S)))
        return k8, v8, sk, sv
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    return bf(rng.normal(size=(rows, S, Hkv * D))), bf(rng.normal(size=(rows, S, Hkv * D))), None, None


def _t_scales(sk, sv):
    return None if sk is None else (torch.from_numpy(sk).bfloat16(), torch.from_numpy(sv).bfloat16())


def _j_scales(sk, sv):
    return None if sk is None else (jnp.asarray(sk[None], jnp.bfloat16), jnp.asarray(sv[None], jnp.bfloat16))


# --------------------------------------------------- twins vs Pallas interpret
PALLAS_CASES = [
    # (sq, g, per_row_prefix)
    (1, 1, False), (3, 1, True), (7, 1, False), (1, 2, True), (7, 2, False), (3, 2, False),
]


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("sq,g,per_row", PALLAS_CASES)
def test_shared_twin_matches_pallas_interpret(sq, g, per_row, int8):
    rng = np.random.default_rng(10 * sq + g)
    B, Sr, Sp, Hkv, B_u = 4, 32, 48, 2, 2
    Hq = Hkv * g
    shared_valid = 45
    prefix_map = np.array([1, 0, 0, 1] if per_row else [0, 0, 1, 1], np.int32)
    # the Pallas kernel reads shared_starts once per block of block_b rows
    shared_starts = np.array([3, 0, 5, 0] if per_row else [3, 3, 0, 0], np.int32)
    own_lens = np.array([sq, 20, 32, 9], np.int32)  # row 0 holds only its current block
    q = rng.normal(size=(B, sq, Hq, D)).astype(np.float32)
    ck, cv, sk, sv = _caches(rng, B, Sr, Hkv, int8)
    sck, scv, ssk, ssv = _caches(rng, B_u, Sp, Hkv, int8)

    ref = j_decode_shared_hd(
        jnp.asarray(q), jnp.asarray(ck[None]), jnp.asarray(cv[None]), jnp.asarray(sck[None]),
        jnp.asarray(scv[None]), jnp.int32(0), jnp.asarray(own_lens), jnp.asarray(prefix_map),
        shared_valid, scales=_j_scales(sk, sv), shared_scales=_j_scales(ssk, ssv),
        interpret=INTERPRET, block_b=1 if per_row else 2, shared_starts=jnp.asarray(shared_starts),
    )
    kv_lens = shared_valid + own_lens
    out = tdec.decode_shared_plain(
        torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv), torch.from_numpy(sck),
        torch.from_numpy(scv), torch.from_numpy(prefix_map), shared_len=shared_valid,
        kv_lens=torch.from_numpy(kv_lens), q_offset=torch.from_numpy(kv_lens - sq),
        shared_starts=torch.from_numpy(shared_starts), scales=_t_scales(sk, sv),
        shared_scales=_t_scales(ssk, ssv),
    )
    tol = dict(atol=0.15, rtol=0.1) if int8 else dict(atol=0.02, rtol=0.02)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("sq,g", [(1, 1), (3, 2), (7, 1)])
def test_plain_twin_matches_pallas_interpret(sq, g, int8):
    rng = np.random.default_rng(100 + sq + g)
    B, S, Hkv = 4, 64, 2
    Hq = Hkv * g
    kv_lens = np.array([40, sq, 64, 23], np.int32)
    kv_starts = np.array([0, 0, 11, 4], np.int32)
    q = rng.normal(size=(B, sq, Hq, D)).astype(np.float32)
    ck, cv, sk, sv = _caches(rng, B, S, Hkv, int8)
    ref = j_decode_hd(
        jnp.asarray(q), jnp.asarray(ck[None]), jnp.asarray(cv[None]), jnp.int32(0),
        jnp.asarray(kv_lens), kv_starts=jnp.asarray(kv_starts), scales=_j_scales(sk, sv),
        interpret=INTERPRET, block_b=2,
    )
    out = tdec.decode_plain(
        torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv),
        kv_lens=torch.from_numpy(kv_lens), q_offset=torch.from_numpy(kv_lens - sq),
        kv_starts=torch.from_numpy(kv_starts), scales=_t_scales(sk, sv),
    )
    tol = dict(atol=0.15, rtol=0.1) if int8 else dict(atol=0.02, rtol=0.02)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32), **tol)


# ------------------------------------- twins vs the XLA fallback (Decoder.apply)
def _one_layer(g, int8):
    kw = dict(vocab_size=96, hidden_size=128, intermediate_size=128, num_layers=1,
              num_heads=2 * g, num_kv_heads=2, head_dim=D, rope_theta=1e4)
    jcfg = j_tf.TransformerConfig(dtype=jnp.float32, param_dtype=jnp.float32,
                                  kv_cache_dtype="int8" if int8 else "bf16", attn_impl="xla", **kw)
    tcfg = t_tf.TransformerConfig(dtype=torch.float32, param_dtype=torch.float32,
                                  kv_cache_dtype="int8" if int8 else "bf16", **kw)
    jm = j_tf.Decoder(jcfg)
    shapes = jax.eval_shape(lambda r: jm.init(r, jnp.zeros((1, 4), jnp.int32)), jax.random.key(0))
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda s: (rng.normal(scale=0.05, size=s.shape) + (1.0 if len(s.shape) == 1 else 0.0))
        .astype(np.float32), shapes)
    tm = t_tf.Decoder(tcfg)
    tm.load_state_dict(flax_to_torch(params, "wm"), strict=True)
    return jm, params, tm


def _planted(rng, rows, S, int8):
    ck, cv, sk, sv = _caches(rng, rows, S, 2, int8)
    arrs = (ck, cv) if not int8 else (ck, cv, sk, sv)
    j = tuple(jnp.asarray(a[None], jnp.bfloat16 if a.dtype == np.float32 and int8 else a.dtype)
              for a in arrs)
    t = tuple(torch.from_numpy(a[None].copy()) for a in arrs)
    if int8:
        t = t[:2] + tuple(x.bfloat16() for x in t[2:])
    return j, t


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("sq", [1, 3, 7])
@pytest.mark.parametrize("shared", [True, False])
def test_twins_match_xla_fallback_in_a_decode_call(shared, sq, g, int8):
    jm, params, tm = _one_layer(g, int8)
    rng = np.random.default_rng(sq + 10 * g + 100 * int8)
    B = 4
    ids = rng.integers(0, 96, (B, sq))
    if shared:
        Sp, shared_len, Sr = 56, 50, 40
        ci = shared_len + 20  # 20 own positions already written
        jsh, tsh = _planted(rng, 2, Sp, int8)
        jc, tc = _planted(rng, B, Sr, int8)
        prefix_map = np.array([0, 1, 1, 0], np.int32)  # per-row, as the gt chunk
        kv_lens = np.array([ci + sq, ci + sq - 1, ci + 2, ci + sq], np.int32)
        starts = np.array([0, 4, 0, 9], np.int32)
        jkw = dict(shared_cache=jsh, shared_len=shared_len, prefix_map=jnp.asarray(prefix_map),
                   shared_starts=jnp.asarray(starts))
        tkw = dict(shared_cache=tsh, shared_len=shared_len, prefix_map=torch.from_numpy(prefix_map),
                   shared_starts=torch.from_numpy(starts))
    else:
        S, ci = 48, 30
        jc, tc = _planted(rng, B, S, int8)
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


def test_int8_quantization_matches_the_jax_cache_bit_for_bit():
    """One token per row at position 0 (rope is then exact), 128 rows: the
    f32 cache of the JAX decoder gives k and v exactly, the int8 cache of
    the same decoder their quantisation; the port's `quantize_kv` of the
    former must equal the latter, values and bf16 scales."""
    kw = dict(vocab_size=128, hidden_size=128, intermediate_size=128, num_layers=1,
              num_heads=2, num_kv_heads=2, dtype=jnp.float32, param_dtype=jnp.float32)
    rng = np.random.default_rng(3)
    ids = jnp.asarray(np.arange(128)[:, None], jnp.int32)
    caches = {}
    for kv in ("bf16", "int8"):
        m = j_tf.Decoder(j_tf.TransformerConfig(kv_cache_dtype=kv, **kw))
        if kv == "bf16":
            shapes = jax.eval_shape(lambda r: m.init(r, ids), jax.random.key(0))
            params = jax.tree_util.tree_map(
                lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
        _, _, caches[kv] = m.apply(params, ids, cache=m.init_cache(128, 8), cache_index=0)
    k = np.asarray(caches["bf16"][0][0, :, :1]).reshape(128, 1, 2, D)
    v = np.asarray(caches["bf16"][1][0, :, :1]).reshape(128, 1, 2, D)
    jck, jcv, jsk, jsv = (np.asarray(a) for a in caches["int8"])
    for x, jc, js in ((k, jck, jsk), (v, jcv, jsv)):
        q8, sc = t_tf.quantize_kv(torch.from_numpy(x.copy()))
        np.testing.assert_array_equal(q8.numpy().reshape(128, 2 * D), jc[0, :, 0])
        np.testing.assert_array_equal(sc.float().numpy().reshape(128, 2),
                                      np.asarray(js[0, :, :, 0], np.float32))
    assert np.abs(jck).max() == 127  # the max of each (position, head) maps to +-127


def test_quantization_rounds_half_to_even_with_the_f32_scale():
    x = torch.tensor([[[[127.0, 2.5, -3.5, 0.5, 1.5, -0.5] + [0.0] * 58]]])
    q8, sc = t_tf.quantize_kv(x)  # scale 1.0 exactly
    assert sc.item() == 1.0
    assert q8[0, 0, 0, :6].tolist() == [127, 2, -4, 0, 2, 0]
    # the f32 scale rounds the values; only the stored scale is bf16
    y = torch.full((1, 1, 1, D), 0.2978)
    y[..., 0] = 1.01
    q8, sc = t_tf.quantize_kv(y)
    scale32 = np.float32(1.01) / np.float32(127.0)
    scale16 = np.float32(sc.float().item())
    assert scale16 != scale32  # the stored scale is the bf16 rounding of the f32 one
    assert np.round(np.float32(0.2978) / scale32) != np.round(np.float32(0.2978) / scale16)
    assert q8[0, 0, 0, 1].item() == int(np.round(np.float32(0.2978) / scale32))
