"""The port's one-token decode attention that writes its own K/V row
(kernel #10) on the CPU.

The plain twin in `vla_rft_tpu_torch/ops/fused_decode_attention.py`, which
the port runs for CPU tensors and holds the CUDA kernel to on the card, is
held to the reference's `fused_decode_attention` in Pallas interpret mode,
with inputs made by numpy from fixed seeds: the case of
tests/test_ops.py:225 (f32 cache, D 32, row 37, kv_starts [0, 5], block_k
16, layer 1 of 2), plus a bf16 cache, the first row (no history) and
kv_starts at or past the row (only the current token is attended).  The
written caches are bit-equal to the reference's; the output is within
atol 3e-5 / rtol 1e-4 for f32 (the same f32 arithmetic in another order)
and within one bf16 ulp (2^-7 relative) plus 1e-5 for a bf16 cache and q
(both round the f32 result once).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kernel_mode import INTERPRET
from vla_rft_tpu.ops.fused_decode_attention import fused_decode_attention as j_fused
from vla_rft_tpu_torch.ops import fused_decode_attention as tfda

CASES = [
    # (name, dtype, idx, kv_starts)
    ("test_ops_case", "float32", 37, [0, 5]),
    ("bf16_cache", "bfloat16", 37, [0, 5]),
    ("first_row", "float32", 0, [0, 0]),
    ("starts_at_or_past_the_row", "bfloat16", 20, [20, 31]),
    ("last_row", "float32", 63, [3, 62]),
]


@pytest.mark.parametrize("name,dtype,idx,kv_starts", CASES, ids=[c[0] for c in CASES])
def test_twin_matches_pallas_interpret(name, dtype, idx, kv_starts):
    rng = np.random.default_rng(9)
    L, B, Hkv, G, S, D = 2, 2, 2, 2, 64, 32
    Hq, li = Hkv * G, 1
    jdt = jnp.dtype(dtype)
    arr = lambda shape, s: np.asarray(jnp.asarray(rng.normal(size=shape) * s, jdt))
    ck, cv = arr((L, B, Hkv, S, D), 0.3), arr((L, B, Hkv, S, D), 1.0)
    q = arr((B, 1, Hq, D), 0.3)
    k_new, v_new = arr((B, 1, Hkv, D), 0.3), arr((B, 1, Hkv, D), 1.0)
    out, nck, ncv = j_fused(jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
                            jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(li), jnp.asarray(idx),
                            jnp.asarray(kv_starts), block_k=16, interpret=INTERPRET)
    t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))
    tck, tcv = t(ck), t(cv)
    got, rck, rcv = tfda.fused_decode_attention(t(q), t(k_new), t(v_new), tck, tcv, li, idx,
                                                torch.tensor(kv_starts))
    assert rck is tck and rcv is tcv  # written in place
    assert got.dtype == tck.dtype and got.shape == (B, 1, Hq, D)
    np.testing.assert_array_equal(tck.float().numpy(), np.asarray(nck, np.float32))
    np.testing.assert_array_equal(tcv.float().numpy(), np.asarray(ncv, np.float32))
    ref = np.asarray(out, np.float32)
    tol = dict(atol=3e-5, rtol=1e-4) if dtype == "float32" else dict(atol=1e-5, rtol=2 ** -7)
    np.testing.assert_allclose(got.float().numpy(), ref, **tol)
    if kv_starts[0] >= idx:  # no history: the current token's value
        np.testing.assert_allclose(got[0].float().numpy(),
                                   np.repeat(v_new[0].astype(np.float32), G, axis=1), **tol)


def test_kernel_refuses_cpu_tensors():
    q = torch.zeros(1, 1, 2, 32)
    kv = torch.zeros(1, 1, 2, 32)
    ck = torch.zeros(1, 1, 2, 8, 32)
    before = tfda.launches
    with pytest.raises(ValueError, match="CUDA"):
        tfda.fused_decode_attention_kernel(q, kv, kv, ck, ck.clone(), 0, 3)
    with pytest.raises(ValueError, match="impl"):
        tfda.fused_decode_attention(q, kv, kv, ck, ck.clone(), 0, 3, impl="pallas")
    assert tfda.launches == before
