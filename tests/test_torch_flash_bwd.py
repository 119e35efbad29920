"""The port's flash backward on the CPU, against the JAX reference.

* `attention_bwd_plain` (the twin of kernels #2 and #3, an explicit formula)
  against `jax.grad` through the reference's Pallas flash attention in
  interpret mode (block 32), as tests/test_ops.py::test_flash_grad_matches_xla
  does: f32 inputs from numpy seeds, a random cotangent, over the mask cases
  of tests/test_torch_attention.py, each causal and not.  Tolerance atol
  5e-4 / rtol 1e-3, that test's: the Pallas kernels pad to 32-row blocks and
  sum in another order.
* `FlashAttention` on CPU tensors (twin forward + twin backward) against
  `torch.autograd` through `attention_plain`: the same function computed two
  ways in f32, atol/rtol 1e-5.
* `attention()` takes the autograd Function only when a gradient is needed.
The CUDA kernels themselves are held to the twin on a GPU in
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vla_rft_tpu.ops.attention import attention as j_attention
from vla_rft_tpu_torch.ops import attention as tattn

ATOL, RTOL = 5e-4, 1e-3  # tests/test_ops.py's flash-grad tolerance
TWIN_TOL = dict(atol=1e-5, rtol=1e-5)

# (name, shapes, mask kwargs): tests/test_torch_attention.py's CASES
CASES = [
    ("kv_lens", dict(), dict(kv_lens=[96, 70])),
    ("kv_starts", dict(Sq=64, Sk=64), dict(kv_starts=[0, 16])),
    ("q_offset", dict(Sq=32, Sk=64), dict(q_offset=[32, 32])),
    ("gqa_7to1_ragged", dict(Sq=50, Sk=77, Hq=14, Hkv=2), dict(kv_lens=[77, 41])),
    ("fully_masked_row", dict(Sq=40, Sk=40), dict(kv_lens=[40, 10], kv_starts=[0, 10])),
]


def _inputs(seed, B=2, Sq=96, Sk=96, Hq=4, Hkv=2, D=32):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, Sq, Hq, D)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(B, Sk, Hkv, D)) * 0.3).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    do = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name,shape,kw", CASES, ids=[c[0] for c in CASES])
def test_bwd_twin_matches_jax_grad_of_pallas_flash(name, shape, kw, causal):
    q, k, v, do = _inputs([c[0] for c in CASES].index(name), **shape)
    jkw = {a: jnp.asarray(np.asarray(b, np.int32)) for a, b in kw.items()}

    def fwd(q_, k_, v_):
        return j_attention(q_, k_, v_, causal=causal, impl="pallas", block_q=32, block_k=32,
                           interpret=True, **jkw)

    o_j, vjp = jax.vjp(fwd, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(do))
    tkw = {a: torch.as_tensor(np.asarray(b, np.int32)) for a, b in kw.items()}
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = tattn.attention_plain(tq, tk, tv, causal=causal, return_lse=True, **tkw)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=ATOL, rtol=RTOL)
    got = tattn.attention_bwd_plain(tq, tk, tv, o, lse, torch.from_numpy(do), causal=causal,
                                    **tkw)
    for name_, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == torch.float32 and g.shape == r.shape, name_
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL, rtol=RTOL,
                                   err_msg=name_)
    if name == "fully_masked_row":  # row 1 has no valid key: zero gradients
        assert all(bool((g[1] == 0).all()) for g in got)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name,shape,kw", CASES, ids=[c[0] for c in CASES])
def test_flash_attention_function_matches_autograd_of_plain(name, shape, kw, causal):
    q, k, v, do = _inputs(10 + [c[0] for c in CASES].index(name), **shape)
    tkw = {a: torch.as_tensor(np.asarray(b, np.int32)) for a, b in kw.items()}
    grads = []
    for fn in (tattn.attention, tattn.attention_plain):
        leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        o = fn(*leaves, causal=causal, **tkw)
        grads.append((o.detach(), *torch.autograd.grad(o, leaves, torch.from_numpy(do))))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, **TWIN_TOL)


def test_attention_routes_through_the_function_only_for_gradients():
    q, k, v, _ = _inputs(20, B=1, Sq=8, Sk=8, Hq=2, Hkv=1, D=16)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    o = tattn.attention(q, k, v, causal=True)
    assert o.grad_fn is None
    qg = q.clone().requires_grad_(True)
    o, lse = tattn.attention(qg, k, v, causal=True, return_lse=True)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    assert not lse.requires_grad
    with torch.no_grad():
        assert tattn.attention(qg, k, v, causal=True).grad_fn is None
    with pytest.raises(ValueError, match="impl"):
        tattn.attention(qg, k, v, impl="pallas")
