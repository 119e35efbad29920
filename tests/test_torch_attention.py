"""The port's attention against the JAX reference, on the CPU.

`attention_plain` (the twin the port runs for CPU tensors) is held to
`vla_rft_tpu.ops.attention._attention_xla` and to the Pallas flash forward
in interpret mode (block 32), f32, atol 2e-5 / rtol 1e-4 as in
tests/test_ops.py; the LSE is held to `_flash_fwd_impl`'s.  Inputs are made
with numpy from fixed seeds and handed to both frameworks.  The CUDA kernel
itself is tested on a GPU by tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vla_rft_tpu.ops.attention import _flash_fwd_impl
from vla_rft_tpu.ops.attention import attention as j_attention
from vla_rft_tpu_torch.ops import attention as tattn

ATOL, RTOL = 2e-5, 1e-4  # f32, as tests/test_ops.py's flash-vs-xla parity


def _qkv(seed, B=2, Sq=96, Sk=96, Hq=4, Hkv=2, D=32):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, Sq, Hq, D)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(B, Sk, Hkv, D)) * 0.3).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    return q, k, v


# (name, shapes, mask kwargs); each case is run causal and non-causal
CASES = [
    ("kv_lens", dict(), dict(kv_lens=[96, 70])),
    ("kv_starts", dict(Sq=64, Sk=64), dict(kv_starts=[0, 16])),
    ("q_offset", dict(Sq=32, Sk=64), dict(q_offset=[32, 32])),
    ("gqa_7to1_ragged", dict(Sq=50, Sk=77, Hq=14, Hkv=2), dict(kv_lens=[77, 41])),
    # row 1 has no valid key at all: kv_starts >= kv_lens
    ("fully_masked_row", dict(Sq=40, Sk=40), dict(kv_lens=[40, 10], kv_starts=[0, 10])),
]


def _np_kwargs(kw):
    return {k: np.asarray(v, np.int32) for k, v in kw.items()}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name,shape,kw", CASES, ids=[c[0] for c in CASES])
def test_plain_twin_matches_xla_and_pallas(name, shape, kw, causal):
    q, k, v = _qkv([c[0] for c in CASES].index(name), **shape)
    jkw = {k_: jnp.asarray(v_) for k_, v_ in _np_kwargs(kw).items()}
    ref = j_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, impl="xla", **jkw
    )
    fl = j_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, impl="pallas",
        block_q=32, block_k=32, interpret=True, **jkw,
    )
    tkw = {k_: torch.as_tensor(v_) for k_, v_ in _np_kwargs(kw).items()}
    out = tattn.attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal, **tkw
    ).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out, np.asarray(fl), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_lse_matches_flash_fwd_impl(causal):
    q, k, v = _qkv(7, Sq=64, Sk=64, Hq=14, Hkv=2)
    kv_lens = np.asarray([64, 30], np.int32)
    kv_starts = np.asarray([0, 30], np.int32)  # row 1 fully masked
    q_off = np.zeros(2, np.int32)
    B, Sq, Hq, D = q.shape
    _, (_, lse_j, *_rest) = _flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_lens),
        jnp.asarray(q_off), jnp.asarray(kv_starts), causal, D ** -0.5, 32, 32, True,
    )
    lse_j = np.asarray(lse_j)[:, :, :Sq, 0].transpose(0, 2, 1)  # (B, Sq, Hq)
    _, lse_t = tattn.attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal,
        kv_lens=torch.as_tensor(kv_lens), kv_starts=torch.as_tensor(kv_starts),
        return_lse=True,
    )
    np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=ATOL, rtol=RTOL)


def test_fully_masked_row_gives_exact_zero_and_neg_inf_lse():
    q, k, v = _qkv(3, Sq=16, Sk=16)
    o, lse = tattn.attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True,
        kv_lens=torch.tensor([16, 0]), return_lse=True,
    )
    assert torch.equal(o[1], torch.zeros_like(o[1]))
    assert torch.all(lse[1] == tattn.NEG_INF)
    assert torch.all(torch.isfinite(o[0])) and torch.all(lse[0] > tattn.NEG_INF)


def test_cpu_tensors_take_the_plain_twin_and_the_kernel_refuses_them():
    q, k, v = _qkv(4, B=1, Sq=8, Sk=8, Hq=2, Hkv=1, D=64)
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    before = tattn.launches
    tattn.attention(q, k, v, causal=True)
    assert tattn.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        tattn.flash_fwd(q, k, v, causal=True)
