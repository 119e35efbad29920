"""The port's CUDA kernels against their plain PyTorch twins, on a GPU.

Every test here needs a CUDA device and nvcc, carries the `cuda` marker and
skips without a device.  The file imports no JAX, so it runs on a machine
that has only PyTorch (tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerances: O is bf16 (2^-8 relative) and the flash kernel rounds P to
bf16 for the P.V product, so its O gets atol/rtol 2e-2; the LSE is f32 from
exact bf16 products summed in f32, so it gets atol 1e-3.  The decode kernels
keep P to 16 bits (two bf16 terms) and differ from their twins by that and by
f32 summation order before O is rounded to bf16, so their O gets rtol 2^-7
(one bf16 ulp) and atol 2e-3.
The flash backward kernels round p and dS to bf16 for their second products
and dq/dk/dv to bf16 at the end, and sum in f32 in another order than the
f32 twin: each gradient gets max|d| <= 2^-7 max|ref| + 1e-3.  The fused
decode layers' tolerances are stated above their tests.  The 'heads'
decode kernels (#6/#7) take the decode tolerance and equal #4/#5 bit for
bit on the same numbers; the cache-writing decode (#10) writes rows
bit-equal to its twin's, and its O gets the decode tolerance in bf16 and
1e-5 (relative and absolute) in f32, the same f32 arithmetic in another
order.  The f32 instances of #1-#5 (the push preset's) get max|d| <= 1e-5
max|ref| + 1e-6 per output and gradient, for the same reason.
"""
import dataclasses

import numpy as np
import pytest
import torch

from vla_rft_tpu_torch.models.transformer import Decoder, TransformerConfig
from vla_rft_tpu_torch.models.factory import init_random_
from vla_rft_tpu_torch.ops import attention as tattn


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


KERNEL_CASES = [
    # (B, Sq, Sk, causal, per-row kwargs); heads 14/2 unless "heads" says
    (1, 352, 352, True, {}),
    (4, 352, 352, True, {"kv_lens": [352, 300, 200, 97]}),
    (2, 608, 608, True, {"kv_starts": [0, 37]}),
    (2, 100, 352, True, {"q_offset": [252, 252]}),
    (2, 352, 352, False, {"kv_lens": [352, 0]}),
    (1, 61, 130, False, {}),
    # the WM's shared-prefix prefill (128-query tiles of 8 warps)
    (2, 1088, 1152, True, {"heads": (16, 16), "kv_lens": [1088, 1088]}),
    # Sq and Sk off the 64/128-query and 64-key tiles, both tile plans
    (3, 201, 333, False, {"kv_starts": [0, 70, 5], "kv_lens": [333, 301, 129]}),
    (8, 200, 200, True, {"heads": (16, 16), "kv_lens": [200, 199, 150, 77, 200, 64, 65, 1]}),
    # chunked prefill whose diagonal cuts key tiles mid-way
    (2, 77, 500, True, {"q_offset": [423, 300], "kv_lens": [500, 377]}),
]


def _flash_inputs(dev, B, Sq, Sk, D, kw, seed=0):
    kw = dict(kw)
    Hq, Hkv = kw.pop("heads", (14, 2))
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, Sq, Hq, D, generator=gen, device=dev).bfloat16()
    k = torch.randn(B, Sk, Hkv, D, generator=gen, device=dev).bfloat16()
    v = torch.randn(B, Sk, Hkv, D, generator=gen, device=dev).bfloat16()
    return q, k, v, {k_: torch.tensor(v_, device=dev) for k_, v_ in kw.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("B,Sq,Sk,causal,kw", KERNEL_CASES)
def test_flash_kernel_matches_plain_twin(cuda_device, B, Sq, Sk, causal, kw, D):
    q, k, v, args = _flash_inputs(cuda_device, B, Sq, Sk, D, kw)
    before = tattn.launches
    o, lse = tattn.flash_fwd(q, k, v, causal=causal, **args)
    torch.cuda.synchronize()
    assert tattn.launches == before + 1
    o_ref, lse_ref = tattn.attention_plain(q, k, v, causal=causal, return_lse=True, **args)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=1e-4)
    if kw.get("kv_lens") and 0 in kw["kv_lens"]:  # a fully-masked row: O = 0, LSE = -1e30
        row = kw["kv_lens"].index(0)
        assert not o[row].any() and bool((lse[row] == tattn.NEG_INF).all())


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_flash_kernel_repeats_bit_for_bit(cuda_device, D):
    """Three calls on the same inputs give the same O and LSE bits (the
    WM-prefill plan of 8 warps, and the 4-warp plan of the serving shape)."""
    for B, Sq, Sk, kw in ((2, 1088, 1152, {"heads": (16, 16), "kv_lens": [1088, 1000]}),
                          (1, 352, 352, {})):
        q, k, v, args = _flash_inputs(cuda_device, B, Sq, Sk, D, kw, seed=3)
        runs = [tattn.flash_fwd(q, k, v, causal=True, **args) for _ in range(3)]
        torch.cuda.synchronize()
        for o, lse in runs[1:]:
            assert torch.equal(o, runs[0][0]) and torch.equal(lse, runs[0][1])


@pytest.mark.cuda
def test_flash_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    q = torch.zeros(1, 8, 4, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tattn.flash_fwd(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="bfloat16 or float32 like q"):
        tattn.flash_fwd(q, q.float(), q.float())
    with pytest.raises(ValueError, match="head dim"):  # f32 takes D 32 and 64 only
        tattn.flash_fwd(q.float()[..., :16].contiguous(), q.float()[..., :16].contiguous(),
                        q.float()[..., :16].contiguous())
    with pytest.raises(ValueError, match="head dim"):
        tattn.flash_fwd(q[..., :32].contiguous(), q[..., :32].contiguous(),
                        q[..., :32].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        tattn.flash_fwd(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))


@pytest.mark.cuda
def test_decoder_kernel_path_matches_plain_path(cuda_device):
    cfg = TransformerConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                            num_layers=2, num_heads=4, num_kv_heads=2, qkv_bias=True,
                            tie_word_embeddings=True)  # bf16, head dim 64
    with torch.device(cuda_device):
        dec = init_random_(Decoder(cfg), seed=0)
    ids = torch.randint(0, 512, (2, 96), device=cuda_device,
                        generator=torch.Generator(device=cuda_device).manual_seed(1))
    kv_lens = torch.tensor([96, 70], device=cuda_device)
    before = tattn.launches
    with torch.no_grad():
        _, h_kernel = dec(ids, kv_lens=kv_lens, compute_logits=False)
        assert tattn.launches == before + cfg.num_layers
        dec.attn_impl = "plain"
        _, h_plain = dec(ids, kv_lens=kv_lens, compute_logits=False)
    assert tattn.launches == before + cfg.num_layers
    scale = h_plain.float().abs().max()
    assert ((h_kernel.float() - h_plain.float()).abs().max() / scale) < 2e-2


# ------------------------------------------------ split-cache decode (#4, #5)
from vla_rft_tpu_torch.ops import decode_attention_hd as tdec  # noqa: E402


def _decode_inputs(dev, gen, B, Sq, Hq, Hkv, S, int8, rows=None):
    """q (B, Sq, Hq, 64) bf16 and one layer's cache (rows, S, Hkv*64) with
    its (rows, Hkv, S) bf16 scales when int8."""
    rows = B if rows is None else rows
    q = torch.randn(B, Sq, Hq, 64, generator=gen, device=dev).bfloat16()
    if int8:
        c = [torch.randint(-127, 128, (rows, S, Hkv * 64), generator=gen, device=dev,
                           dtype=torch.int8) for _ in range(2)]
        s = [(torch.rand(rows, Hkv, S, generator=gen, device=dev) * 0.04 + 0.01).bfloat16()
             for _ in range(2)]
        return q, c, s
    c = [torch.randn(rows, S, Hkv * 64, generator=gen, device=dev).bfloat16() for _ in range(2)]
    return q, c, None


DEC_TOL = dict(atol=2e-3, rtol=2 ** -7)
DECODE_CASES = [
    # (int8, Sq, G, per-row prefix_map)
    (True, 1, 1, False), (True, 7, 1, True), (False, 1, 1, True), (False, 7, 1, False),
    (True, 7, 7, False), (False, 3, 2, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("int8,Sq,G,per_row", DECODE_CASES)
def test_decode_kernels_match_plain_twins(cuda_device, int8, Sq, G, per_row):
    dev, gen = cuda_device, torch.Generator(device=cuda_device).manual_seed(Sq + G)
    B, Hkv, Sr, Sp, shared_len = 6, 16 // G if G < 7 else 2, 200, 256, 250
    Hq = Hkv * G
    q, (ck, cv), sc = _decode_inputs(dev, gen, B, Sq, Hq, Hkv, Sr, int8)
    _, (sck, scv), ssc = _decode_inputs(dev, gen, 1, Sq, Hq, Hkv, Sp, int8, rows=2)
    pm = torch.tensor([1, 0, 0, 1, 1, 0] if per_row else [0, 0, 0, 1, 1, 1], device=dev)
    own = torch.tensor([Sq, 17, 200, 63, 120, 1 + Sq], device=dev)  # row 0: only its block
    kv_lens = shared_len + own
    kw = dict(shared_len=shared_len, kv_lens=kv_lens, q_offset=kv_lens - Sq,
              shared_starts=torch.tensor([0, 0, 9, 0, 3, 0], device=dev),
              scales=None if sc is None else tuple(sc),
              shared_scales=None if ssc is None else tuple(ssc))
    before = tdec.shared_launches
    o = tdec.decode_shared_kernel(q, ck, cv, sck, scv, pm, **kw)
    torch.cuda.synchronize()
    assert tdec.shared_launches == before + 1
    ref = tdec.decode_shared_plain(q, ck, cv, sck, scv, pm, **kw)
    torch.testing.assert_close(o.float(), ref.float(), **DEC_TOL)

    kv_lens = torch.tensor([Sq, 40, 200, 111, 7 + Sq, 150], device=dev)
    pkw = dict(kv_lens=kv_lens, q_offset=kv_lens - Sq,
               kv_starts=torch.tensor([0, 5, 0, 100, 0, 149], device=dev),
               scales=None if sc is None else tuple(sc))
    before = tdec.plain_launches
    o = tdec.decode_kernel(q, ck, cv, **pkw)
    torch.cuda.synchronize()
    assert tdec.plain_launches == before + 1
    torch.testing.assert_close(o.float(), tdec.decode_plain(q, ck, cv, **pkw).float(),
                               **DEC_TOL)


@pytest.mark.cuda
def test_decode_kernel_refuses_what_it_does_not_take(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, (ck, cv), sc = _decode_inputs(cuda_device, gen, 2, 1, 4, 4, 64, True)
    kw = dict(kv_lens=torch.tensor([5, 6], device=cuda_device), q_offset=torch.tensor([4, 5], device=cuda_device))
    with pytest.raises(ValueError, match="scales"):
        tdec.decode_kernel(q, ck, cv, **kw)
    with pytest.raises(ValueError, match="bf16"):
        tdec.decode_kernel(q.float(), ck, cv, scales=tuple(sc), **kw)
    with pytest.raises(ValueError, match="query positions"):
        tdec.decode_kernel(q.expand(2, 9, 4, 64).contiguous(), ck, cv, scales=tuple(sc), **kw)
    with pytest.raises(ValueError, match="CUDA"):
        tdec.decode_kernel(q.cpu(), ck.cpu(), cv.cpu(), scales=tuple(s.cpu() for s in sc), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["int8", "bf16"])
def test_cached_decoder_kernel_path_matches_plain_path(cuda_device, kv):
    """A 2-layer bf16 WM-shaped decoder (16 heads of 64): shared-prefix
    prefill, tail, decode steps and an action chunk through the kernels vs
    through the twins."""
    cfg = TransformerConfig(vocab_size=512, hidden_size=1024, intermediate_size=1024,
                            num_layers=2, num_heads=16, num_kv_heads=16, kv_cache_dtype=kv)
    with torch.device(cuda_device):
        dec = init_random_(Decoder(cfg), seed=0)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    head = torch.randint(0, 512, (2, 96), device=cuda_device, generator=gen)
    steps = [torch.randint(0, 512, (4, s), device=cuda_device, generator=gen) for s in (7, 1, 1, 7)]
    pm = torch.tensor([0, 0, 1, 1], device=cuda_device)
    logits = {}
    with torch.no_grad():
        for impl in ("auto", "plain"):
            dec.attn_impl = impl
            shared = dec.init_cache(2, 96)
            dec(head, cache=shared, cache_index=0, compute_logits=False)
            cache, ci, out = dec.init_cache(4, 64), 96, []
            for ids in steps:
                out.append(dec(ids, cache=cache, cache_index=ci, shared_cache=shared,
                               shared_len=96, prefix_map=pm)[0].float())
                ci += ids.shape[1]
            logits[impl] = torch.cat([o.flatten() for o in out])
    scale = logits["plain"].abs().max()
    assert ((logits["auto"] - logits["plain"]).abs().max() / scale) < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("shared,S", [(True, 12), (True, 40), (False, 12)])
def test_long_cached_chunks_launch_the_flash_kernel(cuda_device, shared, S):
    """A cached chunk longer than the decode kernels take goes through the
    flash kernel (#1) over the dequantised cache, never through a twin."""
    cfg = TransformerConfig(vocab_size=512, hidden_size=1024, intermediate_size=1024,
                            num_layers=2, num_heads=16, num_kv_heads=16, kv_cache_dtype="int8")
    with torch.device(cuda_device):
        dec = init_random_(Decoder(cfg), seed=0)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    head = torch.randint(0, 512, (2, 96), device=cuda_device, generator=gen)
    ids = torch.randint(0, 512, (4, S), device=cuda_device, generator=gen)
    pm = torch.tensor([0, 1, 1, 0], device=cuda_device)
    logits = {}
    with torch.no_grad():
        for impl in ("auto", "plain"):
            dec.attn_impl = impl
            if shared:
                sh = dec.init_cache(2, 96)
                dec(head, cache=sh, cache_index=0, compute_logits=False)
                kw = dict(shared_cache=sh, shared_len=96, prefix_map=pm)
                cache, ci = dec.init_cache(4, 64), 96
            else:
                kw = {}
                cache = dec.init_cache(4, 160)
                dec(head[pm], cache=cache, cache_index=0, compute_logits=False)
                ci = 96
            counts = (tattn.launches, tdec.shared_launches, tdec.plain_launches)
            logits[impl] = dec(ids, cache=cache, cache_index=ci, **kw)[0].float()
            torch.cuda.synchronize()
            delta = (tattn.launches - counts[0], tdec.shared_launches - counts[1],
                     tdec.plain_launches - counts[2])
            assert delta == ((cfg.num_layers if impl == "auto" else 0), 0, 0)
    dec.attn_impl = "auto"
    scale = logits["plain"].abs().max()
    assert ((logits["auto"] - logits["plain"]).abs().max() / scale) < 2e-2


# ------------------------------------------------ flash backward (#2, #3)
BWD_RTOL, BWD_ATOL = 2 ** -7, 1e-3

BWD_CASES = [
    # (name, B, Sq, Sk, Hq, Hkv, D, per-row kwargs): the CPU parity cases
    # (tests/test_torch_attention.py) at the kernels' head dims, D = 128,
    # and the WM-SFT row length (1663 = 1095 + 568, not a multiple of 64)
    ("kv_lens", 2, 96, 96, 4, 2, 64, {"kv_lens": [96, 70]}),
    ("kv_starts", 2, 64, 64, 4, 2, 64, {"kv_starts": [0, 16]}),
    ("q_offset", 2, 32, 64, 4, 2, 64, {"q_offset": [32, 32]}),
    ("gqa_7to1_ragged", 2, 50, 77, 14, 2, 64, {"kv_lens": [77, 41]}),
    ("fully_masked_row", 2, 40, 40, 4, 2, 64, {"kv_lens": [40, 10], "kv_starts": [0, 10]}),
    ("d128_ragged", 2, 130, 130, 14, 2, 128, {"kv_lens": [130, 77], "kv_starts": [0, 5]}),
    ("wm_1663", 1, 1663, 1663, 16, 16, 64, {}),
]


def _bwd_inputs(dev, B, Sq, Sk, Hq, Hkv, D, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, Sq, Hq, D, generator=gen, device=dev).bfloat16()
    k = torch.randn(B, Sk, Hkv, D, generator=gen, device=dev).bfloat16()
    v = torch.randn(B, Sk, Hkv, D, generator=gen, device=dev).bfloat16()
    do = torch.randn(B, Sq, Hq, D, generator=gen, device=dev).bfloat16()
    return q, k, v, do


def _assert_grads_close(got, ref):
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        err = (g.float() - r.float()).abs().max().item()
        lim = BWD_RTOL * r.float().abs().max().item() + BWD_ATOL
        assert err <= lim, f"{name}: max|d| {err} > {lim}"


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name,B,Sq,Sk,Hq,Hkv,D,kw", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_flash_bwd_kernels_match_plain_twin(cuda_device, name, B, Sq, Sk, Hq, Hkv, D, kw,
                                            causal):
    q, k, v, do = _bwd_inputs(cuda_device, B, Sq, Sk, Hq, Hkv, D)
    args = {k_: torch.tensor(v_, device=cuda_device) for k_, v_ in kw.items()}
    o, lse = tattn.flash_fwd(q, k, v, causal=causal, **args)
    before = (tattn.bwd_dq_launches, tattn.bwd_dkv_launches)
    got = tattn.flash_bwd(q, k, v, o, lse, do, causal=causal, **args)
    torch.cuda.synchronize()
    assert (tattn.bwd_dq_launches, tattn.bwd_dkv_launches) == (before[0] + 1, before[1] + 1)
    ref = tattn.attention_bwd_plain(q, k, v, o, lse, do, causal=causal, **args)
    _assert_grads_close(got, ref)
    if name == "fully_masked_row":  # row 1 has no valid key: all of its grads are 0
        assert all(bool((g[1] == 0).all()) for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name,B,Sq,Sk,Hq,Hkv,D,kw", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_flash_bwd_dkv_repeats_bit_for_bit_and_zeroes_masked_rows(cuda_device, name, B, Sq, Sk,
                                                                   Hq, Hkv, D, kw, causal):
    """#3 sums a key tile's (query head, query tile) pairs in a fixed order,
    its cluster's ranks in rank order: three calls give the same bits; a
    batch row without a valid key gets dK = dV = 0 exactly."""
    q, k, v, do = _bwd_inputs(cuda_device, B, Sq, Sk, Hq, Hkv, D, seed=3)
    args = {k_: torch.tensor(v_, device=cuda_device) for k_, v_ in kw.items()}
    o, lse = tattn.flash_fwd(q, k, v, causal=causal, **args)
    delta = (do.float() * o.float()).sum(dim=-1)
    runs = [tattn.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal, **args)
            for _ in range(3)]
    torch.cuda.synchronize()
    for a, b, c in zip(*runs):
        assert torch.equal(a, b) and torch.equal(a, c)
    if name == "fully_masked_row":  # row 1 has no valid key
        assert all(bool((g[1] == 0).all()) for g in runs[0])


@pytest.mark.cuda
def test_flash_bwd_wrapper_refuses_what_the_kernels_do_not_take(cuda_device):
    q, k, v, do = _bwd_inputs(cuda_device, 1, 8, 8, 4, 2, 64)
    o, lse = tattn.flash_fwd(q, k, v)
    with pytest.raises(ValueError, match="bfloat16"):
        tattn.flash_bwd(q, k, v, o, lse, do.float())
    with pytest.raises(ValueError, match="contiguous"):
        tattn.flash_bwd(q, k, v, o, lse, do.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="differs from q"):
        tattn.flash_bwd(q, k, v, o, lse, do[:, :4].contiguous())
    with pytest.raises(ValueError, match="lse"):
        tattn.flash_bwd_dq(q, k, v, do, lse.bfloat16(), lse)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tattn.flash_bwd(q.cpu(), k.cpu(), v.cpu(), o.cpu(), lse.cpu(), do.cpu())
    with pytest.raises(ValueError, match="head dim"):
        x = torch.zeros(1, 8, 4, 32, device=cuda_device, dtype=torch.bfloat16)
        tattn.flash_bwd_dkv(x, x, x, x, lse, lse)


@pytest.mark.cuda
def test_attention_grad_on_cuda_runs_the_kernels_and_matches_the_twin(cuda_device):
    """autograd through attention() on CUDA tensors: the forward launches #1,
    the backward #2 and #3, and dq/dk/dv are non-zero and match the plain
    path's (the forward kernel alone would leave them without a grad_fn)."""
    q, k, v, do = _bwd_inputs(cuda_device, 2, 96, 96, 14, 2, 64, seed=4)
    kv_lens = torch.tensor([96, 61], device=cuda_device)
    grads = {}
    for impl in ("auto", "plain"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        before = (tattn.launches, tattn.bwd_dq_launches, tattn.bwd_dkv_launches)
        o = tattn.attention(*leaves, causal=True, kv_lens=kv_lens, impl=impl)
        grads[impl] = torch.autograd.grad(o, leaves, do)
        torch.cuda.synchronize()
        after = (tattn.launches, tattn.bwd_dq_launches, tattn.bwd_dkv_launches)
        n = 1 if impl == "auto" else 0
        assert tuple(a - b for a, b in zip(after, before)) == (n, n, n)
    for g in grads["auto"]:
        assert bool(torch.isfinite(g.float()).all()) and g.float().abs().max().item() > 0
    _assert_grads_close(grads["auto"], grads["plain"])


@pytest.mark.cuda
def test_tiny_vla_adapter_step_launches_the_backward_once_per_layer(cuda_device):
    """One vla_adapter SFT step of the tiny policy in bf16 on the card (head
    dim 64, the kernels' smallest): the Qwen forward launches #1 and its
    backward #2 and #3 once per layer, and the loss is finite."""
    import dataclasses

    from vla_rft_tpu_torch.models.factory import policy_configs
    from vla_rft_tpu_torch.models.prismatic import OpenVLA
    from vla_rft_tpu_torch.models.action_head import ActionExpert
    from vla_rft_tpu_torch.trainer.sft_trainer import VLAAdapterSFTTrainer

    vla_cfg, expert_cfg, seq_len, image = policy_configs("tiny")
    llm = dataclasses.replace(vla_cfg.llm, hidden_size=256, num_heads=4, num_kv_heads=2,
                              dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    vla_cfg = dataclasses.replace(vla_cfg, llm=llm)
    expert_cfg = dataclasses.replace(expert_cfg, llm_dim=256)
    with torch.device(cuda_device):
        vla = init_random_(OpenVLA(vla_cfg), seed=0)
        expert = init_random_(ActionExpert(expert_cfg), seed=1)
    tr = VLAAdapterSFTTrainer(vla, expert)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    B, n = 2, vla_cfg.num_tokens
    ids = torch.randint(5, 1000, (B, seq_len), device=cuda_device, generator=gen)
    ids[:, 10:10 + n] = 151387 + torch.arange(n, device=cuda_device)
    labels = torch.full_like(ids, -100)
    labels[:, 10:10 + n] = ids[:, 10:10 + n]
    batch = {"input_ids": ids, "labels": labels, "attention_mask": torch.ones_like(ids),
             "pixels": torch.rand(B, image, image, 6, device=cuda_device, generator=gen),
             "proprio": torch.randn(B, 8, device=cuda_device, generator=gen),
             "actions": torch.rand(B, expert_cfg.num_actions_chunk, expert_cfg.action_dim,
                                   device=cuda_device, generator=gen) * 2 - 1}
    before = (tattn.launches, tattn.bwd_dq_launches, tattn.bwd_dkv_launches)
    loss = tr.training_step(gen, batch)
    after = (tattn.launches, tattn.bwd_dq_launches, tattn.bwd_dkv_launches)
    L = llm.num_layers
    assert tuple(a - b for a, b in zip(after, before)) == (L, L, L)
    assert torch.isfinite(torch.tensor(loss))


# ------------------------------------------------ fused decode layers #8, #9
# Kernel vs twin: both round every product and residual to bf16 in the
# reference's order; they differ only in the order of f32 sums, which can
# move one bf16 rounding.  bf16 outputs: |d| <= 2^-7 max|ref|; int8 k/v
# within one quantum where the two scales agree and two where they differ,
# on at most 1 % of entries (0.012-0.117 % measured at WM width on an
# H100); k/v scales at most SCALE_ULPS = 2 bf16 ulps from the twin's (an
# amax one ulp away moves bf16(amax / 127) by up to two: the proof is
# tests/test_torch_kernel_redesign_qkv_dkv.py::
# test_k_scale_moves_at_most_two_ulps_when_its_amax_moves_one), and at most
# 1 % of the scales may differ at all.
FUSED_RTOL = 2.0 ** -7
FUSED_INT8_SHARE = 0.01
SCALE_ULPS = 2


def _fused_inputs(dev, gen, B, Sq, H, I, Hq, Hkv, D=64):
    def w(k_in, k_out):
        return (torch.randint(-127, 128, (k_in, k_out), generator=gen, device=dev,
                              dtype=torch.int8),
                ((torch.rand(k_out, generator=gen, device=dev) + 0.5) * 0.02 / k_in ** 0.5)
                .bfloat16())

    from vla_rft_tpu_torch.ops import fused_decode_layer as fdl

    p = {"wq": w(H, Hq * D), "wk": w(H, Hkv * D), "wv": w(H, Hkv * D), "wo": w(Hq * D, H),
         "wg": w(H, I), "wu": w(H, I), "wd": w(I, H)}
    p["n1"], p["n2"] = ((1 + 0.1 * torch.randn(H, generator=gen, device=dev)).bfloat16()
                        for _ in range(2))
    x = torch.randn(B, Sq, H, generator=gen, device=dev).bfloat16()
    attn = torch.randn(B, Sq, Hq * D, generator=gen, device=dev).bfloat16()
    pos = torch.arange(Sq, device=dev)[None] + torch.randint(0, 1500, (B, 1), generator=gen,
                                                             device=dev)
    cos, sins = fdl.rope_tables(pos, 10000.0, Hq, D)
    return p, x, attn, cos, sins


def _scale_ulps(s, r):
    """bf16 ulps between positive scales: the distance of their bit patterns."""
    return (s.view(torch.int16).int() - r.view(torch.int16).int()).abs()


def _assert_qkv_close(got, ref):
    q, k8, v8, ks, vs = got
    rq, rk8, rv8, rks, rvs = ref
    assert (q.float() - rq.float()).abs().max() <= FUSED_RTOL * rq.float().abs().max()
    for s, r in ((ks, rks), (vs, rvs)):
        ulps = _scale_ulps(s, r)
        assert ulps.max().item() <= SCALE_ULPS
        assert (ulps > 0).float().mean().item() <= FUSED_INT8_SHARE
    for t, r, s, rs in ((k8, rk8, ks, rks), (v8, rv8, vs, rvs)):
        d = (t.int() - r.int()).abs()
        flip = (s != rs).transpose(1, 2).repeat_interleave(t.shape[-1] // s.shape[1], dim=-1)
        assert bool((d <= torch.where(flip, 2, 1)).all())
        assert (d > 0).float().mean().item() <= FUSED_INT8_SHARE


FUSED_CASES = [
    # (B, Sq, Hq, Hkv): N = B*Sq of 1, 10, 128 and ragged; one GQA case
    (1, 1, 16, 16), (10, 1, 16, 16), (128, 1, 16, 16), (3, 7, 16, 16), (19, 7, 16, 16),
    (10, 1, 16, 4), (5, 7, 16, 4),
    # #9's token tiles (8, 16, 32) and their edges, its split plans, and
    # N = 896 = 128 x 7 (28 token groups, one split)
    (16, 1, 16, 16), (17, 1, 16, 16), (64, 1, 16, 16), (65, 1, 16, 16), (128, 7, 16, 16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Hq,Hkv", FUSED_CASES)
def test_fused_decode_kernels_match_plain_twins(cuda_device, B, Sq, Hq, Hkv):
    from vla_rft_tpu_torch.ops import fused_decode_layer as fdl

    gen = torch.Generator(device=cuda_device).manual_seed(B * 10 + Sq + Hkv)
    H, I = 1024, 4096  # the WM's widths
    p, x, attn, cos, sins = _fused_inputs(cuda_device, gen, B, Sq, H, I, Hq, Hkv)
    args = (x, cos, sins, p["n1"], *p["wq"], *p["wk"], *p["wv"])
    kw = dict(num_heads=Hq, num_kv_heads=Hkv, head_dim=64, eps=1e-6)
    before = (fdl.qkv_launches, fdl.o_mlp_launches)
    got = fdl.fused_qkv_kernel(*args, **kw)
    o = fdl.fused_o_mlp_kernel(attn, x, *p["wo"], p["n2"], *p["wg"], *p["wu"], *p["wd"],
                               eps=1e-6)
    torch.cuda.synchronize()
    assert (fdl.qkv_launches - before[0], fdl.o_mlp_launches - before[1]) == (
        1, fdl.O_MLP_LAUNCHES)
    _assert_qkv_close(got, fdl.fused_rmsnorm_qkv_plain(*args, **kw))
    ref = fdl.fused_o_mlp_plain(attn, x, *p["wo"], p["n2"], *p["wg"], *p["wu"], *p["wd"],
                                eps=1e-6)
    assert o.dtype == torch.bfloat16 and o.shape == x.shape
    assert (o.float() - ref.float()).abs().max() <= FUSED_RTOL * ref.float().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("N", [10, 128])
def test_fused_o_mlp_kernel_repeats_bit_for_bit(cuda_device, N):
    """#9's split-K sums are reduced in a fixed order: three calls on the same
    inputs give the same bits."""
    from vla_rft_tpu_torch.ops import fused_decode_layer as fdl

    gen = torch.Generator(device=cuda_device).manual_seed(N)
    p, x, attn, _, _ = _fused_inputs(cuda_device, gen, N, 1, 1024, 4096, 16, 16)
    args = (attn, x, *p["wo"], p["n2"], *p["wg"], *p["wu"], *p["wd"])
    runs = [fdl.fused_o_mlp_kernel(*args, eps=1e-6) for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])


@pytest.mark.cuda
def test_fused_o_mlp_kernel_reads_a_layer_slice(cuda_device):
    """#9 on w[li] of stacked (L, in, out) weights, a view at a non-zero
    offset, gives the bits of the same layer's weights as their own tensors."""
    from vla_rft_tpu_torch.ops import fused_decode_layer as fdl

    gen = torch.Generator(device=cuda_device).manual_seed(21)
    p, x, attn, _, _ = _fused_inputs(cuda_device, gen, 10, 1, 1024, 4096, 16, 16)
    stacked = {k: torch.stack([torch.randint_like(p[k][0], -127, 128), p[k][0],
                               torch.randint_like(p[k][0], -127, 128)])
               for k in ("wo", "wg", "wu", "wd")}
    assert stacked["wd"][1].storage_offset() > 0
    own = fdl.fused_o_mlp_kernel(attn, x, *p["wo"], p["n2"], *p["wg"], *p["wu"], *p["wd"],
                                 eps=1e-6)
    sliced = fdl.fused_o_mlp_kernel(
        attn, x, stacked["wo"][1], p["wo"][1], p["n2"], stacked["wg"][1], p["wg"][1],
        stacked["wu"][1], p["wu"][1], stacked["wd"][1], p["wd"][1], eps=1e-6)
    torch.cuda.synchronize()
    assert torch.equal(own, sliced)
    ref = fdl.fused_o_mlp_plain(attn, x, *p["wo"], p["n2"], *p["wg"], *p["wu"], *p["wd"],
                                eps=1e-6)
    assert (sliced.float() - ref.float()).abs().max() <= FUSED_RTOL * ref.float().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("N", [10, 128, 896])
def test_fused_qkv_kernel_repeats_bit_for_bit(cuda_device, N):
    """#8's split-K sums are reduced in a fixed order: three calls on the same
    inputs give the same bits."""
    from vla_rft_tpu_torch.ops import fused_decode_layer as fdl

    gen = torch.Generator(device=cuda_device).manual_seed(N + 1)
    p, x, _, cos, sins = _fused_inputs(cuda_device, gen, N, 1, 1024, 4096, 16, 16)
    args = (x, cos, sins, p["n1"], *p["wq"], *p["wk"], *p["wv"])
    kw = dict(num_heads=16, num_kv_heads=16, head_dim=64, eps=1e-6)
    runs = [fdl.fused_qkv_kernel(*args, **kw) for _ in range(3)]
    torch.cuda.synchronize()
    for a, b, c in zip(*runs):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_fused_qkv_kernel_reads_a_layer_slice(cuda_device):
    """#8 on w[li] of stacked (L, in, out) weights, a view at a non-zero
    offset, gives the bits of the same layer's weights as their own tensors."""
    from vla_rft_tpu_torch.ops import fused_decode_layer as fdl

    gen = torch.Generator(device=cuda_device).manual_seed(22)
    p, x, _, cos, sins = _fused_inputs(cuda_device, gen, 10, 1, 1024, 4096, 16, 4)
    stacked = {k: torch.stack([torch.randint_like(p[k][0], -127, 128), p[k][0],
                               torch.randint_like(p[k][0], -127, 128)])
               for k in ("wq", "wk", "wv")}
    assert stacked["wv"][1].storage_offset() > 0
    kw = dict(num_heads=16, num_kv_heads=4, head_dim=64, eps=1e-6)
    own = fdl.fused_qkv_kernel(x, cos, sins, p["n1"], *p["wq"], *p["wk"], *p["wv"], **kw)
    sliced = fdl.fused_qkv_kernel(x, cos, sins, p["n1"], stacked["wq"][1], p["wq"][1],
                                  stacked["wk"][1], p["wk"][1], stacked["wv"][1], p["wv"][1],
                                  **kw)
    torch.cuda.synchronize()
    for a, b in zip(own, sliced):
        assert torch.equal(a, b)
    _assert_qkv_close(sliced, fdl.fused_rmsnorm_qkv_plain(x, cos, sins, p["n1"], *p["wq"],
                                                          *p["wk"], *p["wv"], **kw))


@pytest.mark.cuda
def test_fused_qkv_kernel_writes_cache_views(cuda_device):
    from vla_rft_tpu_torch.ops import fused_decode_layer as fdl

    gen = torch.Generator(device=cuda_device).manual_seed(7)
    B, Sq, H, Hq, Hkv, S, w0 = 4, 7, 1024, 16, 16, 384, 100
    p, x, _, cos, sins = _fused_inputs(cuda_device, gen, B, Sq, H, 4096, Hq, Hkv)
    ck = torch.zeros(3, B, S, Hkv * 64, dtype=torch.int8, device=cuda_device)
    cv = torch.zeros_like(ck)
    sk = torch.ones(3, B, Hkv, S, dtype=torch.bfloat16, device=cuda_device)
    sv = torch.ones_like(sk)
    args = (x, cos, sins, p["n1"], *p["wq"], *p["wk"], *p["wv"])
    kw = dict(num_heads=Hq, num_kv_heads=Hkv, head_dim=64, eps=1e-6)
    _, k8, v8, ks, vs = fdl.fused_qkv_kernel(*args, **kw)
    out = (ck[1, :, w0:w0 + Sq], cv[1, :, w0:w0 + Sq], sk[1, :, :, w0:w0 + Sq],
           sv[1, :, :, w0:w0 + Sq])
    fdl.fused_qkv_kernel(*args, **kw, out=out)
    torch.cuda.synchronize()
    for view, t in zip(out, (k8, v8, ks, vs)):
        assert torch.equal(view, t)
    assert not ck[0].any() and not ck[2].any() and not ck[1, :, :w0].any()
    assert bool((sk[1, :, :, w0 + Sq:] == 1).all())


@pytest.mark.cuda
def test_fused_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    from vla_rft_tpu_torch.ops import fused_decode_layer as fdl

    gen = torch.Generator(device=cuda_device).manual_seed(8)
    p, x, attn, cos, sins = _fused_inputs(cuda_device, gen, 2, 1, 128, 256, 2, 2)
    kw = dict(num_heads=2, num_kv_heads=2, head_dim=64, eps=1e-6)
    w = (p["n1"], *p["wq"], *p["wk"], *p["wv"])
    with pytest.raises(ValueError, match="bf16"):
        fdl.fused_qkv_kernel(x.float(), cos, sins, *w, **kw)
    with pytest.raises(ValueError, match="head dim"):
        fdl.fused_qkv_kernel(x, cos, sins, *w, **dict(kw, head_dim=32))
    with pytest.raises(ValueError, match="contiguous"):
        fdl.fused_qkv_kernel(x, cos, sins, p["n1"], p["wq"][0].t().contiguous().t(),
                             p["wq"][1], *p["wk"], *p["wv"], **kw)
    with pytest.raises(ValueError, match="multiple of 64"):
        fdl.fused_qkv_kernel(x[..., :96].contiguous(), cos, sins, *w, **kw)
    with pytest.raises(ValueError, match="strides"):
        k_bad = torch.zeros(2, 128, 1, dtype=torch.int8, device=cuda_device).transpose(1, 2)
        s_ok = torch.zeros(2, 2, 1, dtype=torch.bfloat16, device=cuda_device)
        fdl.fused_qkv_kernel(x, cos, sins, *w, **kw, out=(k_bad, k_bad, s_ok, s_ok))
    with pytest.raises(ValueError, match="chain"):  # a down projection 64 wide, not H
        fdl.fused_o_mlp_kernel(attn, x, *p["wo"], p["n2"], *p["wg"], *p["wu"],
                               p["wd"][0][:, :64].contiguous(), p["wd"][1][:64].contiguous(),
                               eps=1e-6)
    with pytest.raises(ValueError, match="device"):
        fdl.fused_o_mlp_kernel(attn.cpu(), x, *p["wo"], p["n2"], *p["wg"], *p["wu"],
                               *p["wd"], eps=1e-6)


def _int8_wm(dev, layers=2):
    """A bf16 WM of the kernels' head dim with int8 weights and KV cache:
    its bf16 parent's state quantised by the port."""
    from vla_rft_tpu_torch.models.transformer import quantize_decoder_params

    cfg = TransformerConfig(vocab_size=512, hidden_size=128, intermediate_size=256,
                            num_layers=layers, num_heads=2, num_kv_heads=2,
                            kv_cache_dtype="int8")
    with torch.device(dev):
        parent = init_random_(Decoder(cfg), seed=3)
        q = Decoder(dataclasses.replace(cfg, weights_int8=True))
    q.load_state_dict(quantize_decoder_params(parent.state_dict(), q.cfg), strict=True)
    return q.eval()


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [False, True])
def test_fused_decode_step_matches_the_unfused_int8_route(cuda_device, shared):
    """decode_step_fused (kernels #8, #4 / #5, #9) against Decoder.forward on
    the same int8 model and cache (QuantLinear products, the same decode
    attention kernel): logits within 5e-2 of max|logits| after 2 bf16
    layers whose caches are written from each route's own hidden states."""
    from vla_rft_tpu_torch.models.transformer import decode_step_fused
    from vla_rft_tpu_torch.ops import fused_decode_layer as fdl

    wm = _int8_wm(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    B, P0, P = 4, 40, 47
    prompt = torch.randint(0, 512, (B, P), generator=gen, device=cuda_device)
    kw = {}
    with torch.no_grad():
        if shared:
            sh = wm.init_cache(2, P0)
            wm(prompt[::2, :P0], cache=sh, cache_index=0, compute_logits=False)
            kw = dict(shared_cache=sh, shared_len=P0,
                      prefix_map=torch.tensor([0, 0, 1, 1], device=cuda_device))
            caches = [wm.init_cache(B, 64) for _ in range(2)]
            for c in caches:
                wm(prompt[:, P0:], cache=c, cache_index=P0, kv_lens=P, **kw)
        else:
            caches = [wm.init_cache(B, P + 64) for _ in range(2)]
            for c in caches:
                wm(prompt, cache=c, cache_index=0)
        toks = [torch.randint(0, 512, (B, s), generator=gen, device=cuda_device)
                for s in (1, 1, 7, 1)]
        ci = P
        for t in toks:
            before = (fdl.qkv_launches, fdl.o_mlp_launches)
            fused, _ = decode_step_fused(wm, t, caches[0], ci, **kw)
            assert (fdl.qkv_launches - before[0], fdl.o_mlp_launches - before[1]) == (
                2, 2 * fdl.O_MLP_LAUNCHES)
            plain, _ = wm(t, cache=caches[1], cache_index=ci, **kw)
            err = ((fused - plain).abs().max() / plain.abs().max()).item()
            assert err <= 5e-2 and bool(torch.isfinite(fused).all()), err
            ci += t.shape[1]


@pytest.mark.cuda
def test_tiny_grpo_step_launches_the_fused_kernels(cuda_device, tmp_path):
    """One training_step of the tiny preset on the card with weights_int8,
    the Qwen and the WM swapped for bf16 ones of head dim 64 (the kernels'
    shapes; the WM with an int8 KV cache): every one of the WM call's
    Fn * (V + 1) decode calls launches #8 once and #9 three times per layer;
    the metrics are finite."""
    from vla_rft_tpu_torch.models.action_head import ActionExpert
    from vla_rft_tpu_torch.models.prismatic import OpenVLA
    from vla_rft_tpu_torch.config import vla_rft_default_config
    from vla_rft_tpu_torch.ops import fused_decode_layer as fdl
    from vla_rft_tpu_torch.trainer.grpo_trainer import VLARFTGRPOTrainer

    cfg = vla_rft_default_config().apply_overrides([
        "data.train_batch_size=2", "data.video.segment_length=3", "actor_rollout_ref.rollout.n=2",
        "actor_rollout_ref.actor.ppo_mini_batch_size=4",
        "actor_rollout_ref.actor.ppo_micro_batch_size_per_gpu=2",
        "processor.tokens_per_frame=4", "data.max_prompt_length=75",
        "data.max_response_length=22", "world_model_rollout.rollout.interact_max_tokens=4",
        "world_model_rollout.rollout.weights_int8=true", f"trainer.default_local_dir={tmp_path}",
        "world_model_rollout.world_model.vocab_size=9008"])
    tr = VLARFTGRPOTrainer(cfg, preset="tiny", device="cuda")
    b = tr.bundle
    llm = dataclasses.replace(b.vla_cfg.llm, hidden_size=256, num_heads=4, num_kv_heads=2,
                              dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    b.vla_cfg = dataclasses.replace(b.vla_cfg, llm=llm)
    b.expert_cfg = dataclasses.replace(b.expert_cfg, llm_dim=256)
    parent_cfg = dataclasses.replace(_int8_wm(cuda_device).cfg, vocab_size=9008,
                                     weights_int8=False)
    with torch.device(cuda_device):
        b.vla = init_random_(OpenVLA(b.vla_cfg), seed=0).eval().requires_grad_(False)
        b.expert = init_random_(ActionExpert(b.expert_cfg), seed=1)
        b.wm = init_random_(Decoder(parent_cfg), seed=5).eval().requires_grad_(False)
    b.wm_cfg = parent_cfg
    tr._init_state(None)  # the optimizer over the new expert
    before = (fdl.qkv_launches, fdl.o_mlp_launches)
    metrics = tr.training_step(tr.dataset.next_batch(), step=1)
    roll = tr.bundle.roll_cfg
    calls = roll.num_frames * (roll.interact_max_tokens + 1)
    L = parent_cfg.num_layers
    assert (fdl.qkv_launches - before[0], fdl.o_mlp_launches - before[1]) == (
        L * calls, fdl.O_MLP_LAUNCHES * L * calls)
    assert all(np.isfinite(v) for v in metrics.values())


# ------------------------------------ 'heads' decode (#6, #7) and #10
from vla_rft_tpu_torch.ops import decode_attention as theads  # noqa: E402
from vla_rft_tpu_torch.ops import fused_decode_attention as tfda  # noqa: E402


def _to_heads(c, Hkv):
    """An 'hd' layer slice (rows, S, Hkv*64) as the 'heads' one (rows, Hkv, S, 64)."""
    return c.view(c.shape[0], c.shape[1], Hkv, 64).transpose(1, 2).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("int8,Sq,G,per_row", DECODE_CASES)
def test_heads_decode_kernels_match_plain_twins(cuda_device, int8, Sq, G, per_row):
    """#6 / #7 against their twins, and equal bit for bit to #4 / #5 on the
    same numbers in the 'hd' layout (the one kernel over other strides)."""
    dev, gen = cuda_device, torch.Generator(device=cuda_device).manual_seed(Sq + G + 50)
    B, Hkv, Sr, Sp, shared_len = 6, 16 // G if G < 7 else 2, 200, 256, 250
    Hq = Hkv * G
    q, (ck, cv), sc = _decode_inputs(dev, gen, B, Sq, Hq, Hkv, Sr, int8)
    _, (sck, scv), ssc = _decode_inputs(dev, gen, 1, Sq, Hq, Hkv, Sp, int8, rows=2)
    hk, hv, hsk, hsv = (_to_heads(c, Hkv) for c in (ck, cv, sck, scv))
    pm = torch.tensor([1, 0, 0, 1, 1, 0] if per_row else [0, 0, 0, 1, 1, 1], device=dev)
    own = torch.tensor([Sq, 17, 200, 63, 120, 1 + Sq], device=dev)
    kv_lens = shared_len + own
    kw = dict(shared_len=shared_len, kv_lens=kv_lens, q_offset=kv_lens - Sq,
              shared_starts=torch.tensor([0, 0, 9, 0, 3, 0], device=dev),
              scales=None if sc is None else tuple(sc),
              shared_scales=None if ssc is None else tuple(ssc))
    before = (theads.shared_heads_launches, tdec.shared_launches)
    o = theads.decode_shared_kernel(q, hk, hv, hsk, hsv, pm, **kw)
    o_hd = tdec.decode_shared_kernel(q, ck, cv, sck, scv, pm, **kw)
    torch.cuda.synchronize()
    assert (theads.shared_heads_launches, tdec.shared_launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(o.float(), theads.decode_shared_plain(
        q, hk, hv, hsk, hsv, pm, **kw).float(), **DEC_TOL)
    assert torch.equal(o, o_hd)

    kv_lens = torch.tensor([Sq, 40, 200, 111, 7 + Sq, 150], device=dev)
    pkw = dict(kv_lens=kv_lens, q_offset=kv_lens - Sq,
               kv_starts=torch.tensor([0, 5, 0, 100, 0, 149], device=dev),
               scales=None if sc is None else tuple(sc))
    before = theads.heads_launches
    o = theads.decode_kernel(q, hk, hv, **pkw)
    torch.cuda.synchronize()
    assert theads.heads_launches == before + 1
    torch.testing.assert_close(o.float(), theads.decode_plain(q, hk, hv, **pkw).float(),
                               **DEC_TOL)
    assert torch.equal(o, tdec.decode_kernel(q, ck, cv, **pkw))


@pytest.mark.cuda
def test_heads_decode_kernel_refuses_the_other_layout(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q, (ck, cv), sc = _decode_inputs(cuda_device, gen, 2, 1, 4, 4, 64, True)
    kw = dict(kv_lens=torch.tensor([5, 6], device=cuda_device),
              q_offset=torch.tensor([4, 5], device=cuda_device), scales=tuple(sc))
    with pytest.raises(ValueError, match=r"\(rows, Hkv, S, D\)"):
        theads.decode_kernel(q, ck, cv, **kw)
    with pytest.raises(ValueError, match=r"\(rows, S, Hkv\*D\)"):
        tdec.decode_kernel(q, _to_heads(ck, 4), _to_heads(cv, 4), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("weights_int8", [False, True])
def test_heads_decoder_launches_the_heads_kernels_and_never_a_twin(cuda_device, monkeypatch,
                                                                   weights_int8):
    """A 2-layer WM-width decoder with an int8 'heads' cache on the card: a
    shared-prefix rollout launches #6 once per layer per call (prefix
    prefill: #1), a prefix-free one #7; neither twin runs, no 'hd' kernel
    and, with int8 weights, no fused layer kernel (the unfused int8 route,
    as in the reference)."""
    from vla_rft_tpu_torch.models.transformer import quantize_decoder_params
    from vla_rft_tpu_torch.ops import fused_decode_layer as fdl
    from vla_rft_tpu_torch.workers.wm_rollout import WMRolloutConfig, generate_sequences

    cfg = TransformerConfig(vocab_size=512, hidden_size=1024, intermediate_size=1024,
                            num_layers=2, num_heads=16, num_kv_heads=16, kv_cache_dtype="int8",
                            kv_layout="heads")
    with torch.device(cuda_device):
        wm = init_random_(Decoder(cfg), seed=0)
        if weights_int8:
            q = Decoder(dataclasses.replace(cfg, weights_int8=True))
            q.load_state_dict(quantize_decoder_params(wm.state_dict(), q.cfg), strict=True)
            wm = q
    for name in ("decode_shared_plain", "decode_plain"):
        monkeypatch.setattr(theads, name, lambda *a, **k: pytest.fail("twin on the card"))
    F, V, A = 2, 4, 7
    roll = WMRolloutConfig(prompt_length=96 + A, response_length=F * (V + A), num_frames=F,
                           interact_max_tokens=V, action_dim=A, do_sample=False,
                           cache_segments=2)
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    tail = torch.randint(0, 512, (4, A), generator=gen, device=cuda_device)
    actions = torch.randint(0, 512, (4, F + 1, A), generator=gen, device=cuda_device)
    head = torch.randint(0, 512, (2, 96), generator=gen, device=cuda_device)
    counts = lambda: (tattn.launches, theads.shared_heads_launches, theads.heads_launches,
                      tdec.shared_launches, tdec.plain_launches, fdl.qkv_launches)
    L, calls = cfg.num_layers, F * (V + 1)
    with torch.no_grad():
        c0 = counts()
        out = generate_sequences(wm, torch.Generator(device=cuda_device), tail, actions, roll,
                                 shared_prefix=head, prefix_map=torch.tensor([0, 0, 1, 1]))
        torch.cuda.synchronize()
        assert tuple(b - a for a, b in zip(c0, counts())) == (L, L * (calls + 1), 0, 0, 0, 0)
        c0 = counts()
        out2 = generate_sequences(wm, torch.Generator(device=cuda_device),
                                  torch.cat([head[[0, 0, 1, 1]], tail], 1), actions, roll)
        torch.cuda.synchronize()
        assert tuple(b - a for a, b in zip(c0, counts())) == (L, 0, L * calls, 0, 0, 0)
    assert out.shape == out2.shape == (4, F * (V + A))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("idx,starts,D,G", [(0, [0, 0], 64, 1), (1, [0, 1], 64, 1),
                                            (700, [0, 13], 64, 7), (1663, [5, 1663], 64, 1),
                                            (37, [0, 5], 32, 2), (300, [2, 0], 128, 2)])
def test_fused_decode_attention_kernel_matches_the_twin(cuda_device, dtype, idx, starts, D, G):
    """#10 against its twin: the written rows bit-equal, the output within
    one bf16 ulp (2^-7 relative) + 2e-3 (f32: 1e-5 relative + 1e-5, the
    same f32 arithmetic in another order); then #7 over the cache #10 wrote
    (kv_lens = idx + 1, for a cache it takes: bf16, D = 64) agrees within
    the decode tolerance."""
    gen = torch.Generator(device=cuda_device).manual_seed(idx + D)
    L, B, Hkv, S, li = 2, 2, 2, 1664, 1
    Hq = Hkv * G
    rnd = lambda *s: torch.randn(*s, generator=gen, device=cuda_device).to(dtype)
    ck, cv = rnd(L, B, Hkv, S, D), rnd(L, B, Hkv, S, D)
    q, kn, vn = rnd(B, 1, Hq, D), rnd(B, 1, Hkv, D), rnd(B, 1, Hkv, D)
    ks = torch.tensor(starts, device=cuda_device)
    rck, rcv = ck.clone(), cv.clone()
    before = tfda.launches
    o, _, _ = tfda.fused_decode_attention_kernel(q, kn, vn, ck, cv, li, idx, ks)
    torch.cuda.synchronize()
    assert tfda.launches == before + 1
    ref, _, _ = tfda.fused_decode_attention_plain(q, kn, vn, rck, rcv, li, idx, ks)
    assert torch.equal(ck, rck) and torch.equal(cv, rcv)
    tol = dict(atol=2e-3, rtol=2 ** -7) if dtype == torch.bfloat16 else dict(atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(o.float(), ref.float(), **tol)
    if dtype == torch.bfloat16 and D == 64 and G == 1:
        o7 = theads.decode_kernel(q, ck[li], cv[li], kv_lens=torch.full_like(ks, idx + 1),
                                  q_offset=torch.full_like(ks, idx), kv_starts=torch.clamp(ks, max=idx))
        torch.testing.assert_close(o7.float(), o.float(), **DEC_TOL)


@pytest.mark.cuda
def test_fused_decode_attention_refuses_what_the_kernel_does_not_take(cuda_device):
    z = lambda *s, dt=torch.bfloat16: torch.zeros(*s, dtype=dt, device=cuda_device)
    q, kv, ck = z(2, 1, 4, 64), z(2, 1, 2, 64), z(1, 2, 2, 16, 64)
    with pytest.raises(ValueError, match="head dim"):
        tfda.fused_decode_attention_kernel(z(2, 1, 4, 48), z(2, 1, 2, 48), z(2, 1, 2, 48),
                                           z(1, 2, 2, 16, 48), z(1, 2, 2, 16, 48), 0, 3)
    with pytest.raises(ValueError, match="outside"):
        tfda.fused_decode_attention_kernel(q, kv, kv, ck, ck.clone(), 0, 16)
    with pytest.raises(ValueError, match="contiguous"):
        tfda.fused_decode_attention_kernel(q, kv, kv, ck.transpose(3, 4), ck.clone(), 0, 3)
    with pytest.raises(ValueError, match="kv heads"):
        tfda.fused_decode_attention_kernel(z(2, 1, 40, 64), kv, kv, ck, ck.clone(), 0, 3)


# ------------------------------------------------------------ the redesigned #10
FDA_REDESIGN_CASES = [
    # (name, cache dtype, q dtype, B, G, Hkv, D, idx, kv_starts, splits or
    # None for the plan): ranks with empty ranges (8 ranks at rows 1, 100
    # and 129, starts at or past the row), the mixed pairings, D 32 and 128
    # with 16 query heads a kv head, the configured 128 rows of a WM call
    ("r8_idx1", "bfloat16", "bfloat16", 4, 1, 16, 64, 1, [0, 1, 2, 0], 8),
    ("r8_idx100", "bfloat16", "bfloat16", 4, 1, 16, 64, 100, [0, 99, 100, 150], 8),
    ("r8_idx129", "bfloat16", "bfloat16", 4, 2, 8, 64, 129, [0, 128, 129, 64], 8),
    ("r8_idx129_f32_d128", "float32", "float32", 3, 2, 2, 128, 129, [0, 129, 100], 8),
    ("bf16_cache_f32_q", "bfloat16", "float32", 3, 7, 2, 64, 1379, [0, 13, 1379], None),
    ("f32_cache_bf16_q", "float32", "bfloat16", 3, 7, 2, 64, 1379, [0, 13, 1379], None),
    ("d32_g16", "bfloat16", "bfloat16", 3, 16, 2, 32, 900, [0, 5, 899], None),
    ("d128_g16", "bfloat16", "bfloat16", 3, 16, 2, 128, 900, [0, 5, 899], None),
    ("d128_g16_f32", "float32", "float32", 3, 16, 2, 128, 900, [0, 5, 899], 3),
    ("d32_g16_f32_q", "bfloat16", "float32", 3, 16, 2, 32, 900, [0, 5, 899], 5),
    ("b128", "bfloat16", "bfloat16", 128, 1, 16, 64, 1379, [(37 * i) % 1500 for i in range(128)],
     None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,cdt,qdt,B,G,Hkv,D,idx,starts,splits", FDA_REDESIGN_CASES,
                         ids=[c[0] for c in FDA_REDESIGN_CASES])
def test_fused_decode_attention_redesign_matches_twin_and_repeats(cuda_device, name, cdt, qdt, B,
                                                                   G, Hkv, D, idx, starts,
                                                                   splits):
    """#10 split over a cluster: the written rows bit-equal to the twin's,
    three calls with the same inputs give the same bits (ranks merged in
    rank order, no atomics), the output within the decode tolerance when
    the cache or q is bf16 and 1e-5 when both are f32; a (row, head) whose
    window is empty gives the current token's v; #7 over the cache #10
    wrote agrees where it takes the cache (bf16, D 64, G 1)."""
    gen = torch.Generator(device=cuda_device).manual_seed(B + G + D + idx)
    L, S, li = 2, 1664, 1
    cdt, qdt = getattr(torch, cdt), getattr(torch, qdt)
    rnd = lambda dt, *s: torch.randn(*s, generator=gen, device=cuda_device).to(dt)
    ck, cv = rnd(cdt, L, B, Hkv, S, D), rnd(cdt, L, B, Hkv, S, D)
    q, kn, vn = rnd(qdt, B, 1, Hkv * G, D), rnd(cdt, B, 1, Hkv, D), rnd(cdt, B, 1, Hkv, D)
    ks = torch.tensor(starts, device=cuda_device)
    rck, rcv = ck.clone(), cv.clone()
    before = tfda.launches
    runs = [tfda.fused_decode_attention_kernel(q, kn, vn, ck, cv, li, idx, ks, splits=splits)[0]
            for _ in range(3)]
    torch.cuda.synchronize()
    assert tfda.launches == before + 3
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
    ref, _, _ = tfda.fused_decode_attention_plain(q, kn, vn, rck, rcv, li, idx, ks)
    assert torch.equal(ck, rck) and torch.equal(cv, rcv)
    both_f32 = cdt == torch.float32 and qdt == torch.float32
    tol = dict(atol=1e-5, rtol=1e-5) if both_f32 else DEC_TOL
    torch.testing.assert_close(runs[0].float(), ref.float(), **tol)
    for b in range(B):
        if starts[b] >= idx:  # only the current token: its v, per query head
            torch.testing.assert_close(runs[0][b, 0].float(),
                                       vn[b, 0].float().repeat_interleave(G, dim=0), **tol)
    if cdt == qdt == torch.bfloat16 and D == 64 and G == 1:
        o7 = theads.decode_kernel(q, ck[li], cv[li], kv_lens=torch.full_like(ks, idx + 1),
                                  q_offset=torch.full_like(ks, idx),
                                  kv_starts=torch.clamp(ks, max=idx))
        torch.testing.assert_close(o7.float(), runs[0].float(), **DEC_TOL)


@pytest.mark.cuda
def test_fused_decode_attention_refuses_a_split_count_outside_the_cluster(cuda_device):
    z = lambda *s: torch.zeros(*s, dtype=torch.bfloat16, device=cuda_device)
    q, kv, ck = z(2, 1, 4, 64), z(2, 1, 2, 64), z(1, 2, 2, 16, 64)
    before = tfda.launches
    for bad in (0, tfda.MAX_SPLITS + 1):
        with pytest.raises(ValueError, match="splits"):
            tfda.fused_decode_attention_kernel(q, kv, kv, ck, ck.clone(), 0, 3, splits=bad)
    assert tfda.launches == before


# ------------------------------- the redesigned #2 and decode kernel (#4-#7)
@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name,B,Sq,Sk,Hq,Hkv,D,kw", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_flash_bwd_dq_repeats_bit_for_bit_and_zeroes_masked_rows(cuda_device, name, B, Sq, Sk,
                                                                  Hq, Hkv, D, kw, causal):
    """#2 has no split and no atomics: three calls give the same bits; a
    batch row without a valid key gets dQ = 0 exactly."""
    q, k, v, do = _bwd_inputs(cuda_device, B, Sq, Sk, Hq, Hkv, D, seed=5)
    args = {k_: torch.tensor(v_, device=cuda_device) for k_, v_ in kw.items()}
    o, lse = tattn.flash_fwd(q, k, v, causal=causal, **args)
    delta = (do.float() * o.float()).sum(dim=-1)
    runs = [tattn.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal, **args) for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
    if name == "fully_masked_row":  # row 1 has no valid key
        assert bool((runs[0][1] == 0).all())


def _decode_call(dev, gen, layout, B, Sq, G, Hkv, Sr, n_prefix, pm, int8, shared_len=250, Sp=256):
    """(kernel call, twin call) of one decode case on the 'hd' or 'heads'
    layout: ragged own lengths, cut starts, one row without a valid key."""
    mod = theads if layout == "heads" else tdec
    conv = (lambda c: _to_heads(c, Hkv)) if layout == "heads" else (lambda c: c)
    q, (ck, cv), sc = _decode_inputs(dev, gen, B, Sq, Hkv * G, Hkv, Sr, int8)
    ck, cv = conv(ck), conv(cv)
    own = torch.tensor([Sq + (37 * b) % (Sr - Sq + 1) for b in range(B)], device=dev)
    starts = torch.tensor([(7 * b) % 11 for b in range(B)], device=dev)
    scales = None if sc is None else tuple(sc)
    if pm is None:
        starts[1] = own[1]  # no valid key
        kw = dict(kv_lens=own, q_offset=own - Sq, kv_starts=starts, scales=scales)
        return (lambda: mod.decode_kernel(q, ck, cv, **kw),
                lambda: mod.decode_plain(q, ck, cv, **kw))
    _, (sck, scv), ssc = _decode_inputs(dev, gen, 1, Sq, Hkv * G, Hkv, Sp, int8, rows=n_prefix)
    sck, scv = conv(sck), conv(scv)
    pm = torch.tensor(pm, device=dev)
    kv_lens = shared_len + own
    starts[1] = kv_lens[1]  # no valid key
    kw = dict(shared_len=shared_len, kv_lens=kv_lens, q_offset=kv_lens - Sq, shared_starts=starts,
              scales=scales, shared_scales=None if ssc is None else tuple(ssc))
    return (lambda: mod.decode_shared_kernel(q, ck, cv, sck, scv, pm, **kw),
            lambda: mod.decode_shared_plain(q, ck, cv, sck, scv, pm, **kw))


REDESIGN_DECODE_CASES = [
    # (name, B, Sq, G, Hkv, Sr, n_prefix, prefix_map or None, int8): the
    # configured 128-row WM call (a 64-sequence step's policy rows, then its
    # gt rows), prefix groups of more than MAX_NQ (64) query rows (80 rows of
    # one query; 12 rows of 7), the main path's 10 rows, and #5 / #7
    ("b128_int8", 128, 1, 1, 16, 200, 16, [i // 4 % 16 for i in range(128)], True),
    ("b128_bf16", 128, 1, 1, 8, 200, 16, [i // 4 % 16 for i in range(128)], False),
    ("group_of_80", 80, 1, 1, 4, 120, 2, [0] * 79 + [1], True),
    ("group_of_12_sq7", 12, 7, 1, 4, 120, 1, [0] * 12, True),
    ("g4_sq5", 6, 5, 4, 2, 120, 2, [0, 0, 0, 1, 1, 1], False),  # 3 rows of 20 in 4 m16 tiles
    ("b10", 10, 1, 1, 16, 200, 2, [0] * 5 + [1] * 5, True),
    ("plain_b10", 10, 1, 1, 16, 300, 0, None, True),
    ("plain_gqa_sq7", 4, 7, 7, 2, 120, 0, None, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["hd", "heads"])
@pytest.mark.parametrize("name,B,Sq,G,Hkv,Sr,n_prefix,pm,int8", REDESIGN_DECODE_CASES,
                         ids=[c[0] for c in REDESIGN_DECODE_CASES])
def test_decode_kernel_matches_twin_and_repeats_bit_for_bit(cuda_device, layout, name, B, Sq, G,
                                                            Hkv, Sr, n_prefix, pm, int8):
    """The split-cache decode kernel (prefix read once per chunk of a prefix
    group, keys split over a cluster merged in rank order) against its twin
    within the decode tolerance, three calls with the same bits, and 0 for
    the row without a valid key."""
    gen = torch.Generator(device=cuda_device).manual_seed(B + Sq + G)
    kern, twin = _decode_call(cuda_device, gen, layout, B, Sq, G, Hkv, Sr, n_prefix, pm, int8)
    runs = [kern() for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
    ref = twin()
    torch.testing.assert_close(runs[0].float(), ref.float(), **DEC_TOL)
    assert bool((runs[0][1] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["hd", "heads"])
@pytest.mark.parametrize("Sq", [3, 5])
def test_per_row_verify_call_kernels_match_the_plain_route(cuda_device, layout, Sq):
    """One call of Sq tokens whose 8 rows stand at 8 different cache offsets
    over a shared prefix (the speculative rollout's verify call), through
    #4 ('hd') or #6 ('heads') vs through the twins, on a 2-layer WM-width
    decoder with an int8 cache: logits within 2e-2 of max|logits|, as the
    other cached-decoder test; layer 0's cache bit-equal (both routes
    quantise the same k / v, computed from the embeddings, in the same
    torch code); in both layers only the call's positions written; the
    kernel launched once per layer, the twin never on the kernel route."""
    cfg = TransformerConfig(vocab_size=512, hidden_size=1024, intermediate_size=1024,
                            num_layers=2, num_heads=16, num_kv_heads=16, kv_cache_dtype="int8",
                            kv_layout=layout)
    with torch.device(cuda_device):
        dec = init_random_(Decoder(cfg), seed=3)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    B, P0, T, warm = 8, 96, 7, 10
    head = torch.randint(0, 512, (2, P0), generator=gen, device=cuda_device)
    tail = torch.randint(0, 512, (B, T), generator=gen, device=cuda_device)
    steps = torch.randint(0, 512, (B, warm), generator=gen, device=cuda_device)
    chunk = torch.randint(0, 512, (B, Sq), generator=gen, device=cuda_device)
    pm = torch.tensor([0] * 4 + [1] * 4, dtype=torch.int32, device=cuda_device)
    ci = P0 + T + 2 + torch.arange(B, dtype=torch.int32, device=cuda_device)
    count = (lambda: theads.shared_heads_launches) if layout == "heads" else (
        lambda: tdec.shared_launches)
    seq_axes = dec.cache_seq_axes()
    res = {}
    with torch.no_grad():
        for impl in ("auto", "plain"):
            dec.attn_impl = impl
            shared = dec.init_cache(2, P0)
            dec(head, cache=shared, cache_index=0, compute_logits=False)
            kw = dict(shared_cache=shared, shared_len=P0, prefix_map=pm)
            cache = dec.init_cache(B, T + warm + 16)
            dec(tail, cache=cache, cache_index=P0, compute_logits=False, **kw)
            for i in range(warm):
                dec(steps[:, i:i + 1], cache=cache, cache_index=P0 + T + i, compute_logits=False,
                    **kw)
            before = [c.clone() for c in cache]
            c0 = count()
            logits = dec(chunk, cache=cache, cache_index=ci, kv_lens=ci + Sq, **kw)[0].float()
            torch.cuda.synchronize()
            changed = sum((a != b).movedim(ax, 2).flatten(3).any(-1).int()
                          for a, b, ax in zip(cache, before, seq_axes)) > 0
            res[impl] = (logits, cache, count() - c0, changed)
    dec.attn_impl = "auto"
    (k, kc, kn, kchg), (p, pc, pn, pchg) = res["auto"], res["plain"]
    assert (kn, pn) == (cfg.num_layers, 0)
    assert ((k - p).abs().max() / p.abs().max()).item() < 2e-2
    for a, b in zip(kc, pc):
        assert torch.equal(a[0], b[0])
    # the own-cache positions the call writes; layer 0's k / v depend only on
    # the token and its position, so they change where the token does
    expect = torch.zeros_like(kchg[0])
    new_token = torch.zeros_like(kchg[0])
    before_ids = torch.cat([tail, steps], 1).cpu()
    for b in range(B):
        w0 = int(ci[b]) - P0
        expect[b, w0:w0 + Sq] = True
        for t in range(Sq):
            new_token[b, w0 + t] = (w0 + t >= before_ids.shape[1]
                                    or int(before_ids[b, w0 + t]) != int(chunk[b, t]))
    for chg in (kchg, pchg):
        assert not bool((chg & ~expect[None]).any())
        assert bool(chg[0][new_token].all())


# ------------------------------------------------------ checkpoint loading
@pytest.mark.cuda
def test_safetensors_reader_loads_a_bf16_shard_onto_the_card(cuda_device, tmp_path):
    """A BF16 shard read by the reader (no safetensors package on the card's
    machine) and moved to the card is bit for bit what chip_smoke.py's
    writer wrote."""
    import chip_smoke
    from vla_rft_tpu_torch.utils import weight_files

    gen = torch.Generator().manual_seed(0)
    sd = {"w": torch.randn(64, 96, generator=gen).bfloat16(),
          "b": torch.randn(96, generator=gen).bfloat16(), "s": torch.tensor(3, dtype=torch.int64)}
    path = str(tmp_path / "shard.safetensors")
    chip_smoke.write_safetensors(path, sd)
    got = {k: v.to(cuda_device) for k, v in weight_files.load_file(path).items()}
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert got[k].device.type == "cuda" and got[k].dtype == v.dtype
        assert torch.equal(got[k].cpu().reshape(-1).view(torch.uint8),
                           v.reshape(-1).view(torch.uint8)), k


# ------------------------------------------- f32 instances (push preset)
# The f32 instances of #1-#5 (the push preset's f32 models) against their f32
# twins: the same products summed in another order, |d| <= 1e-5 max|ref| +
# 1e-6 per output and gradient.
F32_TOL = (1e-5, 1e-6)
PUSH_FLASH = [
    # (B, S, Hq, Hkv, D, per-row kwargs): the policy LLM's prefill (8 x 96,
    # 4 / 2 heads of 32), BC's 32 rows, the WM's training rows (16 x 270, 2 / 2
    # of 64) and its prefill of 8 prefixes of 80, masked variants
    (8, 96, 4, 2, 32, {}),
    (32, 96, 4, 2, 32, {"kv_lens": [96] * 31 + [40]}),
    (16, 270, 2, 2, 64, {}),
    (8, 80, 2, 2, 64, {"kv_starts": [0, 0, 3, 0, 0, 79, 0, 0]}),
    (3, 130, 4, 2, 32, {"q_offset": [0, 5, 9], "kv_lens": [130, 0, 77]}),
]


def _f32_close(got, ref):
    tol = F32_TOL[0] * ref.float().abs().max().item() + F32_TOL[1]
    assert got.dtype == torch.float32 and (got - ref).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,kw", PUSH_FLASH)
def test_f32_flash_kernels_match_twins_at_push_shapes(cuda_device, B, S, Hq, Hkv, D, kw, causal):
    gen = torch.Generator(device=cuda_device).manual_seed(B + S)
    q, do = (torch.randn(B, S, Hq, D, generator=gen, device=cuda_device) for _ in range(2))
    k, v = (torch.randn(B, S, Hkv, D, generator=gen, device=cuda_device) for _ in range(2))
    rows = {a: torch.tensor(x, device=cuda_device) for a, x in kw.items()}
    o, lse = tattn.flash_fwd(q, k, v, causal=causal, **rows)
    o_ref, lse_ref = tattn.attention_plain(q, k, v, causal=causal, return_lse=True, **rows)
    _f32_close(o, o_ref)
    _f32_close(lse.clamp_min(-1e4), lse_ref.clamp_min(-1e4))
    got = tattn.flash_bwd(q, k, v, o, lse, do, causal=causal, **rows)
    for g, r in zip(got, tattn.attention_bwd_plain(q, k, v, o, lse, do, causal=causal, **rows)):
        _f32_close(g, r)
    again = tattn.flash_bwd(q, k, v, o, lse, do, causal=causal, **rows)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(tattn.flash_fwd(q, k, v, causal=causal, **rows)[0], o)


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False])
def test_f32_decode_kernels_match_twins_at_push_shapes(cuda_device, shared):
    """#4 over the RFT rollout's call (64 rows over 8 prefixes of 80, own
    caches at several lengths, Sq 1) and #5 over one cache, f32 throughout."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    B, P, Sr, Hkv = 64, 8, 192, 2
    rn = lambda *s: torch.randn(*s, generator=gen, device=cuda_device)
    q, ck, cv = rn(B, 1, Hkv, 64), rn(B, Sr, Hkv * 64), rn(B, Sr, Hkv * 64)
    own = torch.tensor([1 + (29 * i) % Sr for i in range(B)], device=cuda_device)
    if shared:
        sck, scv = rn(P, 80, Hkv * 64), rn(P, 80, Hkv * 64)
        pm = torch.arange(B, device=cuda_device) // (B // P)
        kw = dict(shared_len=80, kv_lens=80 + own, q_offset=79 + own,
                  shared_starts=torch.tensor([i % 5 for i in range(B)], device=cuda_device))
        got = tdec.decode_shared_kernel(q, ck, cv, sck, scv, pm, **kw)
        ref = tdec.decode_shared_plain(q, ck, cv, sck, scv, pm, **kw)
    else:
        kw = dict(kv_lens=own, q_offset=own - 1, kv_starts=torch.zeros_like(own))
        got, ref = tdec.decode_kernel(q, ck, cv, **kw), tdec.decode_plain(q, ck, cv, **kw)
    _f32_close(got, ref)
    with pytest.raises(ValueError, match="f32 without scales"):
        tdec.decode_kernel(q, ck.bfloat16(), cv.bfloat16(), kv_lens=own, q_offset=own - 1)


@pytest.mark.cuda
def test_push_preset_builds_on_the_card_and_launches_the_f32_kernels(cuda_device):
    """`push` builds on the card; its policy's context forward launches #1
    once per LLM layer and agrees with the plain route."""
    from vla_rft_tpu_torch.config import vla_rft_default_config
    from vla_rft_tpu_torch.data.push_data import build_push_prompt
    from vla_rft_tpu_torch.models.factory import build_models
    from vla_rft_tpu_torch.workers.flow_actor import encode_context

    b = build_models(vla_rft_default_config(), "push", device="cuda")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    ids, attn, labels = (torch.as_tensor(x, device=cuda_device).repeat(8, 1)
                         for x in build_push_prompt(32, 8))
    batch = {"input_ids": ids, "attention_mask": attn, "labels": labels,
             "pixels": torch.rand(8, 64, 64, 6, generator=gen, device=cuda_device)}
    tattn.launches = 0
    with torch.no_grad():
        hidden = encode_context(b.vla, batch)
        assert tattn.launches == b.vla_cfg.llm.num_layers
        b.vla.language_model.attn_impl = "plain"
        plain = encode_context(b.vla, batch)
    assert hidden.dtype == torch.float32 and torch.isfinite(hidden).all()
    assert (hidden - plain).abs().max().item() <= 1e-4 * plain.abs().max().item()
