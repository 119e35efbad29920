"""What the CPU can hold of the redesigned kernel #10 (one-token decode
attention that writes its own cache row), which runs only on the card.

* Its launch plan (`split_plan`) with the kernel's own device-side split,
  mirrored here: rank r of a (row, kv head) cluster takes the key tiles
  [r T / R, (r + 1) T / R) of the window [clamp(kv_starts[b], 0, idx), idx),
  T tiles counted from the window's first row.  Over a grid of (B, Hkv,
  idx, kv_starts) the ranks cover every key of the window exactly once, R
  stays in 1..8 and never exceeds the tiles of a window that starts at row
  0, and the plan takes only sizes the host knows (no kv_starts).
* A torch model of the kernel's arithmetic on that plan: per rank, four
  warps each running an online softmax (2^x with the -80 floor) over their
  keys of each tile, merged in warp order, the current token folded in by
  the last rank, then the ranks merged in rank order, agrees with the twin
  within 1e-5 on f32 caches (the same f32 arithmetic in another order), on
  ranks without a tile too; with P in two bf16 terms, as the bf16 cache's
  tensor-core path keeps it, within the card's decode tolerance.
* The twin against the reference's Pallas kernel in interpret mode at D 128
  with 16 query heads a kv head, a shape tests/test_torch_fused_decode_attention.py
  does not cover.
* kernel_trace.py's text edits of the kernel source (its stamps and timed
  variants) still find their anchors.
"""
import importlib.util
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kernel_mode import INTERPRET
from vla_rft_tpu.ops.fused_decode_attention import fused_decode_attention as j_fused
from vla_rft_tpu_torch.ops import fused_decode_attention as t_fda

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("kernel_trace", ROOT / "kernel_trace.py")
kt = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kt)

DEC_RTOL, DEC_ATOL = 2.0 ** -7, 2e-3  # the card's decode tolerance (chip_smoke.py)
WARPS = 4  # the kernel's warps per block, each with key_tile / WARPS keys of a tile
LOG2E = 1.4426950408889634
EXP2_FLOOR = -80.0 * LOG2E


def _rank_keys(lo, idx, rank, splits, tk):
    """The kernel's split: the keys rank `rank` reads, [(first, end)] per
    tile, from the window [lo, idx) cut into tiles of tk keys from lo."""
    n_tiles = -(-(idx - lo) // tk)
    t_begin, t_end = n_tiles * rank // splits, n_tiles * (rank + 1) // splits
    return [(lo + t * tk, min(lo + (t + 1) * tk, idx)) for t in range(t_begin, t_end)]


# ---------------------------------------------------------------- the plan
PLAN_SHAPES = [
    # (B, Hkv, D, cache dtype): the WM's 10 rows and its configured 128,
    # Qwen2.5-0.5B's 14/2 heads, one row of one head, the f32 cache's
    # 64-key tiles (D 128), D 32
    (10, 16, 64, torch.bfloat16),
    (128, 16, 64, torch.bfloat16),
    (10, 2, 64, torch.bfloat16),
    (1, 1, 64, torch.bfloat16),
    (3, 2, 128, torch.float32),
    (4, 4, 32, torch.float32),
]


@pytest.mark.parametrize("B,Hkv,D,cdt", PLAN_SHAPES,
                         ids=[f"b{s[0]}_hkv{s[1]}_d{s[2]}_{str(s[3])[6:]}" for s in PLAN_SHAPES])
def test_split_plan_covers_every_key_once(B, Hkv, D, cdt):
    params = list(inspect.signature(t_fda.split_plan).parameters)
    assert params == ["B", "Hq", "Hkv", "D", "idx", "cache_dtype", "sms"]  # no device data
    rng = np.random.default_rng(B * Hkv + D)
    tk = t_fda.key_tile(D, cdt)
    assert tk == (64 if cdt == torch.float32 and D == 128 else 128)
    for idx in (0, 1, 63, 64, 100, 127, 128, 129, 700, 1379, 1663):
        for sms in (132, 114):
            plan = t_fda.split_plan(B, Hkv * 7, Hkv, D, idx, cdt, sms)
            R = plan["splits"]
            assert plan["grid"] == (R, Hkv, B) and plan["cluster"] == (R, 1, 1)
            assert plan["key_tile"] == tk and 1 <= R <= t_fda.MAX_SPLITS
            assert R <= max(1, -(-idx // tk))  # no rank idle when kv_starts is 0
            if idx >= tk * t_fda.MAX_SPLITS and B * Hkv >= sms:
                assert R == 1  # the card is full without a split
        starts = [0, 1, idx // 2, max(idx - 1, 0), idx, idx + 9, -4,
                  *rng.integers(-5, idx + 10, 5).tolist()]
        for lo_raw in starts:
            lo = min(max(lo_raw, 0), idx)
            for R in range(1, t_fda.MAX_SPLITS + 1):
                seen = np.zeros(idx + tk, int)
                for rank in range(R):
                    for first, end in _rank_keys(lo, idx, rank, R, tk):
                        assert lo <= first < end <= idx and end - first <= tk
                        seen[first:end] += 1
                want = np.zeros_like(seen)
                want[lo:idx] = 1
                assert (seen == want).all(), (idx, lo_raw, R)


def test_split_plan_at_the_timed_shapes():
    """One block per SM (PERF.md section 6): no split at the WM's 10
    rows or 128 rows, 7 ranks for Qwen2.5-0.5B's 20 (row, kv head) pairs."""
    bf = torch.bfloat16
    assert t_fda.split_plan(10, 16, 16, 64, 1379, bf)["splits"] == 1
    assert t_fda.split_plan(128, 16, 16, 64, 1379, bf)["splits"] == 1
    assert t_fda.split_plan(10, 14, 2, 64, 1379, bf)["splits"] == 7
    assert t_fda.split_plan(10, 14, 2, 64, 200, bf)["splits"] == 2  # two tiles at row 200


# ------------------------------------------------ the arithmetic of the kernel
def _merge(states):
    m = torch.stack([s[0] for s in states]).amax(0)
    l, acc = torch.zeros_like(states[0][1]), torch.zeros_like(states[0][2])
    for sm, sl, sa in states:
        f = torch.exp2(torch.clamp(sm - m, min=EXP2_FLOOR))
        l, acc = l + sl * f, acc + sa * f[..., None]
    return m, l, acc


def _model(q, kn, vn, ck, cv, li, idx, starts, splits, p_two_terms):
    """#10's arithmetic in torch f32: the plan's ranks, four warps a rank
    over key_tile / 4 keys of each tile, warp order, then rank order, the
    current token folded in by the last rank.  With p_two_terms, P is
    rounded to hi + lo bf16 before P V (the tensor-core path)."""
    B, _, Hq, D = q.shape
    Hkv = ck.shape[2]
    G = Hq // Hkv
    tk = t_fda.key_tile(D, ck.dtype)
    kpw = tk // WARPS
    sl2 = D ** -0.5 * LOG2E
    out = torch.zeros(B, Hq, D)
    for b in range(B):
        qb = q[b, 0].float().view(Hkv, G, D)
        K, V = ck[li, b].float(), cv[li, b].float()  # (Hkv, S, D)
        lo = min(max(int(starts[b]), 0), idx)
        ranks = []
        for rank in range(splits):
            warps = [(torch.full((Hkv, G), -1e30), torch.zeros(Hkv, G), torch.zeros(Hkv, G, D))
                     for _ in range(WARPS)]
            for first, end in _rank_keys(lo, idx, rank, splits, tk):
                for w in range(WARPS):
                    j = torch.arange(first + w * kpw, first + (w + 1) * kpw)
                    ok = j < end
                    jj = j.clamp(max=idx - 1)
                    k = torch.where(ok[:, None], K[:, jj], 0.0)
                    v = torch.where(ok[:, None], V[:, jj], 0.0)
                    x = torch.einsum("hgd,hnd->hgn", qb, k) * sl2
                    m, l, acc = warps[w]
                    mx = torch.where(ok, x, torch.full_like(x, -1e30)).amax(-1)
                    m_new = torch.maximum(m, mx)
                    alpha = torch.exp2(torch.clamp(m - m_new, min=EXP2_FLOOR))
                    p = torch.where(ok, torch.exp2(torch.clamp(x - m_new[..., None],
                                                               min=EXP2_FLOOR)), 0.0)
                    pv = p
                    if p_two_terms:
                        hi = p.bfloat16().float()
                        pv = hi + (p - hi).bfloat16().float()
                    warps[w] = (m_new, l * alpha + p.sum(-1), acc * alpha[..., None] + pv @ v)
            m, l, acc = _merge(warps)
            if rank == splits - 1:  # the current token, last
                x = torch.einsum("hgd,hd->hg", qb, kn[b, 0].float()) * sl2
                m_new = torch.maximum(m, x)
                alpha = torch.exp2(torch.clamp(m - m_new, min=EXP2_FLOOR))
                p = torch.exp2(torch.clamp(x - m_new, min=EXP2_FLOOR))
                m, l = m_new, l * alpha + p
                acc = acc * alpha[..., None] + p[..., None] * vn[b, 0].float()[:, None, :]
            ranks.append((m, l, acc))
        m, l, acc = _merge(ranks)
        out[b] = (acc / l.clamp_min(1e-30)[..., None]).reshape(Hq, D)
    return out[:, None]


MODEL_CASES = [
    # (name, cache dtype, B, G, Hkv, D, S, idx, kv_starts, splits or None)
    ("wm_plan", "float32", 3, 1, 4, 64, 512, 400, [0, 37, 399], None),
    ("gqa_14_2_r7", "float32", 2, 7, 2, 64, 1024, 900, [0, 300], 7),
    ("r8_small_idx", "float32", 4, 2, 2, 64, 256, 129, [0, 128, 129, 200], 8),
    ("r8_idx1", "float32", 2, 1, 2, 32, 64, 1, [0, 1], 8),
    ("row0", "float32", 2, 4, 1, 64, 64, 0, [0, 0], 3),
    ("d128_g16_64key_tiles", "float32", 2, 16, 1, 128, 400, 333, [5, 0], 5),
    ("d32_g16", "float32", 2, 16, 2, 32, 300, 257, [0, 2], 2),
    ("bf16_p_two_terms", "bfloat16", 3, 7, 2, 64, 512, 450, [0, 9, 449], 3),
]


@pytest.mark.parametrize("case", MODEL_CASES, ids=[c[0] for c in MODEL_CASES])
def test_split_and_merge_model_agrees_with_the_twin(case):
    name, cdt, B, G, Hkv, D, S, idx, starts, splits = case
    rng = np.random.default_rng(len(name) + idx)
    dt = getattr(torch, cdt)
    arr = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dt)
    L, li = 2, 1
    ck, cv = arr(L, B, Hkv, S, D), arr(L, B, Hkv, S, D)
    q, kn, vn = arr(B, 1, Hkv * G, D), arr(B, 1, Hkv, D), arr(B, 1, Hkv, D)
    ks = torch.tensor(starts)
    R = splits or t_fda.split_plan(B, Hkv * G, Hkv, D, idx, dt)["splits"]
    ref, _, _ = t_fda.fused_decode_attention_plain(q, kn, vn, ck.clone(), cv.clone(), li, idx, ks)
    got = _model(q, kn, vn, ck, cv, li, idx, starts, R, p_two_terms=dt == torch.bfloat16)
    ref = ref.float()
    if dt == torch.float32:
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    else:  # the twin keeps P in f32 and rounds O to bf16 once
        d = (got.bfloat16().float() - ref).abs()
        assert bool((d <= DEC_RTOL * ref.abs() + DEC_ATOL).all()), d.max().item()
    for b in range(B):
        if starts[b] >= idx:  # no history: the current token's value
            torch.testing.assert_close(got[b, 0], vn[b, 0].float().repeat_interleave(G, 0),
                                       atol=1e-6, rtol=1e-6)
    assert float(ref.abs().max()) > 0.05


# ------------------------------------------- the twin against the reference
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twin_matches_pallas_interpret_at_d128_g16(dtype):
    rng = np.random.default_rng(16)
    L, B, Hkv, G, S, D = 2, 2, 1, 16, 64, 128
    Hq, li, idx, kv_starts = Hkv * G, 1, 45, [0, 7]
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
    got, _, _ = t_fda.fused_decode_attention(t(q), t(k_new), t(v_new), tck, tcv, li, idx,
                                             torch.tensor(kv_starts))
    np.testing.assert_array_equal(tck.float().numpy(), np.asarray(nck, np.float32))
    np.testing.assert_array_equal(tcv.float().numpy(), np.asarray(ncv, np.float32))
    tol = dict(atol=3e-5, rtol=1e-4) if dtype == "float32" else dict(atol=1e-5, rtol=2 ** -7)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(out, np.float32), **tol)


@pytest.mark.parametrize("name", ["stamps", "sm_record", *sorted(kt.FDA_VARIANTS)])
def test_kernel_trace_edits_find_their_anchors(name):
    """kernel_trace.py builds #10's stamped copy and its timed variants by
    text edits of csrc/fused_decode_attention.cu: each anchor occurs once,
    also after the variant's own edits."""
    src = (ROOT / "vla_rft_tpu_torch" / "csrc" / "fused_decode_attention.cu").read_text()
    edits = {"stamps": kt._FDA_EDITS, "sm_record": [kt._FDA_SMID]}.get(name)
    if edits is None:
        edits = kt.FDA_VARIANTS[name] + kt._FDA_EDITS + [kt._FDA_SMID]
    for anchor, repl in edits:
        assert src.count(anchor) == 1, anchor
        src = src.replace(anchor, repl)


def test_wrapper_refuses_on_the_cpu_before_planning():
    q = torch.zeros(1, 1, 2, 32)
    kv = torch.zeros(1, 1, 2, 32)
    ck = torch.zeros(1, 1, 2, 8, 32)
    before = t_fda.launches
    for splits in (None, 0, 9):
        with pytest.raises(ValueError, match="CUDA"):
            t_fda.fused_decode_attention_kernel(q, kv, kv, ck, ck.clone(), 0, 3, splits=splits)
    assert t_fda.launches == before
