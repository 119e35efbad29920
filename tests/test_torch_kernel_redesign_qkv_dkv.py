"""What the CPU can hold of the redesigned kernels #8 (RMSNorm + int8-weight
q/k/v + rope + KV quantisation) and #3 (flash backward dK/dV), which run
only on the card.

* The bound on #8's k/v scales.  #8 sums its products in another order
  than its twin, so an element of k (or v) can round one bf16 ulp away from
  the twin's; the head's amax then moves by at most one ulp (the max of
  values that each moved by at most one ulp), and the scale bf16(max(amax /
  127, 1e-8)) moves by at most two: proven here over every bf16 amax from
  2^-20 to 2^10, and shown to be reached, so a one-ulp bound would be wrong.
* #8's new summation order: f32 partial sums per K split, each the sum of
  its four warps' k16 steps in warp order, added in split order, with the
  splits `qkv_plan` chooses at WM width.  A plain emulation of that order
  runs against the Pallas `_qkv_kernel` body evaluated eagerly by XLA (the
  arithmetic the plain twin equals bit for bit) under the card tests'
  bounds, and the share of k/v scales and int8 entries that move is
  printed and bounded.
* The launch plans computed in Python (`qkv_plan`, `dkv_plan`) and the
  kernels' indexing under them cover every head, column, K index, token,
  key tile, query head and query tile exactly once; #3's causal skips drop
  only work with no valid (query, key) pair, and its key tiles run heaviest
  first.
* The CPU-side refusals of the two changed wrappers still raise, and their
  front ends run the twins for CPU tensors without a launch.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vla_rft_tpu.ops import fused_decode_layer as j_fused
from vla_rft_tpu_torch.ops import attention as t_attn
from vla_rft_tpu_torch.ops import fused_decode_layer as t_fused

D = 64
FUSED_RTOL = 2.0 ** -7  # the card tests' bound on q vs the twin, of max|q|
FUSED_INT8_SHARE = 0.01  # the card tests' bound on the share of k/v entries or scales that move
SCALE_ULPS = 2  # the card tests' bound on a k/v scale vs the twin's, in bf16 ulps
BK, WARPS = 64, 4  # rows of a chunk, one k16 step per warp


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The bf16 bit patterns as int32 (positive values order like their bits)."""
    return t.view(torch.int16).to(torch.int32)


# ------------------------------------------------------------ scale bound
def _scale(amax: torch.Tensor) -> torch.Tensor:
    """The quantiser's scale of a bf16 amax, as `_quant` (ops/fused_decode_layer.py)
    and #8 compute it: max(amax / 127, 1e-8) in f32, stored as bf16."""
    return torch.clamp(amax.float() / 127.0, min=1e-8).to(torch.bfloat16)


def test_k_scale_moves_at_most_two_ulps_when_its_amax_moves_one():
    """Derivation.  Let a = m 2^e (1 <= m < 2) be a bf16 amax and a + 2^(e-7)
    its next bf16 value up.  The quotient a / 127 = (128/127) m 2^(e-7):
    while (128/127) m < 2 its bf16 ulp is 2^(e-14), and the two quotients
    differ by 2^(e-7) / 127 = 128/127 = 1.0079 ulps (past 2 the ulp doubles
    and they differ by 0.504).  Rounding each to the nearest bf16 moves it by
    at most half an ulp, so the two scales differ by at most 1.0079 + 1 ulps,
    that is by at most 2 (the f32 quotient's own rounding is 2^-24 of it);
    2 is reached when the lower quotient sits within 0.0079 ulp below a
    rounding midpoint, about 0.8 % of the pairs.  The sweep below checks
    every bf16 amax the WM produces (2^-20 to 2^10; below 1.27e-6 the 1e-8
    floor gives both the same scale) exactly as the quantiser rounds."""
    lo = (127 - 20) << 7  # bits of 2^-20
    hi = (127 + 10) << 7  # bits of 2^10
    bits = torch.arange(lo, hi + 1, dtype=torch.int32)
    amax = bits.to(torch.int16).view(torch.bfloat16)
    assert amax[0].item() == 2.0 ** -20 and amax[-1].item() == 2.0 ** 10
    assert bool(torch.isfinite(amax.float()).all()) and bool((amax.float() > 0).all())
    s = _bits(_scale(amax))
    steps = (s[1:] - s[:-1]).abs()  # scale of a vs scale of the next bf16 value up
    share = (steps == SCALE_ULPS).float().mean().item()
    print(f"{len(steps)} neighbouring amax pairs: max {steps.max().item()} ulps, "
          f"{share:.4%} at {SCALE_ULPS}")
    assert steps.max().item() == SCALE_ULPS  # the bound holds, and it is tight
    assert 0 < share < 0.02  # 0.78 % of the pairs reach it


# --------------------------------------------- #8's summation order
def _bf(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _split_k_acc(xn, w, splits):
    """f32 acc of xn @ w summed as #8 sums it: per split, each of the four
    warps adds its k16 step of every chunk in chunk order, the warps are
    added in warp order, then the splits in split order."""
    K = w.shape[0]
    per = K // BK // splits
    wf = w.astype(np.float32)
    acc = np.zeros((xn.shape[0], w.shape[1]), np.float32)
    for sp in range(splits):
        block = None
        for warp in range(WARPS):
            part = np.zeros_like(acc)
            for c in range(per):
                k0 = (sp * per + c) * BK + 16 * warp
                part = part + xn[:, k0:k0 + 16] @ wf[k0:k0 + 16]
            block = part if block is None else block + part
        acc = acc + block
    return acc


def _emulate_qkv(x, cos, sins, p, Hq, Hkv, splits, eps):
    """#8's result with its sum order: the twin's RMSNorm, rope and
    quantisation around the split-K products."""
    N, H = x.shape
    var = np.mean(x * x, axis=-1, keepdims=True, dtype=np.float32)
    xn = _bf(x * (np.float32(1.0) / np.sqrt(var + np.float32(eps))) * p["n1"])
    q, k, v = (torch.from_numpy(_bf(_bf(_split_k_acc(xn, p[n][0], splits)) * p[n][1]))
               .bfloat16() for n in ("wq", "wk", "wv"))
    cos_t, sins_t = torch.from_numpy(cos), torch.from_numpy(sins)
    q_r = t_fused._rope_dense(q, cos_t, sins_t, D).to(torch.bfloat16)
    k_r = t_fused._rope_dense(k, cos_t[:, :Hkv * D], sins_t[:, :Hkv * D], D)
    k8, ks = t_fused._quant(k_r.to(torch.bfloat16).float(), Hkv, D, N, 1)
    v8, vs = t_fused._quant(v.float(), Hkv, D, N, 1)
    return q_r.float().numpy(), k8, v8, ks, vs


def _pallas_qkv(x, cos, sins, p, Hq, Hkv, eps):
    """`_qkv_kernel` evaluated eagerly by XLA, numpy arrays for its refs."""
    bf = jnp.bfloat16
    N, H = x.shape
    v3 = lambda a: np.asarray(a, bf)[None, None]
    w3 = lambda n: np.asarray(p[n][0])[None]
    outs = [np.zeros((N, 1, Hq * D), bf), np.zeros((N, 1, Hkv * D), np.int8),
            np.zeros((N, 1, Hkv * D), np.int8), np.zeros((N, Hkv, 1), bf),
            np.zeros((N, Hkv, 1), bf)]
    j_fused._qkv_kernel(None, cos, sins, np.asarray(x, bf)[:, None], v3(p["n1"]),
                        w3("wq"), v3(p["wq"][1]), w3("wk"), v3(p["wk"][1]), w3("wv"),
                        v3(p["wv"][1]), *outs, eps=eps, hq=Hq, hkv=Hkv, d=D)
    q, k8, v8, ks, vs = outs
    as_bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
    return (np.asarray(q, np.float32)[:, 0], torch.from_numpy(k8), torch.from_numpy(v8),
            as_bf(ks), as_bf(vs))


@pytest.mark.parametrize("N", [10, 128])
def test_qkv_split_k_order_stays_within_the_card_bounds(N):
    rng = np.random.default_rng(200 + N)
    H, Hq, Hkv, eps = 1024, 16, 16, 1e-6

    def w(k_out):
        return (rng.integers(-127, 128, (H, k_out)).astype(np.int8),
                _bf(rng.uniform(0.5, 1.5, k_out) * 0.02 / np.sqrt(H)))

    p = {"wq": w(Hq * D), "wk": w(Hkv * D), "wv": w(Hkv * D),
         "n1": _bf(1.0 + 0.1 * rng.normal(size=H))}
    x = _bf(rng.normal(size=(N, H)))
    pos = torch.from_numpy(rng.integers(0, 1600, (N, 1)))
    cos, sins = (t.numpy() for t in t_fused.rope_tables(pos, 10000.0, Hq, D))
    plan = t_fused.qkv_plan(N, Hq, Hkv, H)
    assert plan["splits"] == (4 if N == 10 else 1)  # the orders under test
    ref = _pallas_qkv(x, cos, sins, p, Hq, Hkv, eps)
    emu = _emulate_qkv(x, cos, sins, p, Hq, Hkv, plan["splits"], eps)
    assert np.abs(emu[0] - ref[0]).max() <= FUSED_RTOL * np.abs(ref[0]).max()
    for name, t, r, s, rs in (("k", emu[1], ref[1], emu[3], ref[3]),
                              ("v", emu[2], ref[2], emu[4], ref[4])):
        ulps = (_bits(s) - _bits(rs)).abs()
        d = (t.int() - r.int()).abs()
        flip = (s != rs).transpose(1, 2).repeat_interleave(D, dim=-1)
        print(f"N={N} {name}: scales moved {(ulps > 0).float().mean().item():.4f} "
              f"(max {ulps.max().item()} ulps), int8 moved {(d > 0).float().mean().item():.5f}")
        assert ulps.max().item() <= SCALE_ULPS
        assert (ulps > 0).float().mean().item() <= FUSED_INT8_SHARE
        assert bool((d <= torch.where(flip, 2, 1)).all())
        assert (d > 0).float().mean().item() <= FUSED_INT8_SHARE


# ------------------------------------------------------------ launch plans
# (Hq, Hkv, H): the WM (libero), Qwen2.5-0.5B's widths, the tiny preset's
# WM and the card tests' small grid
QKV_WIDTHS = {"wm": (16, 16, 1024), "wm_gqa": (16, 4, 1024), "qwen": (14, 2, 896),
              "tiny": (1, 1, 64), "test_grid": (2, 2, 128)}
TOKENS = [1, 7, 8, 9, 10, 16, 17, 19, 32, 33, 64, 65, 128, 640, 896]


@pytest.mark.parametrize("widths", sorted(QKV_WIDTHS))
def test_qkv_plan_covers_every_index_once(widths):
    Hq, Hkv, H = QKV_WIDTHS[widths]
    for sms in (132, 114):
        for N in TOKENS:
            plan = t_fused.qkv_plan(N, Hq, Hkv, H, sms)
            tile, groups, splits = plan["token_tile"], plan["token_groups"], plan["splits"]
            tiles, gs, gz = plan["grid"]
            assert (tiles, gs, gz) == (Hq + 2 * Hkv, splits, groups)
            assert tile in t_fused.QKV_TOKEN_TILES
            assert tiles * splits * groups <= 2 * sms or splits == 1
            assert 1 <= splits <= t_fused.MAX_SPLITS
            # head tile t -> (kind, head): every column of Wq, Wk, Wv once
            cols = {0: np.zeros(Hq * D, int), 1: np.zeros(Hkv * D, int),
                    2: np.zeros(Hkv * D, int)}
            for t in range(tiles):
                kind = 0 if t < Hq else (1 if t < Hq + Hkv else 2)
                head = t - (0, Hq, Hq + Hkv)[kind]
                cols[kind][head * D:(head + 1) * D] += 1
            assert all((c == 1).all() for c in cols.values())
            # K: chunks split * chunks + c of 64 rows
            kcount = np.zeros(H, int)
            for sp in range(splits):
                for c in range(plan["chunks"]):
                    r0 = (sp * plan["chunks"] + c) * BK
                    kcount[r0:r0 + BK] += 1
            assert (kcount == 1).all()
            # tokens: group z holds z * tile + r; the epilogue gives token
            # tok of the group to rank (tok / 4) % splits, warp tok % 4
            tok = np.zeros(N, int)
            for z in range(groups):
                for rank in range(splits):
                    for warp in range(WARPS):
                        for r in range(WARPS * rank + warp, tile, WARPS * splits):
                            if z * tile + r < N:
                                tok[z * tile + r] += 1
            assert (tok == 1).all(), (widths, N)


# (B, S, Hq, Hkv): the WM-SFT layer, the VLA-adapter (Qwen) layer, the tiny
# policy's LLM and the card tests' cases
DKV_SHAPES = {"wm_sft": (4, 1663, 16, 16), "vla_adapter": (16, 352, 14, 2),
              "tiny": (2, 97, 4, 2), "kv_lens": (2, 96, 4, 2), "gqa_7to1_ragged": (2, 77, 14, 2),
              "d128_ragged": (2, 130, 14, 2), "q_offset": (2, 64, 4, 2)}


def _qt_begin(k0, q_off, Sq, causal):
    """The kernel's first query tile that can see key tile k0."""
    n_qt = -(-Sq // 64)
    if not causal:
        return 0
    need = k0 - q_off - 63
    return n_qt if q_off + Sq - 1 < k0 else (0 if need <= 0 else -(-need // 64))


@pytest.mark.parametrize("shape", sorted(DKV_SHAPES))
def test_dkv_plan_covers_every_pair_once_heavy_first(shape):
    B, S, Hq, Hkv = DKV_SHAPES[shape]
    G = Hq // Hkv
    for sms in (132, 114):
        plan = t_attn.dkv_plan(B, S, Hq, Hkv, sms)
        splits, (gx, gy, gz) = plan["splits"], plan["grid"]
        assert (gx, gy, gz) == (splits, B * Hkv, plan["key_tiles"])
        assert gz * 64 >= S > (gz - 1) * 64  # every key once
        assert splits in (1, 2, 4) and splits <= max(1, min(G, t_attn.DKV_MAX_SPLITS))
        assert splits == 1 or B * Hkv * gz * splits // 2 < 3 * sms
        for causal in (False, True):
            for Sq, q_off in ((S, 0), (S // 2 + 1, S - S // 2 - 1), (S, 5)):
                n_qt = -(-Sq // 64)
                work = []
                for kt in range(gz):
                    k0 = kt * 64
                    qb = _qt_begin(k0, q_off, Sq, causal)
                    n_live = n_qt - qb
                    seen = np.zeros((G, n_qt), int)
                    for rank in range(splits):
                        n_pairs = G * n_live
                        mine = max(0, -(-(n_pairs - rank) // splits))
                        for j in range(mine):
                            i = rank + j * splits
                            seen[i // n_live, qb + i % n_live] += 1
                    assert (seen[:, qb:] == 1).all() and (seen[:, :qb] == 0).all()
                    # a skipped query tile holds no query that sees a key of the tile
                    for qt in range(qb):
                        last = min(qt * 64 + 63, Sq - 1) + q_off
                        assert causal and last < k0
                    # a warp's skip (keys kp0..kp0+15 after the tile's last
                    # query) drops only masked pairs
                    for qt in range(qb, n_qt):
                        for kp0 in range(k0, k0 + 64, 16):
                            if causal and q_off + qt * 64 + 63 < kp0:
                                assert q_off + min(qt * 64 + 63, Sq - 1) < kp0
                    work.append(G * n_live)
                # the key tile is the slowest grid axis: under causal masking
                # (and q_offset >= 0) the first tiles carry the most pairs
                assert work == sorted(work, reverse=True)


# --------------------------------------------------------------- refusals
def test_changed_wrappers_refuse_on_the_cpu():
    q = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 8, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_attn.flash_bwd_dkv(q, k, k, q, lse, lse)
    x = torch.zeros(1, 1, 128, dtype=torch.bfloat16)
    w = torch.zeros(128, 128, dtype=torch.int8)
    s = torch.zeros(128, dtype=torch.bfloat16)
    n = torch.zeros(128, dtype=torch.bfloat16)
    cos = torch.zeros(1, 128)
    kw = dict(num_heads=2, num_kv_heads=2, head_dim=64, eps=1e-6)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_fused.fused_qkv_kernel(x, cos, cos, n, w, s, w, s, w, s, **kw)
    with pytest.raises(ValueError, match="unknown fused decode impl"):
        t_fused.fused_rmsnorm_qkv(x, cos, cos, n, w, s, w, s, w, s, impl="cuda", **kw)
    # the front ends run the twins for CPU tensors, and launch nothing
    before = (t_attn.bwd_dkv_launches, t_fused.qkv_launches)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, k)]
    o = t_attn.attention(*leaves, causal=True)
    torch.autograd.grad(o.float().sum(), leaves)
    t_fused.fused_rmsnorm_qkv(x, cos, cos, n, w, s, w, s, w, s, **kw)
    assert (t_attn.bwd_dkv_launches, t_fused.qkv_launches) == before
