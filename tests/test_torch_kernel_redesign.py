"""What the CPU can hold of the redesigned kernels #1 (flash forward) and #9
(int8-weight o_proj + MLP), which run only on the card.

* #9 sums its products in a new order: f32 partial sums per K split, each
  the sum of its four warps' k16 steps in warp order, added in split order.
  A plain emulation of that order, with the splits the wrapper plans, runs
  at WM width against the Pallas `_o_mlp_kernel` body evaluated eagerly by
  XLA (the arithmetic the plain twin equals bit for bit): it stays within
  the card tests' FUSED_RTOL = 2^-7 of max|ref| (measured 0-0.0043),
  and the share of bf16 outputs that move off the reference is bounded
  (measured 0-1.1 %), so the card's tolerance fits the new order before
  the card sees it.
* The launch plan the #9 wrapper computes in Python (`o_mlp_plan`: token
  tile, K splits, grid) covers every K index, output column and token
  exactly once at the WM, Qwen, tiny-preset and test-grid widths.  (#1's
  wrapper plans nothing: its 64-query tiles are fixed in the kernel.)
* The CPU-side refusals of the changed wrappers still raise.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vla_rft_tpu.ops import fused_decode_layer as j_fused
from vla_rft_tpu_torch.ops import attention as t_attn
from vla_rft_tpu_torch.ops import fused_decode_layer as t_fused

D = 64
FUSED_RTOL = 2.0 ** -7  # the card tests' bound on #9 vs its twin
MOVED_SHARE_MAX = 0.10  # bf16 outputs one rounding off the reference (0-1.1 % measured)
BK = 64  # rows of a chunk, one k16 step per warp
WARPS = 4


def _bf(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _wm_layer(rng, H=1024, I=4096, Hq=16):
    def w(k_in, k_out):
        return (rng.integers(-127, 128, (k_in, k_out)).astype(np.int8),
                _bf(rng.uniform(0.5, 1.5, k_out) * 0.02 / np.sqrt(k_in)))

    return {"wo": w(Hq * D, H), "wg": w(H, I), "wu": w(H, I), "wd": w(I, H),
            "n2": _bf(1.0 + 0.1 * rng.normal(size=H))}


def _split_k_qdot(x, w, s, splits):
    """bf16(bf16(acc) * s) with acc summed as #9 sums it: per split, each of
    the four warps adds its k16 step of every chunk in chunk order, the
    warps are added in warp order, then the splits in split order; f32."""
    K = w.shape[0]
    per = K // BK // splits
    wf = w.astype(np.float32)
    acc = np.zeros((x.shape[0], w.shape[1]), np.float32)
    for sp in range(splits):
        block = None
        for warp in range(WARPS):
            part = np.zeros_like(acc)
            for c in range(per):
                k0 = (sp * per + c) * BK + 16 * warp
                part = part + x[:, k0:k0 + 16] @ wf[k0:k0 + 16]
            block = part if block is None else block + part
        acc = acc + block
    return _bf(_bf(acc) * s)


def _rmsnorm(x, w, eps):
    var = np.mean(x * x, axis=-1, keepdims=True, dtype=np.float32)
    return _bf(x * (np.float32(1.0) / np.sqrt(var + np.float32(eps))) * w)


def _emulate_o_mlp(attn, x, p, plan, eps):
    sp = {k: v["splits"] for k, v in plan["launches"].items()}
    x1 = _bf(x + _split_k_qdot(attn, *p["wo"], sp["o_proj"]))
    xn = _rmsnorm(x1, p["n2"], eps)
    g = _split_k_qdot(xn, *p["wg"], sp["gate_up"])
    u = _split_k_qdot(xn, *p["wu"], sp["gate_up"])
    sig = _bf(np.float32(1.0) / (np.float32(1.0) + np.exp(-g)))
    m = _bf(_bf(g * sig) * u)
    return _bf(x1 + _split_k_qdot(m, *p["wd"], sp["down"]))


def _pallas_body(attn, x, p, eps):
    """`_o_mlp_kernel` evaluated eagerly by XLA, numpy arrays for its refs."""
    bf = jnp.bfloat16
    N, H = x.shape
    v3 = lambda a: np.asarray(a, bf)[None, None]
    w3 = lambda k: np.asarray(p[k][0])[None]
    o = np.zeros((N, 1, H), bf)
    j_fused._o_mlp_kernel(None, np.asarray(attn, bf)[:, None], np.asarray(x, bf)[:, None],
                          w3("wo"), v3(p["wo"][1]), v3(p["n2"]), w3("wg"), v3(p["wg"][1]),
                          w3("wu"), v3(p["wu"][1]), w3("wd"), v3(p["wd"][1]), o, eps=eps)
    return np.asarray(o, np.float32)[:, 0]


@pytest.mark.parametrize("N", [1, 10, 19])
def test_split_k_order_stays_within_the_card_tolerance(N):
    rng = np.random.default_rng(100 + N)
    H, I, Hq, eps = 1024, 4096, 16, 1e-6
    p = _wm_layer(rng, H, I, Hq)
    x = _bf(rng.normal(size=(N, H)))
    attn = _bf(rng.normal(size=(N, Hq * D)))
    plan = t_fused.o_mlp_plan(N, Hq * D, H, I)
    assert all(v["splits"] > 1 for v in plan["launches"].values())  # the order under test
    ref = _pallas_body(attn, x, p, eps)
    emu = _emulate_o_mlp(attn, x, p, plan, eps)
    err = np.abs(emu - ref).max() / np.abs(ref).max()
    moved = float(np.mean(emu != ref))
    print(f"N={N}: max|d|/max|ref| = {err:.3g}, bf16 outputs moved = {moved:.4f}")
    assert err <= FUSED_RTOL
    assert moved <= MOVED_SHARE_MAX


# ------------------------------------------------------------ launch plans
# (HqD, H, I): the WM (libero), Qwen2.5-0.5B's widths, the tiny preset's WM
# and the card tests' small grid
WIDTHS = {"wm": (1024, 1024, 4096), "qwen": (896, 896, 4864), "tiny": (64, 64, 128),
          "test_grid": (128, 128, 256)}
TOKENS = [1, 7, 8, 9, 10, 16, 17, 19, 32, 33, 64, 65, 128, 640, 896]


@pytest.mark.parametrize("widths", sorted(WIDTHS))
def test_o_mlp_plan_covers_every_index_once(widths):
    HqD, H, I = WIDTHS[widths]
    for sms in (132, 114):
        for N in TOKENS:
            plan = t_fused.o_mlp_plan(N, HqD, H, I, sms)
            tile, groups = plan["token_tile"], plan["token_groups"]
            assert tile in t_fused.TOKEN_TILES and tile == min(
                [t for t in t_fused.TOKEN_TILES if N <= t] or [t_fused.TOKEN_TILES[-1]])
            tok = np.zeros(N, int)
            for z in range(groups):  # the kernel's tokens z * tile + r, r < tile, kept < N
                r = np.arange(tile) + z * tile
                np.add.at(tok, r[r < N], 1)
            assert (tok == 1).all()
            for name, k, cols in (("o_proj", HqD, H), ("gate_up", H, I), ("down", I, H)):
                lp = plan["launches"][name]
                tiles, splits, gz = lp["grid"]
                assert (lp["k"], lp["cols"], gz, splits) == (k, cols, groups, lp["splits"])
                kcount = np.zeros(k, int)
                for sp in range(splits):  # chunks sp * chunks + c, rows of 64
                    for c in range(lp["chunks"]):
                        kcount[(sp * lp["chunks"] + c) * 64:(sp * lp["chunks"] + c + 1) * 64] += 1
                assert (kcount == 1).all(), (widths, N, name)
                ccount = np.zeros(cols, int)
                for x in range(tiles):
                    ccount[x * 64:(x + 1) * 64] += 1
                assert (ccount == 1).all()
                assert tiles * splits * gz <= sms or splits == 1
                assert 1 <= splits <= t_fused.MAX_SPLITS


# --------------------------------------------------------------- refusals
def test_changed_wrappers_refuse_on_the_cpu():
    q = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_attn.flash_fwd(q, q, q)
    x = torch.zeros(1, 1, 64, dtype=torch.bfloat16)
    w = torch.zeros(64, 64, dtype=torch.int8)
    s = torch.zeros(64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_fused.fused_o_mlp_kernel(x, x, w, s, s, w, s, w, s, w, s, eps=1e-6)
    with pytest.raises(ValueError, match="unknown fused decode impl"):
        t_fused.fused_o_mlp(x, x, w, s, s, w, s, w, s, w, s, eps=1e-6, impl="cuda")
    with pytest.raises(ValueError, match="unknown attention impl"):
        t_attn.attention(q, q, q, impl="cuda")
    # the front ends run the twins for CPU tensors, and launch nothing
    before = (t_attn.launches, t_fused.o_mlp_launches)
    t_attn.attention(q, q, q, causal=True)
    t_fused.fused_o_mlp(x, x, w, s, s, w, s, w, s, w, s, eps=1e-6)
    assert (t_attn.launches, t_fused.o_mlp_launches) == before
