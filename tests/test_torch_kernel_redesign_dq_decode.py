"""What the CPU can hold of the redesigned kernels #2 (flash backward dQ)
and the split-cache decode kernel behind #4-#7, which run only on the card.

* #2's launch plan (`dq_plan`): its grid and the order of its query tiles
  cover every (query tile, query head, batch row) exactly once, each block's
  key-tile range (as the kernel computes it) holds every key some query of
  its tile may see and no tile without one, and under causal masking the
  heaviest query tiles come first.
* The decode kernel's launch plan (`decode_plan`) with the kernel's own
  device-side chunk search and key split, mirrored here: the chunks of rows
  that share a prefix fit the slots, and their tiles (prefix tiles shared by
  a chunk's rows, then each row's own tiles) split over the ranks cover
  every (row, kv head, valid key) exactly once, the prefix read once per
  chunk.
* A torch model of the kernel's arithmetic on that plan: per block, four
  warps each running an online softmax (2^x with the -80 floor, P as two
  bf16 terms) over their 32 keys of each tile, merged in warp order, then
  the cluster's ranks merged in rank order, agrees with the twins
  `decode_shared_plain` / `decode_plain` within the card's decode tolerance,
  on rows with no valid key and windows cut short too.
* The CPU-side refusals of the changed wrappers still raise.
"""
from collections import Counter

import numpy as np
import pytest
import torch

from vla_rft_tpu_torch.ops import attention as t_attn
from vla_rft_tpu_torch.ops import decode_attention as t_heads
from vla_rft_tpu_torch.ops import decode_attention_hd as t_dec

DEC_RTOL, DEC_ATOL = 2.0 ** -7, 2e-3  # the card's decode tolerance (chip_smoke.py)
TK = t_dec.KEY_TILE  # keys of a decode tile
WARPS = 4  # the decode kernel's warps per block, each with TK / WARPS keys of a tile
LOG2E = 1.4426950408889634
EXP2_FLOOR = -80.0 * LOG2E


# ---------------------------------------------------------------- #2's plan
DQ_SHAPES = {
    # (B, S, Hq, Hkv): the WM-SFT step, Qwen2.5-0.5B at the VLA-adapter step,
    # the tiny preset's Qwen, the card tests' cases
    "wm_sft": (4, 1663, 16, 16),
    "qwen_vla_adapter": (16, 352, 14, 2),
    "tiny": (2, 30, 4, 2),
    "card_gqa_ragged": (2, 50, 14, 2),
    "card_d128": (2, 130, 14, 2),
}


def _key_tiles(q0, q_rows, kv_start, kv_len, q_off, causal):
    """The kernel's key tiles of a query tile: [kv_start / 64, the end)."""
    t_begin, t_end = kv_start // 64, -(-kv_len // 64)
    if causal:
        last_q = q_off + q0 + q_rows - 1
        t_end = min(t_end, 0 if last_q < 0 else last_q // 64 + 1)
    return range(t_begin, max(t_begin, t_end))


@pytest.mark.parametrize("shape", sorted(DQ_SHAPES))
def test_dq_plan_covers_every_tile_once_heavy_first(shape):
    B, S, Hq, Hkv = DQ_SHAPES[shape]
    for causal in (False, True):
        for Sk, q_off, kv_start, kv_len in ((S, 0, 0, S), (S, 5, 0, S - 3),
                                            (S + 40, 40, 7, S + 40)):
            plan = t_attn.dq_plan(B, S, Hq, causal)
            n_qt = plan["query_tiles"]
            assert plan["grid"] == (Hq, B, n_qt) and n_qt * 64 >= S > (n_qt - 1) * 64
            order = plan["tile_order"]
            assert sorted(order) == list(range(n_qt))  # every (tile, head, row) once
            # grid order: x (head) fastest, then y (row), then z (tile)
            seen = {(order[z], h, b) for z in range(n_qt) for b in range(B) for h in range(Hq)}
            assert len(seen) == n_qt * Hq * B
            pos = np.arange(Sk)
            work = []
            for qt in order:
                q0, q_rows = qt * 64, min(64, S - qt * 64)
                qp = q_off + q0 + np.arange(q_rows)[:, None]
                valid = (pos >= kv_start) & (pos < kv_len) & ((pos <= qp) | (not causal))
                need = set(np.unique(np.nonzero(valid.any(axis=0))[0] // 64).tolist())
                tiles = _key_tiles(q0, q_rows, kv_start, kv_len, q_off, causal)
                assert need <= set(tiles)  # every key a query of the tile may see
                assert all(t in need for t in tiles)  # and no tile without one
                work.append(len(tiles))
            if causal:  # the last tiles see the most keys: they run first
                assert work == sorted(work, reverse=True)


# ---------------------------------------------------- the decode kernel's plan
def _chunks(pm, n_prefix, chunk_rows, shared, B):
    """The kernel's chunk search: each row's index inside its prefix group
    (rows in order), then the groups' chunks of `chunk_rows` rows in group
    order; without a shared prefix a chunk is one row.  [(u, rows)]."""
    if not shared:
        return [(0, [b]) for b in range(B)]
    rank, cnt = [0] * B, [0] * n_prefix
    for b in range(B):
        if 0 <= pm[b] < n_prefix:
            rank[b], cnt[pm[b]] = cnt[pm[b]], cnt[pm[b]] + 1
    return [(u, [b for b in range(B) if pm[b] == u and rank[b] // chunk_rows == j])
            for u in range(n_prefix) for j in range(-(-cnt[u] // chunk_rows))]


def _blocks(plan, pm, rows_args, Sq, Sr, shared_len, shared, n_prefix, B):
    """Every block of the kernel's grid that has a chunk, one kv head's worth
    (the heads are the grid's y axis): its chunk's rows, each row's own
    window, the prefix union window and the rank's tiles [(c, j0)], c = -1
    for a prefix tile."""
    kv_lens, q_offset, kv_starts = rows_args
    chunks = _chunks(pm, n_prefix, plan["chunk_rows"], shared, B)
    assert len(chunks) <= plan["slots"]
    base = shared_len if shared else 0
    out = []
    for slot, (u, rows) in enumerate(chunks):
        assert 1 <= len(rows) <= plan["chunk_rows"]
        own, p_lo, p_hi = [], 1 << 30, 0
        for b in rows:
            ks, hi = max(kv_starts[b], 0), min(kv_lens[b], q_offset[b] + Sq)
            if shared:
                lo = min(ks, shared_len)
                sh_hi = max(lo, min(shared_len, hi))
                if sh_hi > lo:
                    p_lo, p_hi = min(p_lo, lo), max(p_hi, sh_hi)
            o_lo = min(max(ks - base, 0), Sr)
            own.append((o_lo, max(o_lo, min(Sr, hi - base))))
        tiles = []
        if p_hi > p_lo:
            tiles += [(-1, t * TK) for t in range(p_lo // TK, -(-p_hi // TK))]
        for c, (o_lo, o_hi) in enumerate(own):
            if o_hi > o_lo:
                tiles += [(c, t * TK) for t in range(o_lo // TK, -(-o_hi // TK))]
        T, R = len(tiles), plan["splits"]
        for r in range(R):
            out.append({"slot": slot, "rank": r, "u": u, "rows": rows, "own": own,
                        "p": (p_lo, p_hi) if p_hi > p_lo else (0, 0),
                        "tiles": tiles[T * r // R:T * (r + 1) // R]})
    return out


def _row_args(B, rng, Sq, shared_len, Sr, shared):
    """Random per-row windows: ragged lengths, cut starts, a row with no
    valid key, a row whose window keeps one key."""
    own = rng.integers(Sq, Sr + 1, B)
    own[0] = Sq  # only the current block
    kv_lens = (shared_len if shared else 0) + own
    kv_starts = np.minimum(rng.integers(0, 12, B), kv_lens - 1)
    if B > 4:
        kv_starts[2] = kv_lens[2]  # no valid key
        kv_starts[3] = kv_lens[3] - 1  # one key
        if shared:
            kv_starts[4] = shared_len - 1  # one key of the prefix
    return [int(x) for x in kv_lens], [int(x) for x in kv_lens - Sq], [int(x) for x in kv_starts]


DECODE_SHAPES = {
    # (B, Sq, G, Hkv, Sr, shared_len, prefix_map or None): the WM's call at
    # B = 10 (uniform and per-row maps), at the configured 128 rows (a
    # 64-sequence step's policy rows then its gt rows, 16 prefixes), a group
    # larger than a chunk, Qwen2.5-0.5B's GQA 14/2 at Sq 7, the tiny preset,
    # the card tests' shapes
    "wm_b10": (10, 1, 1, 16, 384, 1088, [0] * 5 + [1] * 5),
    "wm_b10_per_row": (10, 1, 1, 16, 384, 1088, [0, 1, 1, 0, 1, 0, 0, 1, 0, 1]),
    "wm_b128": (128, 1, 1, 16, 384, 1088, list(np.tile(np.repeat(np.arange(16), 4), 2))),
    "wm_group_of_40": (40, 1, 1, 16, 200, 300, [0] * 40),
    "wm_plain_b10": (10, 1, 1, 16, 1408, 0, None),
    "qwen_gqa_sq7": (4, 7, 7, 2, 256, 1088, [0, 0, 1, 1]),
    "qwen_gqa_plain": (4, 1, 7, 2, 256, 0, None),
    "tiny": (4, 1, 1, 4, 40, 60, [0, 0, 1, 1]),
    "card_sq7": (6, 7, 1, 16, 200, 250, [1, 0, 0, 1, 1, 0]),
    "card_g2_sq3": (6, 3, 2, 8, 200, 250, [0, 0, 0, 1, 1, 1]),
    "card_g4_sq5": (6, 5, 4, 2, 200, 250, [0, 0, 0, 1, 1, 1]),  # 20 query rows a row
}


@pytest.mark.parametrize("shape", sorted(DECODE_SHAPES))
def test_decode_plan_covers_every_key_once(shape):
    B, Sq, G, Hkv, Sr, shared_len, pm = DECODE_SHAPES[shape]
    shared = pm is not None
    n_prefix = max(pm) + 1 if shared else 0
    rng = np.random.default_rng(B + Sq)
    for sms in (132, 114):
        plan = t_dec.decode_plan(B, Sq, G, Hkv, Sr, shared, n_prefix, shared_len, sms)
        R, gsq = plan["splits"], G * Sq
        assert plan["grid"] == (R, Hkv, plan["slots"]) and 1 <= R <= t_dec.MAX_SPLITS
        assert plan["chunk_rows"] * gsq <= min(16 * plan["m_tiles"], t_dec.MAX_QUERY_ROWS)
        assert plan["slots"] <= B
        if shared and gsq == 1:
            assert plan["chunk_rows"] == 16  # a prefix group of up to 16 rows reads it once
        rows_args = _row_args(B, rng, Sq, shared_len, Sr, shared)
        blocks = _blocks(plan, pm, rows_args, Sq, Sr, shared_len, shared, n_prefix, B)
        kv_lens, q_offset, kv_starts = rows_args
        base = shared_len if shared else 0
        chunk_of = {}
        for blk in blocks:
            for b in blk["rows"]:
                assert chunk_of.setdefault(b, blk["slot"]) == blk["slot"]  # one chunk a row
        assert sorted(chunk_of) == list(range(B))
        for b in range(B):
            # the keys some query of row b may see: absolute positions
            lo, hi = max(kv_starts[b], 0), min(kv_lens[b], q_offset[b] + Sq)
            seen = np.zeros(base + Sr, int)
            for blk in (x for x in blocks if b in x["rows"]):
                c = blk["rows"].index(b)
                for tc, j0 in blk["tiles"]:
                    if tc < 0:  # a prefix tile: the union window is loaded
                        p = np.arange(max(j0, blk["p"][0]), min(j0 + TK, blk["p"][1]))
                        seen[p] += 1
                    elif tc == c:
                        o_lo, o_hi = blk["own"][c]
                        seen[base + np.arange(max(j0, o_lo), min(j0 + TK, o_hi))] += 1
            want = np.zeros_like(seen)
            want[max(lo, 0):max(lo, min(hi, base + Sr))] = 1
            if shared:  # a row's shared keys stop at shared_len
                want[min(shared_len, hi):base] = 0
            got = seen.copy()
            got[:base][want[:base] == 0] = 0  # other rows' prefix keys, masked for b
            assert (got == want).all(), (shape, b)
        # each prefix tile is read by one rank of its chunk, for all its rows
        reads = Counter((blk["slot"], j0) for blk in blocks for tc, j0 in blk["tiles"] if tc < 0)
        assert all(n == 1 for n in reads.values())


# ------------------------------------------------ the arithmetic of the kernel
def _dec_inputs(rng, B, Sq, G, Hkv, Sr, Sp, n_prefix, int8):
    q = torch.from_numpy(rng.standard_normal((B, Sq, Hkv * G, 64)).astype(np.float32)).bfloat16()

    def cache(rows, S):
        if int8:
            c = [torch.from_numpy(rng.integers(-127, 128, (rows, S, Hkv * 64)).astype(np.int8))
                 for _ in range(2)]
            s = tuple(torch.from_numpy((rng.random((rows, Hkv, S)) * 0.04 + 0.01)
                                       .astype(np.float32)).bfloat16() for _ in range(2))
            return c, s
        return [torch.from_numpy(rng.standard_normal((rows, S, Hkv * 64)).astype(np.float32))
                .bfloat16() for _ in range(2)], None

    own, sc = cache(B, Sr)
    shared = cache(n_prefix, Sp) if n_prefix else ((None, None), None)
    return q, own, sc, shared


def _model(q, ck, cv, sc, sck, scv, ssc, pm, rows_args, shared_len, plan):
    """The kernel's arithmetic on its plan, in torch f32 on the CPU."""
    B, Sq, Hq, D = q.shape
    Hkv = ck.shape[2] // D
    G, gsq = Hq // Hkv, Hq // Hkv * Sq
    shared = sck is not None
    Sr = ck.shape[1]
    dq = lambda c, s: t_dec.dequantize(c, s, D, torch.bfloat16).float()  # (rows, S, Hkv, D)
    k_own, v_own = dq(ck, sc[0] if sc else None), dq(cv, sc[1] if sc else None)
    if shared:
        k_sh, v_sh = dq(sck, ssc[0] if ssc else None), dq(scv, ssc[1] if ssc else None)
    kv_lens, q_offset, kv_starts = rows_args
    base = shared_len if shared else 0
    scale_log2 = D ** -0.5 * LOG2E
    n_prefix = sck.shape[0] if shared else 0
    blocks = _blocks(plan, pm, rows_args, Sq, Sr, shared_len, shared, n_prefix, B)
    out = torch.zeros(B, Sq, Hq, D)
    for slot in sorted({blk["slot"] for blk in blocks}):
        ranks = [blk for blk in blocks if blk["slot"] == slot]
        rows = ranks[0]["rows"]
        nq = len(rows) * gsq
        # query row r = c * G * Sq + gq * Sq + i, per kv head: (Hkv, nq, D)
        qr = torch.stack([q[b, i, h * G + gq].float() for b in rows for gq in range(G)
                          for i in range(Sq) for h in range(Hkv)]).view(nq, Hkv, D).transpose(0, 1)
        win = []
        for c, b in enumerate(rows):
            for gq in range(G):
                for i in range(Sq):
                    lo, hi = max(kv_starts[b], 0), min(kv_lens[b], q_offset[b] + i + 1)
                    win.append((lo, min(hi, shared_len) if shared else 0, lo - base,
                                min(hi - base, Sr), c))
        win = torch.tensor(win)
        states = []
        for blk in ranks:  # rank order
            p_lo, p_hi = blk["p"]
            warp_state = [(torch.full((Hkv, nq), -1e30), torch.zeros(Hkv, nq),
                           torch.zeros(Hkv, nq, D)) for _ in range(WARPS)]
            for tc, j0 in blk["tiles"]:
                j = torch.arange(j0, j0 + TK)
                if tc < 0:
                    src_k, src_v, row, (lo_w, hi_w) = k_sh, v_sh, blk["u"], (p_lo, p_hi)
                    ok = (j[None] >= win[:, 0:1]) & (j[None] < win[:, 1:2])
                else:
                    src_k, src_v, row = k_own, v_own, rows[tc]
                    lo_w, hi_w = blk["own"][tc]
                    ok = ((win[:, 4:5] == tc) & (j[None] >= win[:, 2:3]) & (j[None] < win[:, 3:4]))
                load = (j >= lo_w) & (j < hi_w)
                jj = j.clamp(max=src_k.shape[1] - 1)
                K = torch.where(load[:, None, None], src_k[row, jj], 0.0).transpose(0, 1)
                V = torch.where(load[:, None, None], src_v[row, jj], 0.0).transpose(0, 1)
                s = torch.einsum("hqd,hkd->hqk", qr.bfloat16().float(), K)
                for w in range(WARPS):
                    ks = slice(TK // WARPS * w, TK // WARPS * (w + 1))
                    m, l, acc = warp_state[w]
                    okw = ok[None, :, ks].expand(Hkv, -1, -1)
                    x = s[:, :, ks] * scale_log2
                    mx = torch.where(okw, x, torch.full_like(x, -1e30)).amax(-1)
                    m_new = torch.maximum(m, mx)
                    alpha = torch.exp2(torch.clamp(m - m_new, min=EXP2_FLOOR))
                    p = torch.where(okw, torch.exp2(torch.clamp(x - m_new[..., None],
                                                                min=EXP2_FLOOR)), 0.0)
                    hi_p = p.bfloat16().float()
                    lo_p = (p - hi_p).bfloat16().float()
                    acc = acc * alpha[..., None] + hi_p @ V[:, ks] + lo_p @ V[:, ks]
                    warp_state[w] = (m_new, l * alpha + p.sum(-1), acc)
            states.append(_merge(warp_state))  # the block's warps in warp order
        m, l, acc = _merge(states)  # the cluster's ranks in rank order
        o = acc / l.clamp_min(1e-30)[..., None]  # (Hkv, nq, D)
        for r in range(nq):
            c, rr = divmod(r, gsq)
            gq, i = divmod(rr, Sq)
            for h in range(Hkv):
                out[rows[c], i, h * G + gq] = o[h, r]
    return out.bfloat16()


def _merge(states):
    m = torch.stack([s[0] for s in states]).amax(0)
    l, acc = torch.zeros_like(states[0][1]), torch.zeros_like(states[0][2])
    for sm, sl, sa in states:
        f = torch.exp2(torch.clamp(sm - m, min=EXP2_FLOOR))
        l, acc = l + sl * f, acc + sa * f[..., None]
    return m, l, acc


MODEL_CASES = [
    # (name, B, Sq, G, Hkv, Sr, Sp, shared_len, prefix_map or None, int8, splits or None)
    ("wm_uniform", 10, 1, 1, 2, 100, 200, 150, [0] * 5 + [1] * 5, True, None),
    ("wm_per_row_bf16", 10, 1, 1, 2, 100, 200, 150, [0, 1, 1, 0, 1, 0, 0, 1, 0, 1], False, None),
    ("group_of_20_split3", 20, 1, 1, 1, 70, 140, 130, [0] * 20, True, 3),
    ("sq7", 6, 7, 1, 2, 90, 150, 140, [1, 0, 0, 1, 1, 0], True, 1),
    ("gqa_14_2_sq7", 4, 7, 7, 1, 80, 140, 100, [0, 0, 1, 1], True, 8),
    ("g4_sq5_three_rows_a_chunk", 6, 5, 4, 2, 100, 200, 150, [0, 0, 0, 1, 1, 1], False, None),
    ("plain_ragged", 10, 1, 1, 2, 300, 0, 0, None, True, None),
    ("plain_gqa_bf16", 4, 3, 2, 2, 150, 0, 0, None, False, 2),
]


@pytest.mark.parametrize("case", MODEL_CASES, ids=[c[0] for c in MODEL_CASES])
def test_split_and_merge_model_agrees_with_the_twins(case):
    name, B, Sq, G, Hkv, Sr, Sp, shared_len, pm, int8, splits = case
    rng = np.random.default_rng(len(name))
    shared = pm is not None
    n_prefix = max(pm) + 1 if shared else 0
    q, (ck, cv), sc, ((sck, scv), ssc) = _dec_inputs(rng, B, Sq, G, Hkv, Sr, Sp, n_prefix, int8)
    rows_args = _row_args(B, rng, Sq, shared_len, Sr, shared)
    plan = dict(t_dec.decode_plan(B, Sq, G, Hkv, Sr, shared, n_prefix, shared_len))
    if splits:
        plan["splits"] = splits
    kv_lens, q_offset, kv_starts = (torch.tensor(x) for x in rows_args)
    got = _model(q, ck, cv, sc, sck, scv, ssc, pm, rows_args, shared_len, plan)
    if shared:
        ref = t_dec.decode_shared_plain(q, ck, cv, sck, scv, torch.tensor(pm),
                                        shared_len=shared_len, kv_lens=kv_lens,
                                        q_offset=q_offset, shared_starts=kv_starts, scales=sc,
                                        shared_scales=ssc)
    else:
        ref = t_dec.decode_plain(q, ck, cv, kv_lens=kv_lens, q_offset=q_offset,
                                 kv_starts=kv_starts, scales=sc)
    d = (got.float() - ref.float()).abs()
    assert bool((d <= DEC_RTOL * ref.float().abs() + DEC_ATOL).all()), d.max().item()
    if B > 4:  # row 2 sees no key
        assert bool((got[2] == 0).all()) and bool((ref[2] == 0).all())
    assert float(ref.float().abs().max()) > 0.05  # the rest attends to something


# --------------------------------------------------------------- refusals
def test_changed_wrappers_refuse_on_the_cpu():
    q = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 8, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_attn.flash_bwd_dq(q, k, k, q, lse, lse)
    qd = torch.zeros(2, 1, 4, 64, dtype=torch.bfloat16)
    c = torch.zeros(2, 16, 4 * 64, dtype=torch.int8)
    s = torch.zeros(2, 4, 16, dtype=torch.bfloat16)
    kw = dict(kv_lens=torch.tensor([5, 6]), q_offset=torch.tensor([4, 5]), scales=(s, s))
    for mod in (t_dec, t_heads):
        with pytest.raises(ValueError, match="CUDA"):
            mod.decode_kernel(qd, c, c, **kw)
        with pytest.raises(ValueError, match="query positions"):
            mod.decode_kernel(qd.expand(2, 9, 4, 64).contiguous(), c, c, **kw)
        with pytest.raises(ValueError, match="head dim"):
            mod.decode_kernel(torch.zeros(2, 1, 4, 32, dtype=torch.bfloat16), c, c, **kw)
        with pytest.raises(ValueError, match="bf16"):
            mod.decode_kernel(qd.float(), c, c, **kw)
        with pytest.raises(ValueError, match="CUDA"):
            mod.decode_shared_kernel(qd, c, c, c, c, torch.tensor([0, 0]), shared_len=4,
                                     scales=(s, s), shared_scales=(s, s),
                                     kv_lens=kw["kv_lens"], q_offset=kw["q_offset"])
    # the front ends run the twins for CPU tensors, and launch nothing
    before = (t_attn.bwd_dq_launches, t_dec.shared_launches, t_dec.plain_launches,
              t_heads.shared_heads_launches, t_heads.heads_launches)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, k)]
    o = t_attn.attention(*leaves, causal=True)
    torch.autograd.grad(o.float().sum(), leaves)
    t_dec.decode_attention_hd(qd, c, c, **kw)
    t_dec.decode_attention_shared_hd(qd, c, c, c, c, torch.tensor([0, 1]), shared_len=4,
                                     scales=(s, s), shared_scales=(s, s),
                                     kv_lens=kw["kv_lens"] + 4, q_offset=kw["q_offset"] + 4)
    assert (t_attn.bwd_dq_launches, t_dec.shared_launches, t_dec.plain_launches,
            t_heads.shared_heads_launches, t_heads.heads_launches) == before
