"""The port's int8-weight WM decode route (kernels #8, #9) on the CPU.

The plain twins in `vla_rft_tpu_torch/ops/fused_decode_layer.py`, which the
port runs for CPU tensors and holds the CUDA kernels to on the card, and the
modules around them are held to the JAX package, with inputs made by numpy
from fixed seeds:

* the #8 / #9 twins against the `fused_rmsnorm_qkv` / `fused_o_mlp`
  Pallas kernel bodies run eagerly by XLA, bit for bit, and against the
  kernels in interpret mode (stacked weights, a middle layer), at the sizes
  of tests/test_wm_hd_layout.py (H 128, I 256, 2/2 heads of 64) and with
  GQA 4/2: bf16 outputs within 2^-6 max|ref|, int8 k/v within one quantum
  (two where the scales are an ulp apart) on at most 10 % of entries,
  scales within one bf16 ulp (2^-7 relative).  Interpret mode keeps the
  bf16 intermediates in f32, so roundings move: 0.0094 of max|ref| and
  5.6-8.0 % of the int8 entries one quantum apart, measured.  The
  bit-for-bit check against the kernel bodies is the one that pins the
  twins' rounding;
* `quantize_decoder_params` against the reference's: int8 kernels and bf16
  scales bit-equal;
* `decode_step_fused` (twin route) against the reference's unfused int8
  path (`wm.apply` on the quantised tree) from the same cache, with and
  without a shared prefix: cache writes within one quantum / one bf16 ulp,
  logits atol 0.25 / rtol 0.1 with argmax agreement >= 0.75
  (tests/test_wm_hd_layout.py::test_decode_step_fused_parity), and within
  atol 1e-2 of the port's own unfused int8 route (the same arithmetic in
  the same framework; what differs is the order of f32 sums);
* a greedy int8-weight `generate_sequences` gives JAX's tokens.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kernel_mode import INTERPRET
from vla_rft_tpu.models import transformer as j_tf
from vla_rft_tpu.ops import fused_decode_layer as j_fused
from vla_rft_tpu.workers import wm_rollout as j_roll
from vla_rft_tpu_torch.convert import flax_to_torch
from vla_rft_tpu_torch.models import transformer as t_tf
from vla_rft_tpu_torch.ops import fused_decode_layer as t_fused
from vla_rft_tpu_torch.workers import wm_rollout as t_roll

D = 64
BF16_REL = 2.0 ** -7
# the Pallas kernels in interpret mode differ from their own bodies run
# eagerly by XLA (which the twins equal bit for bit) in about half of the
# bf16 outputs, by up to 0.0094 of max|ref| (measured): the bound is 2^-6
INTERPRET_REL = 2.0 ** -6


def _bf(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _layer_inputs(rng, L, H, I, Hq, Hkv):
    """Stacked int8 weights (L, in, out), bf16 scales (L, out) and norm
    weights (L, H), as numpy (bf16 values held in f32)."""
    def w(k_in, k_out, scale):
        return (rng.integers(-127, 128, (L, k_in, k_out)).astype(np.int8),
                _bf(rng.uniform(0.5, 1.5, (L, k_out)) * scale / np.sqrt(k_in)))

    HqD, KD = Hq * D, Hkv * D
    p = {"wq": w(H, HqD, 0.02), "wk": w(H, KD, 0.02), "wv": w(H, KD, 0.02),
         "wo": w(HqD, H, 0.02), "wg": w(H, I, 0.02), "wu": w(H, I, 0.02), "wd": w(I, H, 0.02)}
    p["n1"] = _bf(1.0 + 0.1 * rng.normal(size=(L, H)))
    p["n2"] = _bf(1.0 + 0.1 * rng.normal(size=(L, H)))
    return p


def _t(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _bf16_err(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _int8_close(got, ref, sc_got, sc_ref):
    """k/v within one quantum where the two scales agree, two where they
    differ by one bf16 ulp (up to 127 * 2^-7 of a quantum moves with it),
    on at most 10 % of entries (interpret mode: 5.6-8.0 % measured)."""
    d = np.abs(np.asarray(got, np.int32) - np.asarray(ref, np.int32))
    B, Sq, W = d.shape
    Hkv = sc_ref.shape[1]
    flip = np.repeat((sc_got != sc_ref).transpose(0, 2, 1), W // Hkv, axis=2)
    return bool((d <= np.where(flip, 2, 1)).all() and (d > 0).mean() <= 0.10)


def _kernel_bodies(p, li, x, attn, cos, sins, Hq, Hkv, eps):
    """The Pallas kernel bodies `_qkv_kernel` / `_o_mlp_kernel` evaluated
    eagerly by XLA, with numpy arrays standing in for the refs."""
    bf = jnp.bfloat16
    B, Sq, H = x.shape
    v3 = lambda a: np.asarray(a[li], bf)[None, None]  # a _v3-lifted layer vector
    w3 = lambda k: np.asarray(p[k][0][li])[None]
    outs = [np.zeros((B, Sq, Hq * D), bf), np.zeros((B, Sq, Hkv * D), np.int8),
            np.zeros((B, Sq, Hkv * D), np.int8), np.zeros((B, Hkv, Sq), bf),
            np.zeros((B, Hkv, Sq), bf)]
    j_fused._qkv_kernel(None, np.asarray(cos), np.asarray(sins), np.asarray(x, bf), v3(p["n1"]),
                        w3("wq"), v3(p["wq"][1]), w3("wk"), v3(p["wk"][1]), w3("wv"),
                        v3(p["wv"][1]), *outs, eps=eps, hq=Hq, hkv=Hkv, d=D)
    o = np.zeros((B, Sq, H), bf)
    j_fused._o_mlp_kernel(None, np.asarray(attn, bf), np.asarray(x, bf), w3("wo"), v3(p["wo"][1]),
                          v3(p["n2"]), w3("wg"), v3(p["wg"][1]), w3("wu"), v3(p["wu"][1]),
                          w3("wd"), v3(p["wd"][1]), o, eps=eps)
    return [np.asarray(a, np.float32) if a.dtype == bf else a for a in outs + [o]]


FUSED_CASES = [
    # (B, Sq, Hq, Hkv): one-token decode, the 7-token action chunk, GQA
    (4, 1, 2, 2), (3, 7, 2, 2), (2, 3, 4, 2),
]


@pytest.mark.parametrize("B,Sq,Hq,Hkv", FUSED_CASES)
def test_fused_twins_match_the_reference_kernels(B, Sq, Hq, Hkv):
    rng = np.random.default_rng(B * 10 + Sq)
    L, H, I, li, eps = 3, 128, 256, 1, 1e-6
    p = _layer_inputs(rng, L, H, I, Hq, Hkv)
    x = _bf(rng.normal(size=(B, Sq, H)))
    attn = _bf(rng.normal(size=(B, Sq, Hq * D)))
    pos = np.arange(Sq)[None] + rng.integers(0, 200, (B, 1))
    j_cos, j_sins = j_fused.rope_tables(jnp.asarray(pos, jnp.int32), 10000.0, Hq, D)
    t_cos, t_sins = t_fused.rope_tables(torch.from_numpy(pos).int(), 10000.0, Hq, D)
    # cos/sin of XLA and PyTorch differ in the last f32 bit; the kernels
    # below read the same tables
    np.testing.assert_allclose(t_cos.numpy(), np.asarray(j_cos), atol=1e-6)
    np.testing.assert_allclose(t_sins.numpy(), np.asarray(j_sins), atol=1e-6)
    cos, sins = torch.tensor(np.asarray(j_cos)), torch.tensor(np.asarray(j_sins))

    tw = {k: (torch.from_numpy(v[0][li]), _t(v[1][li])) for k, v in p.items() if k.startswith("w")}
    got = t_fused.fused_rmsnorm_qkv(
        _t(x), cos, sins, _t(p["n1"][li]), *tw["wq"], *tw["wk"], *tw["wv"], num_heads=Hq,
        num_kv_heads=Hkv, head_dim=D, eps=eps)
    got_o = t_fused.fused_o_mlp(_t(attn), _t(x), *tw["wo"], _t(p["n2"][li]), *tw["wg"],
                                *tw["wu"], *tw["wd"], eps=eps)
    assert got[0].shape == (B, Sq, Hq * D) and got[3].shape == (B, Hkv, Sq)
    assert got_o.dtype == torch.bfloat16 and got_o.shape == (B, Sq, H)
    mine = [_np(g) for g in got] + [_np(got_o)]

    # (a) the kernels' own arithmetic, run eagerly: bit for bit
    for name, a, b in zip(("q", "k8", "v8", "ks", "vs", "o"), mine,
                          _kernel_bodies(p, li, x, attn, j_cos, j_sins, Hq, Hkv, eps)):
        np.testing.assert_array_equal(a, b, err_msg=name)

    # (b) the Pallas kernels in interpret mode
    jw = {k: (jnp.asarray(v[0]), jnp.asarray(v[1], jnp.bfloat16)) for k, v in p.items()
          if k.startswith("w")}
    ref = j_fused.fused_rmsnorm_qkv(
        jnp.asarray(x, jnp.bfloat16), j_cos, j_sins, li, jnp.asarray(p["n1"], jnp.bfloat16),
        *jw["wq"], *jw["wk"], *jw["wv"], num_heads=Hq, num_kv_heads=Hkv, head_dim=D, eps=eps,
        interpret=INTERPRET)
    ref_o = j_fused.fused_o_mlp(
        jnp.asarray(attn, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16), li, *jw["wo"],
        jnp.asarray(p["n2"], jnp.bfloat16), *jw["wg"], *jw["wu"], *jw["wd"], eps=eps,
        interpret=INTERPRET)
    ref = [np.asarray(r, np.float32) if r.dtype == jnp.bfloat16 else np.asarray(r)
           for r in list(ref) + [ref_o]]
    assert _bf16_err(mine[0], ref[0]) <= INTERPRET_REL, "q"
    assert _bf16_err(mine[5], ref[5]) <= INTERPRET_REL, "o"
    for i in (3, 4):  # scales within one bf16 ulp
        assert (np.abs(mine[i] - ref[i]) <= BF16_REL * np.abs(ref[i])).all()
    assert _int8_close(mine[1], ref[1], mine[3], ref[3]), "k8"
    assert _int8_close(mine[2], ref[2], mine[4], ref[4]), "v8"


def test_twin_writes_into_cache_views():
    """`out=` views of a layer's cache get what the twin returns."""
    rng = np.random.default_rng(5)
    B, Sq, H, Hkv, S, w0 = 2, 3, 128, 2, 16, 5
    p = _layer_inputs(rng, 1, H, 256, 2, Hkv)
    x = _t(rng.normal(size=(B, Sq, H)))
    cos, sins = t_fused.rope_tables(torch.arange(Sq)[None].expand(B, Sq) + w0, 1e4, 2, D)
    w = {k: (torch.from_numpy(v[0][0]), _t(v[1][0])) for k, v in p.items() if k.startswith("w")}
    ck = torch.zeros(B, S, Hkv * D, dtype=torch.int8)
    cv = torch.zeros_like(ck)
    sk = torch.ones(B, Hkv, S, dtype=torch.bfloat16)
    sv = torch.ones_like(sk)
    args = (x, cos, sins, _t(p["n1"][0]), *w["wq"], *w["wk"], *w["wv"])
    kw = dict(num_heads=2, num_kv_heads=Hkv, head_dim=D, eps=1e-6)
    _, k8, v8, ks, vs = t_fused.fused_rmsnorm_qkv(*args, **kw)
    t_fused.fused_rmsnorm_qkv(*args, **kw, out=(ck[:, w0:w0 + Sq], cv[:, w0:w0 + Sq],
                                                sk[:, :, w0:w0 + Sq], sv[:, :, w0:w0 + Sq]))
    assert torch.equal(ck[:, w0:w0 + Sq], k8) and torch.equal(cv[:, w0:w0 + Sq], v8)
    assert torch.equal(sk[:, :, w0:w0 + Sq], ks) and torch.equal(sv[:, :, w0:w0 + Sq], vs)
    assert not ck[:, :w0].any() and bool((sk[:, :, w0 + Sq:] == 1).all())


# ------------------------------------------------------- decoder-level checks
CFG = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=3, num_heads=2,
           num_kv_heads=2, kv_cache_dtype="int8", kv_layout="hd")


def _random_tree(module, seed):
    shapes = jax.eval_shape(lambda r: module.init(r, jnp.zeros((1, 4), jnp.int32)),
                            jax.random.key(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):  # norm weights near one, everything else N(0, 0.05)
        one = str(getattr(path[-1], "key", path[-1])) == "weight"
        return jnp.asarray(rng.normal(scale=0.05, size=s.shape) + one, jnp.bfloat16)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def int8_pair():
    """The reference's bf16 WM params and int8 tree, the port's bf16 decoder
    state and its int8 decoder quantised by the port."""
    jcfg = j_tf.TransformerConfig(**CFG)
    params = _random_tree(j_tf.Decoder(jcfg), 0)
    qparams = j_tf.quantize_decoder_params(params, jcfg)
    jm = j_tf.Decoder(dataclasses.replace(jcfg, weights_int8=True))
    sd = flax_to_torch(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params), "wm")
    sd = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    tcfg = t_tf.TransformerConfig(weights_int8=True, **CFG)
    tm = t_tf.Decoder(tcfg).eval()
    tm.load_state_dict(t_tf.quantize_decoder_params(sd, tcfg), strict=True)
    return dict(jm=jm, params=params, qparams=qparams, tm=tm, sd=sd)


def test_quantize_decoder_params_bit_equal_to_jax(int8_pair):
    q = int8_pair["qparams"]["params"]
    tsd = int8_pair["tm"].state_dict()
    L = CFG["num_layers"]
    for mod in ("q_proj", "k_proj", "v_proj", "o_proj"):
        jk = np.asarray(q["layers"]["self_attn"][mod]["kernel"])
        js = np.asarray(q["layers"]["self_attn"][mod]["scale"], np.float32)
        for i in range(L):
            assert np.array_equal(tsd[f"layers.{i}.self_attn.{mod}.kernel"].numpy(), jk[i]), mod
            assert np.array_equal(tsd[f"layers.{i}.self_attn.{mod}.scale"].float().numpy(), js[i])
    for mod in ("gate_proj", "up_proj", "down_proj"):
        for i in range(L):
            assert np.array_equal(tsd[f"layers.{i}.mlp.{mod}.kernel"].numpy(),
                                  np.asarray(q["layers"]["mlp"][mod]["kernel"])[i]), mod
            assert np.array_equal(tsd[f"layers.{i}.mlp.{mod}.scale"].float().numpy(),
                                  np.asarray(q["layers"]["mlp"][mod]["scale"], np.float32)[i])
    assert np.array_equal(tsd["lm_head.kernel"].numpy(), np.asarray(q["lm_head"]["kernel"]))
    assert np.array_equal(tsd["lm_head.scale"].float().numpy(),
                          np.asarray(q["lm_head"]["scale"], np.float32))
    assert tsd["lm_head.kernel"].dtype == torch.int8 and tsd["lm_head.scale"].dtype == torch.bfloat16


@pytest.mark.parametrize("shared", [False, True])
def test_decode_step_fused_matches_reference_int8_path(int8_pair, shared):
    jm, qparams, tm = int8_pair["jm"], int8_pair["qparams"], int8_pair["tm"]
    rng = np.random.default_rng(1)
    B, P = 4, 24
    prompt = jnp.asarray(rng.integers(0, 500, (B, P)), jnp.int32)
    jkw, tkw = {}, {}
    if shared:
        P0 = 16
        sh = jm.init_cache(2, P0)
        _, _, sh = jm.apply(qparams, prompt[::2, :P0], cache=sh, cache_index=0,
                            logits_last_only=True)
        pm = jnp.asarray([0, 0, 1, 1], jnp.int32)
        cache = jm.init_cache(B, 40)
        _, _, cache = jm.apply(qparams, prompt[:, P0:], cache=cache, cache_index=P0,
                               kv_lens=jnp.full((B,), P, jnp.int32), logits_last_only=True,
                               shared_cache=sh, shared_len=P0, prefix_map=pm)
        jkw = dict(shared_cache=sh, shared_len=P0, prefix_map=pm)
        tkw = dict(shared_cache=tuple(torch.from_numpy(np.asarray(a, np.float32)).to(
            torch.int8 if a.dtype == jnp.int8 else torch.bfloat16) for a in sh),
            shared_len=P0, prefix_map=torch.tensor([0, 0, 1, 1]))
    else:
        cache = jm.init_cache(B, 40)
        _, _, cache = jm.apply(qparams, prompt, cache=cache, cache_index=0,
                               logits_last_only=True)
    tok = rng.integers(0, 500, (B, 1))
    ref_logits, _, ref_cache = jax.jit(lambda p, t, c: jm.apply(p, t, cache=c, cache_index=P,
                                                                **jkw))(
        qparams, jnp.asarray(tok, jnp.int32), cache)

    def t_cache():
        return tuple(torch.from_numpy(np.asarray(a, np.float32)).to(
            torch.int8 if a.dtype == jnp.int8 else torch.bfloat16) for a in cache)

    fused_cache, mod_cache = t_cache(), t_cache()
    out_logits, _ = t_tf.decode_step_fused(tm, torch.from_numpy(tok), fused_cache, P, **tkw)
    with torch.no_grad():
        mod_logits, _ = tm(torch.from_numpy(tok), cache=mod_cache, cache_index=P, **tkw)

    # layer 0's writes at the written position (deeper layers drift apart
    # with their inputs, as in the reference's own parity test)
    own = P - tkw.get("shared_len", 0)
    for a, b in zip(ref_cache, fused_cache):
        ax = 1 if a.dtype == jnp.int8 else 2  # the position axis of a layer's cache
        av = np.take(np.asarray(a[0], np.float32), own, axis=ax)
        bv = np.take(_np(b[0]), own, axis=ax)
        if a.dtype == jnp.int8:
            assert np.abs(av - bv).max() <= 1 and (av != bv).mean() < 0.25
        else:
            assert (np.abs(av - bv) <= BF16_REL * np.abs(av)).all()
    for a, b in zip(mod_cache, fused_cache):  # the port's two routes write the same cache
        assert torch.equal(a, b)
    rl = np.asarray(ref_logits[:, -1], np.float32)
    ol = out_logits[:, -1].numpy()
    assert (rl.argmax(-1) == ol.argmax(-1)).mean() >= 0.75
    np.testing.assert_allclose(ol, rl, atol=0.25, rtol=0.1)
    np.testing.assert_allclose(ol, mod_logits[:, -1].numpy(), atol=1e-2, rtol=0)


def test_greedy_int8_weight_rollout_equals_jax(int8_pair):
    """In f32 compute (as tests/test_torch_wm.py's greedy rollouts): in bf16
    the two frameworks' matmuls round apart and a near-tie argmax flips
    about 1 token in 100."""
    f32 = dict(CFG, dtype=jnp.float32, param_dtype=jnp.float32)
    jcfg = j_tf.TransformerConfig(**f32)
    params = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), int8_pair["params"])
    qparams = j_tf.quantize_decoder_params(params, jcfg)
    jm = j_tf.Decoder(dataclasses.replace(jcfg, weights_int8=True, attn_impl="xla"))
    tcfg = t_tf.TransformerConfig(weights_int8=True, dtype=torch.float32,
                                  param_dtype=torch.float32, **CFG)
    tm = t_tf.Decoder(tcfg).eval()
    sd = {k: v.float() for k, v in int8_pair["sd"].items()}
    tm.load_state_dict(t_tf.quantize_decoder_params(sd, tcfg), strict=True)
    F, V, A, P0 = 2, 5, 7, 20
    P = P0 + A
    roll = dict(prompt_length=P, response_length=F * (V + A), num_frames=F,
                interact_max_tokens=V, action_dim=A, do_sample=False, cache_segments=2)
    rng = np.random.default_rng(7)
    heads = rng.integers(0, 500, (2, P0))
    pm = np.repeat(np.arange(2), 3).astype(np.int32)
    actions = rng.integers(0, 500, (6, F + 1, A))
    ids = actions[:, 0]
    j_out = jax.jit(lambda p, i, a: j_roll.generate_sequences(
        jm, p, jax.random.key(0), i, a, j_roll.WMRolloutConfig(**roll),
        shared_prefix=jnp.asarray(heads, jnp.int32), prefix_map=jnp.asarray(pm), prefix_run=3))(
        qparams, jnp.asarray(ids, jnp.int32), jnp.asarray(actions, jnp.int32))
    t_out = t_roll.generate_sequences(tm, torch.Generator().manual_seed(0), torch.from_numpy(ids),
                                      torch.from_numpy(actions), t_roll.WMRolloutConfig(**roll),
                                      shared_prefix=torch.from_numpy(heads),
                                      prefix_map=torch.from_numpy(pm))
    assert t_out.dtype == torch.int32
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
