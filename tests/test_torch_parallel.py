"""The port's parallel/ against the JAX package's: MeshConfig.resolve and
the FSDP rule on a grid, and, over gloo ranks on the CPU (two and four
spawned processes, started once each for this file), every Decoder
parameter's TP / FSDP placement against the JAX specs, the TP forward, the
Ulysses attention (MHA, GQA head repeat, padding) and decoder, and the
GPipe pipeline (M = P and 2P, tied head, last-only) against the JAX
package's sharded forwards on the same weights (`flax_to_torch`), within
the JAX tests' tolerances (f32), plus the Ulysses and pipeline gradients
against the sequential port's."""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from vla_rft_tpu.models.transformer import Decoder as JDecoder
from vla_rft_tpu.models.transformer import TransformerConfig as JCfg
from vla_rft_tpu.ops.attention import attention as j_attention
from vla_rft_tpu.parallel import mesh as jm
from vla_rft_tpu.parallel.pp import decoder_pp_forward as j_pp_forward
from vla_rft_tpu.parallel.tp import _decoder_tp_spec as j_tp_spec
from vla_rft_tpu.parallel.tp import shard_decoder_params_tp as j_shard_tp
from vla_rft_tpu.parallel.ulysses import ulysses_attention as j_ulysses
from vla_rft_tpu.parallel.ulysses import ulysses_pad_and_slice as j_pad
from vla_rft_tpu_torch.convert import flax_to_torch
from vla_rft_tpu_torch.parallel import distributed as pd
from vla_rft_tpu_torch.parallel import mesh as tm
from vla_rft_tpu_torch.parallel.ulysses import repeat_kv_heads, ulysses_pad_and_slice

import torch_parallel_ranks
from torch_parallel_suites import decoder as t_decoder

TP_CFG = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
              num_kv_heads=4)
TP_GQA = dict(vocab_size=96, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
              num_kv_heads=2, qkv_bias=True, tie_word_embeddings=True)
SP_CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=8,
              num_kv_heads=8)
PP_CFG = dict(vocab_size=97, hidden_size=64, intermediate_size=128, num_layers=8, num_heads=4,
              num_kv_heads=2)
PP_TIED = dict(vocab_size=53, hidden_size=32, intermediate_size=64, num_layers=4, num_heads=2,
               num_kv_heads=2, tie_word_embeddings=True)
PP_GRAD = dict(vocab_size=41, hidden_size=32, intermediate_size=64, num_layers=4, num_heads=2,
               num_kv_heads=2)
FSDP_CFG = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
                num_heads=4, num_kv_heads=4)
TOL = dict(atol=2e-5, rtol=1e-4)  # test_tp.py / test_parallel_extras.py
TOL_SP = dict(atol=3e-5, rtol=1e-4)  # test_decoder_ulysses_sp_matches_plain
TOL_PP = dict(atol=1e-4, rtol=0)  # test_pp.py
TOL_GRAD = dict(atol=2e-4, rtol=1e-3)  # test_decoder_pp_gradients_match_sequential


def _jmodel(cfg, seed, ids, **kw):
    jcfg = JCfg(dtype=jnp.float32, param_dtype=jnp.float32, attn_impl="xla", **cfg, **kw)
    model = JDecoder(jcfg)
    variables = model.init(jax.random.key(seed), jnp.asarray(ids))
    sd = flax_to_torch(jax.tree_util.tree_map(np.asarray, variables), "decoder")
    return model, variables, sd


def _ids(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _qkv(seed, B, S, H, HKV, D):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, S, H, D)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(B, S, HKV, D)) * 0.3).astype(np.float32)
    v = rng.normal(size=(B, S, HKV, D)).astype(np.float32)
    return q, k, v


JW = 4  # the JAX side's sharded axis: 4 of conftest's 8 CPU devices


def _build():
    """The JAX side (tp, sp and pp over 4 devices; TP of the GQA config
    over 2, as the port runs it) and the inputs every rank gets; both worlds
    are held to the same JAX numbers."""
    ref, inp = {}, {}
    t = lambda a: torch.from_numpy(np.asarray(a))
    ids = _ids(0, 2, 16, SP_CFG["vocab_size"])
    inp["ids"] = t(ids)

    # TP (test_tp.py's mesh: the rest of the devices on dp)
    for name, cfg, seed in (("tp", TP_CFG, 0), ("tp_gqa", TP_GQA, 1)):
        W = 2 if name == "tp_gqa" else JW
        x = _ids(seed + 10, 2, 10, cfg["vocab_size"])
        model, variables, sd = _jmodel(cfg, seed, x)
        mesh = jm.make_mesh(jm.MeshConfig(dp=8 // W, tp=W))
        tp_params = j_shard_tp(mesh, variables)
        with mesh:
            ref[f"{name}_logits"] = np.asarray(
                jax.jit(lambda p, i: model.apply(p, i))(tp_params, jnp.asarray(x))[0])
        ref[f"{name}_spec"] = {
            tuple(str(getattr(p, "key", p)) for p in path): j_tp_spec(
                tuple(str(getattr(p, "key", p)) for p in path), np.shape(leaf), W)
            for path, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]}
        inp[name] = (cfg, sd, t(x))

    # Ulysses attention: MHA, GQA (kv heads < sp: repeated), padded
    W = JW
    mesh = jm.make_mesh(jm.MeshConfig(dp=8 // W, sp=W))
    for name, (B, S, H, HKV, D), seed in (("sp_mha", (2, 32, 8, 8, 16), 0),
                                          ("sp_gqa", (2, 16, 8, 2, 8), 1),
                                          ("sp_pad", (2, 10, 8, 4, 8), 2)):
        q, k, v = _qkv(seed, B, S, H, HKV, D)
        kv_lens = np.full((B,), S, np.int32)
        if name == "sp_pad":
            (qp, pad), (kp, _), (vp, _) = j_pad(q, W), j_pad(k, W), j_pad(v, W)
            ref["sp_pad_pad"] = pad
            ref[name] = np.asarray(jax.jit(lambda a, b, c, n: j_ulysses(
                a, b, c, mesh, "sp", causal=True, kv_lens=n))(qp, kp, vp, jnp.asarray(kv_lens)))
            ref["sp_pad_plain"] = np.asarray(j_attention(q, k, v, causal=True, impl="xla"))
        else:
            ref[name] = np.asarray(jax.jit(lambda a, b, c: j_ulysses(
                a, b, c, mesh, "sp", causal=True))(q, k, v))
            ref[f"{name}_plain"] = np.asarray(j_attention(q, k, v, causal=True, impl="xla"))
        inp[name] = (t(q), t(k), t(v), t(kv_lens))

    # the Ulysses decoder (test_decoder_ulysses_sp_matches_plain)
    import dataclasses

    model, variables, sd = _jmodel(SP_CFG, 0, ids)
    sp_model = JDecoder(dataclasses.replace(model.cfg, ulysses_axis="sp"))
    B, S = ids.shape

    def fwd(params, ids, positions, kv_lens):
        return sp_model.apply(params, ids, positions=positions, kv_lens=kv_lens)[0]

    ref["sp_decoder_logits"] = np.asarray(jax.shard_map(
        fwd, mesh=mesh, in_specs=(P(), P(None, "sp"), P(None, "sp"), P()),
        out_specs=P(None, "sp"), check_vma=False)(
            variables, jnp.asarray(ids),
            jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S)),
            jnp.full((B,), S, jnp.int32)))
    inp["sp_decoder"] = (SP_CFG, sd)
    seq = t_decoder(SP_CFG, sd)
    logits, _ = seq(inp["ids"])
    (logits ** 2).sum().div(logits.numel()).backward()
    ref["sp_decoder_grads"] = {k: p.grad.clone() for k, p in seq.named_parameters()}

    # the pipeline (test_pp.py)
    pmesh = Mesh(np.array(jax.devices()[:W]), ("pp",))
    x_mb = np.asarray(jax.random.normal(jax.random.key(0), (8, 2, 16), jnp.float32))
    inp["pipe_x"] = t(x_mb)
    # (the port's M = P and M = 2P runs are both held to the reference's
    # M = P pipeline: micro-batching does not change the numbers)
    for name, cfg, (B, S), seed, last in (("pp", PP_CFG, (8, 16), 2, False),
                                          ("pp_tied_last", PP_TIED, (4, 8), 4, True)):
        x = _ids(seed, B, S, cfg["vocab_size"])
        model, variables, sd = _jmodel(cfg, seed, x)
        logits, hidden = jax.jit(lambda v, i: j_pp_forward(
            model, v, i, pmesh, n_microbatches=4, logits_last_only=last))(variables,
                                                                        jnp.asarray(x))
        ref[name] = (np.asarray(logits), np.asarray(hidden))
        with torch.no_grad():
            ref[f"{name}_plain"] = t_decoder(cfg, sd)(t(x), logits_last_only=last)[0].numpy()
        inp[name] = (cfg, sd, t(x))
    x = _ids(5, 4, 8, PP_GRAD["vocab_size"])
    model, variables, sd = _jmodel(PP_GRAD, 6, x)
    seq = t_decoder(PP_GRAD, sd)
    (seq(t(x))[0] ** 2).mean().backward()
    ref["pp_grads"] = {k: p.grad.clone() for k, p in seq.named_parameters()}
    inp["pp_grad"] = (PP_GRAD, sd, t(x))

    # FSDP: the unsharded forward on the same weights
    x = _ids(7, 2, 8, FSDP_CFG["vocab_size"])
    model, variables, sd = _jmodel(FSDP_CFG, 7, x)
    with torch.no_grad():  # the port's unsharded forward
        ref["fsdp_logits"] = t_decoder(FSDP_CFG, sd)(t(x))[0].numpy()
    ref["fsdp_sd"] = sd
    inp["fsdp"] = (FSDP_CFG, sd, t(x))
    inp["batch"] = torch.arange(24).reshape(8, 3)
    return ref, inp


@pytest.fixture(scope="module")
def jax_side():
    return _build()


@pytest.fixture(scope="module", params=[2, 4], ids=["w2", "w4"])
def world(request, jax_side):
    W = request.param
    ref, inp = jax_side
    outs = torch_parallel_ranks.spawn(W, "modules", inp)
    return W, ref, inp, outs


def _close(a, b, tol, msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), **tol,
                               err_msg=msg)


# ------------------------------------------------------------ no ranks needed
@pytest.mark.parametrize("cfg", [(-1, 1, 1, 1), (-1, 2, 1, 1), (2, 2, 1, 1), (1, 1, 2, 4),
                                 (-1, 1, 3, 1), (3, 3, 1, 1), (4, 1, 1, 1), (-1, 1, 1, 8)])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_config_resolve_matches_jax(cfg, n):
    try:
        want = jm.MeshConfig(*cfg).resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).replace("*", r"\*")):
            tm.MeshConfig(*cfg).resolve(n)
        return
    got = tm.MeshConfig(*cfg).resolve(n)
    assert (got.dp, got.fsdp, got.tp, got.sp) == (want.dp, want.fsdp, want.tp, want.sp)


def test_fsdp_spec_matches_jax_on_a_grid():
    rng = np.random.default_rng(0)
    shapes = [(1024, 896), (7, 896), (7, 7), (64, 64), (896,), (151936, 896), (4864, 896),
              (3, 5, 64), (2, 1024, 16, 64)] + [tuple(rng.integers(1, 300, rng.integers(1, 4)))
                                                 for _ in range(60)]
    for shape in shapes:
        for n in (1, 2, 3, 4, 8):
            for min_size in (0, 1024, 2 ** 16):
                want = tuple(jm._fsdp_spec_for(shape, n, min_size))
                assert tm._fsdp_spec_for(shape, n, min_size) == want, (shape, n, min_size)


def test_distributed_helpers_without_a_group(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert pd.initialize_distributed(device_type="cpu") is False
    assert pd.world_size() == 1 and pd.rank() == 0
    assert pd.local_batch_slice(8, 4, 1) == slice(2, 4)
    with pytest.raises(ValueError, match="does not divide"):
        pd.local_batch_slice(6, 4, 0)
    x = torch.ones(2, 10, 4, 8)
    padded, pad = ulysses_pad_and_slice(x, 4)
    assert padded.shape[1] == 12 and pad == 2 and float(padded[:, 10:].abs().sum()) == 0.0
    k = torch.arange(2 * 3 * 2 * 1, dtype=torch.float32).reshape(2, 3, 2, 1)
    np.testing.assert_array_equal(repeat_kv_heads(k, 4).numpy(),
                                  np.repeat(k.numpy(), 2, axis=2))
    assert repeat_kv_heads(k, 2) is k


# ------------------------------------------------------------------ on ranks
_TORCH_DIM = {"q_proj": 0, "k_proj": 0, "v_proj": 0, "gate_proj": 0, "up_proj": 0,
              "lm_head": 0, "o_proj": 1, "down_proj": 1, "embed_tokens": 0}


def _jax_placement(spec, names, cfg):
    """The JAX spec of one Flax leaf -> {port name: sharded dim or None}."""
    owner = names[-2]
    dim = _TORCH_DIM.get(owner, 0) if names[-1] != "bias" else 0
    d = dim if any(s is not None for s in spec) else None
    leaf = "bias" if names[-1] == "bias" else "weight"
    mods = names[1:-1]
    if mods[0] == "layers":
        return {".".join(("layers", str(i)) + mods[1:] + (leaf,)): d
                for i in range(cfg["num_layers"])}
    return {".".join(mods + (leaf,)): d}


def test_tp_placement_and_forward_match_jax(world):
    W, ref, inp, outs = world
    for name in ("tp", "tp_gqa") if W == 2 else ("tp",):
        cfg = inp[name][0]
        want = {}
        for names, spec in ref[f"{name}_spec"].items():
            want.update(_jax_placement(spec, names, cfg))
        for r, o in enumerate(outs):
            assert o[f"{name}_place"] == want, (name, r)
            _close(o[f"{name}_logits"], ref[f"{name}_logits"], TOL, f"{name} rank {r}")
    assert any(d is not None for d in want.values())
    assert "tensor-parallel" in outs[0]["tp_cache_error"]


def test_ulysses_attention_matches_jax(world):
    W, ref, inp, outs = world
    for name in ("sp_mha", "sp_gqa", "sp_pad"):
        got = torch.cat([o[name] for o in outs], dim=1)
        S = inp[name][0].shape[1]
        _close(got[:, :S], ref[name][:, :S], TOL, name)
        _close(got[:, :S], ref[f"{name}_plain"], TOL, f"{name} vs plain")
    S = inp["sp_pad"][0].shape[1]
    assert all(o["sp_pad_pad"] == (-S) % W for o in outs) and ref["sp_pad_pad"] == (-S) % JW


def test_ulysses_decoder_logits_and_grads(world):
    W, ref, inp, outs = world
    got = torch.cat([o["sp_decoder_logits"] for o in outs], dim=1)
    _close(got, ref["sp_decoder_logits"], TOL_SP)
    for r, o in enumerate(outs):
        for k, g in ref["sp_decoder_grads"].items():
            _close(o["sp_decoder_grads"][k], g, TOL_GRAD, f"{k} rank {r}")


def test_pipeline_matches_jax_and_sequential(world):
    W, ref, inp, outs = world
    for r, o in enumerate(outs):
        want = inp["pipe_x"][:2 * W].numpy()
        for w in np.linspace(0.5, 1.5, W * 2, dtype=np.float32):
            want = want * w + 1.0
        _close(o["pipe"], want, dict(rtol=1e-5, atol=0), f"pipe rank {r}")
        for name, want in (("pp_m_p", "pp"), ("pp_m_2p", "pp"), ("pp_tied_last", "pp_tied_last")):
            logits, hidden = o[name]
            _close(logits, ref[want][0], TOL_PP, f"{name} rank {r}")
            _close(hidden, ref[want][1], TOL_PP, f"{name} hidden rank {r}")
            _close(logits, ref[f"{want}_plain"], TOL_PP, f"{name} vs plain rank {r}")
        for k, g in ref["pp_grads"].items():
            _close(o["pp_grads"][k], g, TOL_GRAD, f"{k} rank {r}")


def test_fsdp_placement_forward_and_state_dict(world):
    W, ref, inp, outs = world
    sd = ref["fsdp_sd"]
    for name, min_size in (("fsdp", 2 ** 16), ("fsdp_small", 1024)):
        want = {k: (tuple(jm._fsdp_spec_for(tuple(v.shape), W, min_size)).index("fsdp")
                    if jm._fsdp_spec_for(tuple(v.shape), W, min_size) else None)
                for k, v in sd.items()}
        assert any(d is not None for d in want.values())
        for r, o in enumerate(outs):
            assert o[f"{name}_place"] == want, (name, r)
            _close(o[f"{name}_logits"], ref["fsdp_logits"], TOL, f"{name} rank {r}")
            for k, v in sd.items():
                torch.testing.assert_close(o[f"{name}_full_sd"][k], v, rtol=0, atol=0)
                torch.testing.assert_close(o[f"{name}_reloaded"][k], v + 1, rtol=0, atol=0)


def test_shard_batch_rows(world):
    W, ref, inp, outs = world
    b = inp["batch"]
    per, per_tp = 8 // W, 16 // W  # (dp, fsdp) = (W/2, 2); (dp, tp) = (W/2, 2)
    for r, o in enumerate(outs):
        torch.testing.assert_close(o["batch"], b[per * r: per * (r + 1)])
        # ranks along tp hold the same rows: the dp index is r // 2
        torch.testing.assert_close(o["batch_tp"], b[per_tp * (r // 2): per_tp * (r // 2 + 1)])
