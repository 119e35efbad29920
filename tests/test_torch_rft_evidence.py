"""The push pipeline in the port (trainer/rft_evidence.py and what it adds)
against the JAX package and tools/rft_evidence.py, on the CPU.

(a) The f32 plain twins of the flash kernels #1 / #2 / #3 at D 32 (4 / 2
    heads, the push policy LLM) and D 64 (2 / 2, the push WM) against the
    Pallas kernels in interpret mode (forward and `jax.vjp`), and of the
    decode kernels #4 / #5 over f32 caches against the Pallas hd kernels in
    interpret mode.  Tolerances in TWIN_TOL: the same f32 function, summed
    in another order and blocked differently (the Pallas kernels pad to
    32-row blocks).
(b) `CompressiveVQModelFSQ.recon_train` and the gradient of its MSE with
    respect to every tokenizer parameter against `tok.apply(...,
    method=tok.recon_train)` and `jax.grad` at push widths, with the Flax
    weights converted by `flax_to_torch` (RECON_TOL, GRAD_TOL).
(c) `torch_to_flax` inverts `flax_to_torch` bit for bit for every push
    family, and `flax_leaves` flattens in `jax.tree_util.tree_flatten`'s
    order (paths, shapes, dtypes, values).
(d) Adam steps of the tokenizer, WM and BC phases from the same weights and
    batch against the same steps written with the JAX package's modules and
    optax as the tool's closures write them: the losses (LOSS_RTOL) and
    every leaf's update against optax's (STEP_RTOL, NOISE_GRAD).
(e) The port's `load_tree` of every trained file in
    artifacts/rft_evidence32/ equals `flax_to_torch` of the tool's
    `load_tree`, bit for bit.
(f) (slow) The CLI's collect (12 segments, MuJoCo), tokenizer, wm, bc and
    rft phases on the CPU, a few steps each, writing files the tool's
    `load_tree` reads back equal to the port's weights.
"""
import math
import os
from types import SimpleNamespace

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from kernel_mode import INTERPRET
from tools import rft_evidence as j_tool
from vla_rft_tpu.data import push_data as j_push
from vla_rft_tpu.models.factory import init_params
from vla_rft_tpu.ops.attention import attention as j_attention
from vla_rft_tpu.ops.decode_attention_hd import (
    decode_attention_hd as j_decode_hd,
    decode_attention_shared_hd as j_decode_shared_hd,
)
from vla_rft_tpu_torch.convert import flax_leaves, flax_to_torch, torch_to_flax
from vla_rft_tpu_torch.ops import attention as tattn
from vla_rft_tpu_torch.ops import decode_attention_hd as tdec
from vla_rft_tpu_torch.trainer import rft_evidence as t_tool
from vla_rft_tpu_torch.trainer.optim import AdamW, warmup_cosine_decay_schedule

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVIDENCE = os.path.join(ROOT, "artifacts", "rft_evidence32")
FAMILIES = ("vla", "expert", "wm", "tokenizer", "lpips")
# f32 twin vs the Pallas kernel in interpret mode: the same f32 arithmetic,
# summed in another order over other blocks
TWIN_TOL = dict(atol=2e-5, rtol=2e-5)
# recon_train: ~20 f32 conv / GroupNorm / attention layers each way
RECON_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = 1e-4  # per parameter, of max|grad| over that parameter, plus 1e-7
# the phases' steps: losses within LOSS_RTOL (relative); each leaf's update
# (new - old, in f64) within STEP_RTOL of optax's update by norm (measured
# worst leaf: 1.2e-3 tokenizer, 5.5e-4 WM, 4.5e-4 BC).  A no-op step or one
# at half the lr misses it on every leaf (asserted).  Excepted are the leaves
# whose reference gradient is at round-off level, 0 < ||g|| <= NOISE_GRAD x
# the largest leaf's (measured <= 5.2e-10 for them, >= 1.1e-6 for every
# other leaf): the key biases of attention without rotary positions, whose
# gradient is 0 in exact arithmetic (a row's softmax ignores a shift shared
# by its logits).  Adam scales their round-off up to as much as lr, so they
# are held to Adam's bound, |update| <= lr (plus optax's weight decay).
LOSS_RTOL = 1e-5
STEP_RTOL = 1e-2
NOISE_GRAD = 1e-8
KEY_BIASES = (".to_k.bias", ".k_proj.bias", ".k.bias", ".l_proj.bias")


def _args(**kw):
    """The tool's arguments at its defaults (the port's parser)."""
    argv = ["bc", "--device", "cpu"]
    for k, v in kw.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return t_tool.parse_args(argv)


def _random_tree(shapes, seed):
    """Numpy leaves in the shapes of a Flax tree: near one for norm scales
    and LayerScale gammas, N(0, 0.05) elsewhere (tests/test_torch_sft.py's)."""
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = str(getattr(path[-1], "key", path[-1])).lower()
        noise = rng.normal(scale=0.05, size=sd.shape).astype(np.float32)
        return noise + 1.0 if name in ("scale", "weight") or "gamma" in name else noise

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def push():
    """The JAX push bundle (the tool's `build_push_bundle`) with seeded numpy
    leaves in its Flax trees' shapes, and the port's bundle at the same
    config on the CPU."""
    args = _args()
    cfg, jb = j_tool.build_push_bundle(args)
    shapes = jax.eval_shape(lambda k: init_params(jb, k), jax.random.key(0))
    params = {f: _random_tree(shapes[f], i) for i, f in enumerate(FAMILIES)}
    _, tb = t_tool.build_push_bundle(args)
    return SimpleNamespace(args=args, cfg=cfg, jb=jb, params=params, tb=tb)


# ------------------------------------------------- (a) f32 twins vs Pallas
FLASH_CASES = [
    ("plain", dict(), dict()),
    ("kv_lens", dict(), dict(kv_lens=[96, 61])),
    ("kv_starts", dict(Sq=64, Sk=64), dict(kv_starts=[0, 17])),
    ("q_offset", dict(Sq=32, Sk=96), dict(q_offset=[64, 64])),
    ("fully_masked_row", dict(Sq=40, Sk=40), dict(kv_lens=[40, 10], kv_starts=[0, 10])),
]
HEADS = {"d32_4_2": dict(Hq=4, Hkv=2, D=32), "d64_2_2": dict(Hq=2, Hkv=2, D=64)}


def _qkv(seed, B=2, Sq=96, Sk=96, Hq=4, Hkv=2, D=32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    do = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", list(HEADS))
@pytest.mark.parametrize("name,shape,kw", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_f32_flash_twins_match_pallas_interpret(name, shape, kw, heads, causal):
    q, k, v, do = _qkv([c[0] for c in FLASH_CASES].index(name), **shape, **HEADS[heads])
    jkw = {a: jnp.asarray(np.asarray(b, np.int32)) for a, b in kw.items()}

    def fwd(q_, k_, v_):
        return j_attention(q_, k_, v_, causal=causal, impl="pallas", block_q=32, block_k=32,
                           interpret=INTERPRET, **jkw)

    o_j, vjp = jax.vjp(fwd, *(jnp.asarray(x) for x in (q, k, v)))
    dq_j, dk_j, dv_j = vjp(jnp.asarray(do))
    tkw = {a: torch.as_tensor(np.asarray(b, np.int32)) for a, b in kw.items()}
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = tattn.attention_plain(tq, tk, tv, causal=causal, return_lse=True, **tkw)
    assert o.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **TWIN_TOL)
    got = tattn.attention_bwd_plain(tq, tk, tv, o, lse, torch.from_numpy(do), causal=causal,
                                    **tkw)
    for g_name, g, r in zip(("dq", "dk", "dv"), got, (dq_j, dk_j, dv_j)):
        assert g.dtype == torch.float32, g_name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=g_name, **TWIN_TOL)


def _f32_caches(rng, rows, S, Hkv, D=64):
    return tuple(rng.normal(size=(rows, S, Hkv * D)).astype(np.float32) for _ in range(2))


@pytest.mark.parametrize("sq,g,per_row", [(1, 1, False), (7, 1, True), (1, 2, True),
                                          (3, 2, False)])
def test_f32_decode_shared_twin_matches_pallas_interpret(sq, g, per_row):
    """#4's twin over an f32 cache (the push WM's: its compute dtype) with f32
    q, against the Pallas shared-prefix kernel in interpret mode."""
    rng = np.random.default_rng(20 + 10 * sq + g)
    B, Sr, Sp, Hkv, B_u, shared_valid = 4, 40, 80, 2, 2, 80
    prefix_map = np.array([1, 0, 0, 1] if per_row else [0, 0, 1, 1], np.int32)
    shared_starts = np.array([3, 0, 5, 0] if per_row else [3, 3, 0, 0], np.int32)
    own = np.array([sq, 20, 40, 9], np.int32)
    q = rng.normal(size=(B, sq, Hkv * g, 64)).astype(np.float32)
    ck, cv = _f32_caches(rng, B, Sr, Hkv)
    sck, scv = _f32_caches(rng, B_u, Sp, Hkv)
    ref = j_decode_shared_hd(
        jnp.asarray(q), jnp.asarray(ck[None]), jnp.asarray(cv[None]), jnp.asarray(sck[None]),
        jnp.asarray(scv[None]), jnp.int32(0), jnp.asarray(own), jnp.asarray(prefix_map),
        shared_valid, interpret=INTERPRET, block_b=1 if per_row else 2,
        shared_starts=jnp.asarray(shared_starts))
    kv_lens = shared_valid + own
    out = tdec.decode_shared_plain(
        *(torch.from_numpy(x) for x in (q, ck, cv, sck, scv, prefix_map)),
        shared_len=shared_valid, kv_lens=torch.from_numpy(kv_lens),
        q_offset=torch.from_numpy(kv_lens - sq), shared_starts=torch.from_numpy(shared_starts))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TWIN_TOL)


@pytest.mark.parametrize("sq,g", [(1, 1), (7, 1), (3, 2)])
def test_f32_decode_plain_twin_matches_pallas_interpret(sq, g):
    """#5's twin over an f32 cache against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(200 + sq + g)
    B, S, Hkv = 4, 96, 2
    kv_lens = np.array([90, sq, 96, 23], np.int32)
    kv_starts = np.array([0, 0, 11, 4], np.int32)
    q = rng.normal(size=(B, sq, Hkv * g, 64)).astype(np.float32)
    ck, cv = _f32_caches(rng, B, S, Hkv)
    ref = j_decode_hd(jnp.asarray(q), jnp.asarray(ck[None]), jnp.asarray(cv[None]),
                      jnp.int32(0), jnp.asarray(kv_lens), kv_starts=jnp.asarray(kv_starts),
                      interpret=INTERPRET, block_b=2)
    out = tdec.decode_plain(*(torch.from_numpy(x) for x in (q, ck, cv)),
                            kv_lens=torch.from_numpy(kv_lens),
                            q_offset=torch.from_numpy(kv_lens - sq),
                            kv_starts=torch.from_numpy(kv_starts))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TWIN_TOL)


def test_f32_kernels_refuse_what_they_do_not_take_on_the_cpu_side():
    """The wrappers' checks run before any launch: an f32 head dim outside
    F32_HEAD_DIMS, mixed dtypes and CPU tensors raise; f32 caches need f32 q."""
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_fwd(q, q, q)
    assert tattn.F32_HEAD_DIMS == (32, 64) and tattn.SUPPORTED_HEAD_DIMS == (64, 128)
    with pytest.raises(ValueError, match="CUDA"):
        tdec.decode_kernel(torch.zeros(1, 1, 2, 64), torch.zeros(1, 4, 128),
                           torch.zeros(1, 4, 128), kv_lens=[4], q_offset=[3])


# ------------------------------------------------------- (c) weight bridge
@pytest.mark.parametrize("family", FAMILIES)
def test_torch_to_flax_inverts_flax_to_torch_bit_for_bit(push, family):
    tree = push.params[family]
    module = getattr(push.tb, family)
    sd = flax_to_torch(tree, family)
    module.load_state_dict(sd, strict=True)
    back = torch_to_flax(module.state_dict(), family, module)
    j_leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    leaves = flax_leaves(back)
    assert len(leaves) == len(j_leaves)
    for (jp, ja), (p, a) in zip(j_leaves, leaves):
        assert tuple(str(getattr(x, "key", x)) for x in jp) == p
        assert a.dtype == ja.dtype and a.shape == ja.shape, p
        np.testing.assert_array_equal(a, ja, err_msg="/".join(p))


def test_flax_leaves_orders_as_tree_flatten():
    tree = {"b": {"z": 1, "a": 2, "blocks_10": 3, "blocks_2": 4}, "a": 5, "c": {"x": {"y": 6}}}
    assert [v for _, v in flax_leaves(tree)] == jax.tree_util.tree_leaves(tree)


# ----------------------------------------------------- (e) the tool's files
TRAINED = {"tokenizer.npz": "tokenizer", "wm.npz": "wm", "wm_final.npz": "wm",
           "bc_vla.npz": "vla", "bc_expert.npz": "expert", "rft_expert.npz": "expert"}
# artifacts/rft_evidence32's WM was trained with the tool's --wm-* overrides
TRAINED_WM = dict(wm_hidden=256, wm_inter=1024, wm_layers=6, wm_heads=4)


@pytest.fixture(scope="module")
def trained_like():
    args = _args(**TRAINED_WM)
    _, jb = j_tool.build_push_bundle(args)
    shapes = jax.eval_shape(lambda k: init_params(jb, k), jax.random.key(0))
    _, tb = t_tool.build_push_bundle(args)
    return shapes, tb


@pytest.mark.parametrize("fname", list(TRAINED))
def test_load_tree_reads_the_tools_files(trained_like, fname):
    shapes, tb = trained_like
    family = TRAINED[fname]
    path = os.path.join(EVIDENCE, fname)
    ref = flax_to_torch(jax.tree_util.tree_map(np.asarray, j_tool.load_tree(path, shapes[family])),
                        family)
    got = t_tool.load_tree(path, getattr(tb, family), family)
    assert set(got) == set(ref)
    for k, v in got.items():
        assert v.dtype == ref[k].dtype and torch.equal(v, ref[k]), k


# --------------------------------------------- (b) recon_train and its grads
def _port(push, family):
    """The port's module of `family` holding the fixture's weights, trainable."""
    module = getattr(push.tb, family)
    module.load_state_dict(flax_to_torch(push.params[family], family), strict=True)
    return module.train().requires_grad_(True)


@pytest.fixture(scope="module")
def recon(push):
    """The reference's recon_train on a (2, 4, 32, 32, 3) batch: output, MSE,
    its gradient tree, and one optax.adam(1e-3) step from it (the tool's
    tokenizer step)."""
    tok = push.jb.tokenizer
    px = np.random.default_rng(5).uniform(size=(2, 4, 32, 32, 3)).astype(np.float32)

    def loss_fn(p):
        rec = tok.apply(p, px, method=tok.recon_train)
        return jnp.mean((rec - px) ** 2), rec

    tx = optax.adam(1e-3)

    @jax.jit
    def step(tree):  # the body of the tool's multi_step
        (loss, rec), grads = jax.value_and_grad(loss_fn, has_aux=True)(tree)
        upd, _ = tx.update(grads, tx.init(tree))
        return loss, rec, grads, optax.apply_updates(tree, upd)

    loss, rec, grads, new = step(push.params["tokenizer"])
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return px, float(loss), np.asarray(rec), as_np(grads), as_np(new)


def test_recon_train_and_its_gradients_match_jax(push, recon):
    px, j_loss, j_rec, j_grads, _ = recon
    tok = _port(push, "tokenizer")
    x = torch.from_numpy(px)
    rec = tok.recon_train(x)
    assert rec.shape == x.shape and rec.dtype == torch.float32
    np.testing.assert_allclose(rec.detach().numpy(), j_rec, **RECON_TOL)
    loss = t_tool.tokenizer_loss(tok, x)
    np.testing.assert_allclose(loss.item(), j_loss, rtol=LOSS_RTOL)
    names = [n for n, _ in tok.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(tok.parameters()))))
    ref = flax_to_torch(j_grads, "tokenizer")
    assert set(ref) == set(grads)
    for n, g in grads.items():
        r = ref[n].numpy()
        err = float(np.abs(g.numpy() - r).max())
        assert err <= GRAD_TOL * float(np.abs(r).max()) + 1e-7, (n, err)
    # the straight-through codes: both encoders get gradient through FSQ
    for prefix in ("encoder.", "cond_encoder.", "quant_conv.", "quant_linear."):
        assert any(float(g.abs().max()) > 0 for n, g in grads.items() if n.startswith(prefix))


def test_fsq_straight_through_rounds_forward_and_passes_gradient():
    from vla_rft_tpu.models.fsq import FSQ as JFSQ
    from vla_rft_tpu_torch.models.fsq import FSQ

    levels = [7, 5, 5, 5, 5]
    z = np.random.default_rng(0).normal(scale=2.0, size=(3, 9, 5)).astype(np.float32)
    zt = torch.from_numpy(z).requires_grad_(True)
    out = FSQ(levels).quantize_ste(zt)
    j_out, j_vjp = jax.vjp(JFSQ(levels).quantize, jnp.asarray(z))
    # bound's tanh differs from XLA's by an ulp, which the straight-through
    # sum bound + (round - bound) keeps: codes within 2 f32 ulps of 1
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), atol=3e-7, rtol=0)
    np.testing.assert_allclose(out.detach().numpy(), FSQ(levels).quantize(zt).detach().numpy(),
                               atol=3e-7, rtol=0)
    ct = np.random.default_rng(1).normal(size=z.shape).astype(np.float32)
    (g,) = torch.autograd.grad(out, zt, torch.from_numpy(ct))
    # the identity through round, bound's derivative (1 - tanh^2) within
    # tanh's ulp
    np.testing.assert_allclose(g.numpy(), np.asarray(j_vjp(jnp.asarray(ct))[0]), rtol=1e-5,
                               atol=1e-6)


# ----------------------------------------------------- (d) the phases' steps
def _assert_step(module, old_tree, new_tree, grads, family, lr):
    """The port's step (module now, from old_tree) against optax's (old_tree
    -> new_tree, from the reference gradient `grads`): each leaf's update
    within STEP_RTOL of the reference's by norm, the round-off-gradient
    leaves within Adam's bound lr; and a planted no-op step and a step at
    half the port's size miss STEP_RTOL on every leaf the reference moves."""
    old, ref = flax_to_torch(old_tree, family), flax_to_torch(new_tree, family)
    g = {k: float(v.double().norm()) for k, v in flax_to_torch(grads, family).items()}
    got = module.state_dict()
    assert set(ref) == set(got) == set(old) == set(g)
    noise = {k for k, n in g.items() if 0 < n <= NOISE_GRAD * max(g.values())}
    assert all(k.endswith(KEY_BIASES) for k in noise), sorted(noise)

    def update_errs(scale):
        errs = {}
        for k in set(got) - noise:
            d_ref = ref[k].double() - old[k].double()
            d = scale * (got[k].double() - old[k].double())
            n_ref, n_err = float(d_ref.norm()), float((d - d_ref).norm())
            errs[k] = n_err / n_ref if n_ref else (0.0 if n_err == 0 else math.inf)
        return errs

    bad = {k: e for k, e in update_errs(1.0).items() if e > STEP_RTOL}
    assert not bad, bad
    for k in noise:
        moved = float((got[k].double() - old[k].double()).abs().max())
        assert moved <= lr * 1.001, (k, moved, lr)
    moving = [k for k in set(got) - noise if not torch.equal(ref[k], old[k])]
    assert moving
    for scale in (0.0, 0.5):
        errs = update_errs(scale)
        assert min(errs[k] for k in moving) > STEP_RTOL, scale


def test_tokenizer_phase_step_matches_jax(push, recon):
    px, j_loss, _, j_grads, j_new = recon
    tok = _port(push, "tokenizer")
    opt = AdamW(list(tok.parameters()), 1e-3, weight_decay=0.0)  # the phase's optax.adam(1e-3)
    loss = t_tool.tokenizer_loss(tok, torch.from_numpy(px))
    opt.step(torch.autograd.grad(loss, opt.params))
    np.testing.assert_allclose(loss.item(), j_loss, rtol=LOSS_RTOL)
    _assert_step(tok, push.params["tokenizer"], j_new, j_grads, "tokenizer", 1e-3)


def _wm_batches(push, n=2, B=2):
    """Token rows of the push layout: 87 prompt + 184 response ids in the WM
    vocabulary, the ctx and first dyn tokens unlabelled (-100)."""
    rng = np.random.default_rng(9)
    L = push.cfg.data.max_prompt_length + push.cfg.data.max_response_length
    out = []
    for _ in range(n):
        ids = rng.integers(0, 9008, (B, L)).astype(np.int32)
        labels = ids.copy()
        labels[:, :80] = -100
        out.append((ids, labels))
    return out


def test_wm_phase_steps_match_jax(push):
    """Two steps of the WM phase (AdamW over the warm-up + cosine schedule
    with weight decay 0.01: step 1 at lr 0, step 2 at lr / 100)."""
    wm_j = push.jb.wm
    tree = push.params["wm"]
    sched = optax.warmup_cosine_decay_schedule(0.0, push.args.wm_lr, 100, push.args.wm_steps)
    tx = optax.adamw(sched, weight_decay=0.01)
    opt_j = tx.init(tree)

    def loss_fn(p, ids, labels):  # the tool's loss_fn
        logits, _, _ = wm_j.apply(p, ids[:, :-1])
        lp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        tgt = labels[:, 1:]
        valid = tgt != -100
        nll = -jnp.take_along_axis(lp, tgt.clip(0)[..., None], axis=-1)[..., 0]
        return (nll * valid).sum() / valid.sum()

    wm = _port(push, "wm")
    opt = AdamW(list(wm.parameters()),
                warmup_cosine_decay_schedule(0.0, push.args.wm_lr, 100, push.args.wm_steps),
                weight_decay=0.01)
    @jax.jit
    def step(tree, opt_j, ids, labels):  # the body of the tool's multi_step
        loss, grads = jax.value_and_grad(loss_fn)(tree, ids, labels)
        upd, opt_j = tx.update(grads, opt_j, tree)
        return optax.apply_updates(tree, upd), opt_j, loss, grads

    for ids, labels in _wm_batches(push):
        tree, opt_j, j_loss, grads = step(tree, opt_j, jnp.asarray(ids), jnp.asarray(labels))
        loss = t_tool.wm_loss(wm, torch.from_numpy(ids).long(), torch.from_numpy(labels))
        opt.step(torch.autograd.grad(loss, opt.params))
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=LOSS_RTOL)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    # the last step's gradient; lr: step 2's (step 1 runs at lr 0)
    _assert_step(wm, push.params["wm"], as_np(tree), as_np(grads), "wm", float(sched(1)))


def test_bc_phase_step_matches_jax(push):
    """One BC step: the whole policy through VLAAdapterSFTTrainer (no
    freeze), expert lr 3x, the reference trainer's `_loss` and `tx` on the
    tool's batch layout with the reference's noise dict handed to both."""
    from vla_rft_tpu.models.action_head import sample_noisy_actions as j_sample_noisy
    from vla_rft_tpu.trainer.sft_trainer import VLAAdapterSFTTrainer as JAdapter
    from vla_rft_tpu_torch.trainer.sft_trainer import VLAAdapterSFTTrainer

    jb, lr = push.jb, push.args.bc_lr
    rng = np.random.default_rng(13)
    B = 2
    ids, attn, labels = j_push.build_push_prompt(32, 8)
    px = rng.integers(0, 256, (B, 64, 64, 3)).astype(np.uint8).astype(np.float32) / 255.0
    batch = {"pixels": np.concatenate([px, px], axis=-1),
             "proprio": rng.normal(size=(B, 8)).astype(np.float32),
             "input_ids": np.tile(ids, (B, 1)), "attention_mask": np.tile(attn, (B, 1)),
             "labels": np.tile(labels, (B, 1)),
             "actions": rng.uniform(-1, 1, (B, 8, 7)).astype(np.float32)}
    jt = JAdapter(jb.vla, jb.expert, push.params["vla"], push.params["expert"], lr=lr,
                  expert_lr=lr * 3.0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    nd = j_sample_noisy(jax.random.key(3), jbatch["actions"], jb.expert.cfg)

    @jax.jit
    def step(params, opt_state, batch, nd):  # the tool's BC one_step with its noise
        loss, grads = jax.value_and_grad(jt._loss)(params, batch, nd)
        upd, _ = jt.tx.update(grads, opt_state, params)
        return loss, optax.apply_updates(params, upd), grads

    j_loss, new, grads = step(jt.params, jt.opt_state, jbatch, nd)
    new, grads = (jax.tree_util.tree_map(np.asarray, t) for t in (new, grads))

    vla, expert = _port(push, "vla"), _port(push, "expert")
    tr = VLAAdapterSFTTrainer(vla, expert, lr=lr, expert_lr=lr * 3.0)
    to_t = lambda a: (torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
                      if a.dtype == jnp.bfloat16 else torch.from_numpy(np.asarray(a)))
    loss = tr.compute_loss({k: torch.from_numpy(v) for k, v in batch.items()},
                           {k: to_t(v) for k, v in nd.items()})
    tr.update(tr.backward(loss))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=LOSS_RTOL)
    _assert_step(vla, push.params["vla"], new["vla"], grads["vla"], "vla", lr)
    _assert_step(expert, push.params["expert"], new["expert"], grads["expert"], "expert",
                 lr * 3.0)


# ------------------------------------------------------- (f) the CLI, slow
@pytest.mark.slow
def test_cli_phases_write_files_the_tool_reads(tmp_path):
    """collect (12 segments in MuJoCo), tokenizer, wm, bc and rft through the
    port's CLI on the CPU, a few steps each; every weight file reads back
    through the tool's `load_tree` equal to the port's weights."""
    w = str(tmp_path)
    common = ["--workdir", w, "--device", "cpu", "--n-segments", "12", "--tok-steps", "25",
              "--wm-steps", "25", "--bc-steps", "25", "--bc-batch", "8", "--rft-steps", "1",
              "--rollout-n", "2"]
    out = {}
    for phase in ("collect", "tokenizer", "wm", "bc", "rft"):
        out.update(t_tool.main([phase, *common]))
    data = j_push.load_segments(os.path.join(w, "segments.npz"))
    assert data["raw_pixel_values"].shape == (12, 9, 32, 32, 3)
    for name in ("tokenizer", "wm", "bc"):
        assert len(out[name]["losses"]) == 25 and np.isfinite(out[name]["losses"]).all()
    assert [r["step"] for r in out["rft"]["curve"]] == [0, 1]
    args = t_tool.parse_args(["rft", *common])
    _, jb = j_tool.build_push_bundle(args)
    shapes = jax.eval_shape(lambda k: init_params(jb, k), jax.random.key(0))
    _, tb = t_tool.build_push_bundle(args)
    for fname, family in TRAINED.items():
        path = os.path.join(w, fname)
        j_tree = jax.tree_util.tree_map(np.asarray, j_tool.load_tree(path, shapes[family]))
        mine = t_tool.load_tree(path, getattr(tb, family), family)
        ref = flax_to_torch(j_tree, family)
        assert all(torch.equal(v, ref[k]) for k, v in mine.items()), fname
    trained = out["rft"]["trainer"].bundle.expert.state_dict()
    saved = t_tool.load_tree(os.path.join(w, "rft_expert.npz"), tb.expert, "expert")
    assert all(torch.equal(v, saved[k]) for k, v in trained.items())
