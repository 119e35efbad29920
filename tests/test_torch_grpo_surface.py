"""The rest of the port's GRPO surface against the JAX package, on the CPU.

Weights are random numpy leaves in the Flax trees' shapes (or the trained
push world model), converted by `convert.flax_to_torch`; inputs come from
numpy with fixed seeds; everything is f32.  Tolerances:

* `ac_reward` (l1 / mse / huber) within 1e-5 relative: the same f32
  element-wise arithmetic;
* `compute_log_prob` and `wm_logprob_reward` through a 2-layer WM within
  1e-4 relative: a full f32 forward whose products are summed in another
  order, then a logsumexp over the vocabulary;
* `msp_reward` with `gt_map` / `gt_feat_idx` within 1e-4 relative, the
  tolerance of every other msp_reward test (tests/test_torch_reward.py):
  the tokenizer decoder's and LPIPS's f32 convolutions are summed in
  another order;
* `save_frame_grid`: the port's own PNG encoder gives the reference's PIL
  PNG's pixels and file name, and `write_png` round-trips any RGB image;
* one verify call of Sq = 3 at per-row cache offsets against the
  reference's `wm.apply` with a (B,) `cache_index`, both cache layouts, int8
  and f32 caches: logits within 1e-5 relative to max|logits|; the int8
  caches (values and scales) bit-equal, the f32 caches within 1e-6 of
  max|cache| (their k/v are f32 products summed in another order) and
  written at the same positions;
* the speculative greedy rollout (k = 2, 3; shared-prefix and plain
  routes) bit-equal to the port's plain greedy rollout and to the
  reference's speculative greedy tokens; on the trained push WM, where
  drafts are accepted, bit-equal to plain greedy with an acceptance rate
  above 0;
* sampled speculation keeps the decode distribution: first-frame token
  histograms against the plain-vs-plain total-variation null, as
  tests/test_wm_and_reward.py does for the reference;
* one tiny `training_step` each for ReMax, the action-space reward and the
  wm_logprob reward, and `validate()`, against the reference trainer from
  the same weights, batch and injected draws with a greedy WM decode:
  metrics within 1e-3 relative + 1e-5 absolute, as
  tests/test_torch_grpo.py's step test holds them.  These four are marked
  slow (the reference trainers' stages compile for about 65 s on the CPU):
  `python -m pytest tests/test_torch_grpo_surface.py` runs them, the
  tier-1 command (`-m 'not slow'`) does not;
* the CLI runs each of these settings (and validation every step) on the
  CPU (tests/test_torch_grpo.py checks that speculative_k = 8 is refused).
"""
import dataclasses
import os
import struct
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_grpo import COMPARED, MODULES, STAGE_FNS, _tiny_overrides, tiny_params  # noqa: F401
from test_torch_reward import tiny  # noqa: F401
from test_torch_wm import EVIDENCE, _load_tree, _pair
from vla_rft_tpu.config import vla_rft_default_config as j_default_config
from vla_rft_tpu.data.synthetic import SyntheticVLADataset as JDataset
from vla_rft_tpu.models import transformer as j_tf
from vla_rft_tpu.parallel.mesh import MeshConfig, make_mesh
from vla_rft_tpu.trainer.grpo_trainer import VLARFTGRPOTrainer as JTrainer
from vla_rft_tpu.utils import generations_logger as j_gl
from vla_rft_tpu.workers import processor as j_proc
from vla_rft_tpu.workers import reward as j_reward
from vla_rft_tpu.workers import wm_rollout as j_roll
from vla_rft_tpu_torch.config import vla_rft_default_config
from vla_rft_tpu_torch.convert import flax_to_torch
from vla_rft_tpu_torch.models import transformer as t_tf
from vla_rft_tpu_torch.trainer import main_vla_rft_grpo
from vla_rft_tpu_torch.trainer.grpo_trainer import VLARFTGRPOTrainer as TTrainer
from vla_rft_tpu_torch.utils import generations_logger as t_gl
from vla_rft_tpu_torch.workers import processor as t_proc
from vla_rft_tpu_torch.workers import reward as t_reward
from vla_rft_tpu_torch.workers import wm_rollout as t_roll


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(np.asarray(b)).max(),
                                                                   1e-30))


# ------------------------------------------------------------------ rewards
@pytest.mark.parametrize("kind", ["l1", "mse", "huber"])
def test_ac_reward_matches_jax(kind):
    rng = np.random.default_rng(0)
    gt = rng.normal(size=(4, 8, 7)).astype(np.float32)
    pred = (gt + rng.normal(scale=0.5, size=gt.shape)).astype(np.float32)
    j_r, j_m = j_reward.ac_reward(jnp.asarray(gt), jnp.asarray(pred), kind, huber_delta=0.3)
    t_r, t_m = t_reward.ac_reward(torch.from_numpy(gt), torch.from_numpy(pred), kind,
                                  huber_delta=0.3)
    assert t_r.shape == (4, 56) and t_r.dtype == torch.float32
    assert _rel(t_r.numpy(), j_r) <= 1e-5
    assert set(t_m) == set(j_m) == {f"critic/{kind}_loss/mean"}
    for k in j_m:
        assert abs(float(t_m[k]) - float(j_m[k])) <= 1e-5 * abs(float(j_m[k]))


@pytest.mark.parametrize("aggregate", ["mean", "last", "discount"])
def test_wm_logprob_reward_and_compute_log_prob_match_jax(aggregate):
    jm, params, tm = _pair("bf16", vocab=256, seed=3)
    F, tpf, A, P = 2, 4, 7, 30
    pc = dict(visual_token_num=100, action_bins=16, action_dim=A, tokens_per_frame=tpf)
    rc = dict(num_frames=F, msp_reward_aggregate=aggregate, msp_reward_discount=0.9)
    ids = np.random.default_rng(4).integers(0, 256, (3, P + F * (tpf + A))).astype(np.int32)
    j_lp = j_roll.compute_log_prob(jm, params, jnp.asarray(ids), F * (tpf + A), temperature=0.8)
    t_lp = t_roll.compute_log_prob(tm, torch.from_numpy(ids), F * (tpf + A), temperature=0.8)
    assert t_lp.shape == (3, F * (tpf + A))
    assert _rel(t_lp.numpy(), j_lp) <= 1e-4
    j_r, j_m = j_reward.wm_logprob_reward(jm, params, j_proc.ProcessorConfig(**pc),
                                          j_reward.RewardConfig(**rc), jnp.asarray(ids), P)
    t_r, t_m = t_reward.wm_logprob_reward(tm, t_proc.ProcessorConfig(**pc),
                                          t_reward.RewardConfig(**rc), torch.from_numpy(ids), P)
    assert _rel(t_r.numpy(), j_r) <= 1e-4 and (t_r.numpy()[:, :-1] == 0).all()
    k = "critic/wm_dyn_logprob/mean"
    assert set(t_m) == set(j_m) == {k}
    assert abs(float(t_m[k]) - float(j_m[k])) <= 1e-4 * abs(float(j_m[k]))


def test_msp_reward_with_gt_map_matches_jax(tiny):
    """Unique gt rollouts (one per sample) decoded with their own context
    rows and gathered per row through gt_map, against the reference, and
    against the same reward from real frames decoded once."""
    b, params, port = tiny
    rng = np.random.default_rng(6)
    F = b.reward_cfg.num_frames
    per = b.proc_cfg.tokens_per_frame + b.proc_cfg.action_dim
    B, U = 4, 2
    resp = rng.integers(0, 4375, (B, F * per)).astype(np.int32)
    gt_u = rng.integers(0, 4375, (U, F * per)).astype(np.int32)
    ctx_u = (rng.integers(0, 4375, (U, 1, 64)) + 4375).astype(np.int32)
    ctx_map = np.array([1, 1, 0, 0], np.int32)
    gt_map = np.array([0, 0, 1, 1], np.int32)
    gt_feat = np.array([1, 0], np.int32)
    def j_msp(tp, lp, r, g, c):
        _, feats = b.tokenizer.apply(tp, c - 4375, method=b.tokenizer.ctx_decode)
        return j_reward.msp_reward(
            b.tokenizer, tp, b.lpips, lp, b.proc_cfg, b.reward_cfg, r, None, gt_responses=g,
            ctx_feats=feats, ctx_map=jnp.asarray(ctx_map), gt_map=jnp.asarray(gt_map),
            gt_feat_idx=jnp.asarray(gt_feat))

    j_r, j_m = jax.jit(j_msp)(params["tokenizer"], params["lpips"], jnp.asarray(resp),
                              jnp.asarray(gt_u), jnp.asarray(ctx_u))
    with torch.no_grad():
        _, feats = port.tokenizer.ctx_decode(torch.from_numpy(ctx_u) - 4375)
        kw = dict(ctx_feats=feats, ctx_map=torch.from_numpy(ctx_map))
        t_r, t_m = t_reward.msp_reward(
            port.tokenizer, port.lpips, port.proc_cfg, port.reward_cfg, torch.from_numpy(resp),
            gt_responses=torch.from_numpy(gt_u), gt_map=torch.from_numpy(gt_map),
            gt_feat_idx=torch.from_numpy(gt_feat), **kw)
        gt_frames = t_reward.detokenize_response_frames(
            port.tokenizer, port.proc_cfg, F, torch.from_numpy(gt_u), feats,
            torch.from_numpy(gt_feat))
        t_r2, _ = t_reward.msp_reward(port.tokenizer, port.lpips, port.proc_cfg, port.reward_cfg,
                                      torch.from_numpy(resp),
                                      real_frames=gt_frames[torch.from_numpy(gt_map).long()], **kw)
    assert _rel(t_r.numpy(), j_r) <= 1e-4
    for k in j_m:
        assert abs(float(t_m[k]) - float(j_m[k])) <= 1e-4 * abs(float(j_m[k])), k
    assert _rel(t_r2.numpy(), t_r.numpy()) <= 1e-6


# ------------------------------------------------------------------ PNG
def _read_png(path):
    """(H, W, 3) uint8 from an 8-bit RGB PNG of filter-0 rows (the port's)."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    i, chunks = 8, {}
    while i < len(data):
        (n,) = struct.unpack(">I", data[i:i + 4])
        kind, body = data[i + 4:i + 8], data[i + 8:i + 8 + n]
        assert struct.unpack(">I", data[i + 8 + n:i + 12 + n])[0] == zlib.crc32(kind + body)
        chunks[kind] = chunks.get(kind, b"") + body
        i += 12 + n
    W, H, depth, colour = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, colour) == (8, 2) and b"IEND" in chunks
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(H, 1 + 3 * W)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(H, W, 3)


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (33, 2)])
def test_write_png_round_trips_through_pil(tmp_path, shape):
    """Any (H, W, 3) uint8 image decodes (by PIL and by the stdlib reader)
    to its own pixels; other channel counts are refused."""
    Image = pytest.importorskip("PIL.Image")
    img = np.random.default_rng(sum(shape)).integers(0, 256, (*shape, 3), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    t_gl.write_png(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(_read_png(path), img)
    with pytest.raises(ValueError):
        t_gl.write_png(path, img[..., :2])


def test_save_frame_grid_writes_the_reference_png(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(8)
    real = rng.uniform(-0.1, 1.1, (3, 16, 24, 3)).astype(np.float32)
    pred = rng.uniform(0, 1, (3, 16, 24, 3)).astype(np.float32)
    j_path = j_gl.save_frame_grid(real, pred, str(tmp_path / "j" / "3_val.png"), reward=-0.25)
    t_path = t_gl.save_frame_grid(real, pred, str(tmp_path / "t" / "3_val.png"), reward=-0.25)
    assert os.path.basename(t_path) == os.path.basename(j_path) == "3_val_reward-0.2500.png"
    ref = np.asarray(Image.open(j_path).convert("RGB"))
    assert ref.shape == (3 * 16, 3 * 24, 3)
    np.testing.assert_array_equal(np.asarray(Image.open(t_path)), ref)
    np.testing.assert_array_equal(_read_png(t_path), ref)


# ---------------------------------------------------- per-row cache offsets
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("layout", ["hd", "heads"])
def test_per_row_verify_call_matches_jax(layout, kv):
    """A prefill at 0, then one call of 3 tokens whose rows stand at 4
    different offsets (some overwriting earlier positions, as verify calls
    do) with kv_lens = offset + 3."""
    kw = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=2,
              num_heads=2, num_kv_heads=2, kv_cache_dtype=kv, kv_layout=layout)
    jm = j_tf.Decoder(j_tf.TransformerConfig(dtype=jnp.float32, param_dtype=jnp.float32,
                                             attn_impl="xla", **kw))
    assert jm.cfg.kv_layout_eff == layout
    _, params, _ = _pair(kv, seed=5)
    tm = t_tf.Decoder(t_tf.TransformerConfig(dtype=torch.float32, param_dtype=torch.float32,
                                             **kw))
    tm.load_state_dict(flax_to_torch(params, "wm"), strict=True)
    rng = np.random.default_rng(9)
    B, P, S = 4, 20, 3
    prompt, chunk = rng.integers(0, 256, (B, P)), rng.integers(0, 256, (B, S))
    ci = np.array([20, 17, 14, 19], np.int32)
    jc = jm.init_cache(B, 40)
    _, _, jc = jm.apply(params, jnp.asarray(prompt, jnp.int32), cache=jc, cache_index=0)
    j_logits, _, jc = jm.apply(params, jnp.asarray(chunk, jnp.int32), cache=jc,
                               cache_index=jnp.asarray(ci), kv_lens=jnp.asarray(ci + S))
    tc = tm.init_cache(B, 40)
    with torch.no_grad():
        tm(torch.from_numpy(prompt), cache=tc, cache_index=0)
        t_logits, _ = tm(torch.from_numpy(chunk), cache=tc, cache_index=torch.from_numpy(ci),
                         kv_lens=torch.from_numpy(ci + S))
    assert _rel(t_logits.numpy(), j_logits) <= 1e-5
    unpack = (lambda a: np.asarray(j_tf.unpack_kv_heads(a))) if jm.cfg.pack_kv else np.asarray
    for i, (t, j) in enumerate(zip(tc, jc)):
        t, j = t.float().numpy(), (unpack(j) if i < 2 else np.asarray(j, np.float32))
        assert t.shape == j.shape
        if kv == "int8":
            np.testing.assert_array_equal(t, j)
        else:
            assert np.abs(t - j).max() <= 1e-6 * np.abs(j).max()
            np.testing.assert_array_equal(t != 0, j != 0)


# ------------------------------------------------------ speculative rollout
SPEC_ROLL = dict(prompt_length=40, response_length=3 * 13, num_frames=3, interact_max_tokens=6,
                 action_dim=7, do_sample=False, cache_segments=2)


def _spec_inputs():
    rng = np.random.default_rng(10)
    B, P0 = 4, 33
    heads = rng.integers(0, 256, (2, P0))
    pm = np.array([0, 0, 1, 1], np.int32)
    actions = rng.integers(0, 256, (B, 4, 7))
    prompt = np.concatenate([heads[pm], actions[:, 0]], axis=1)
    return heads, pm, actions, prompt


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "plain"])
@pytest.mark.parametrize("k", [2, 3])
def test_speculative_greedy_equals_plain_and_jax(k, shared):
    jm, params, tm = _pair("int8", seed=11)
    heads, pm, actions, prompt = _spec_inputs()
    if shared:
        jkw = dict(shared_prefix=jnp.asarray(heads, jnp.int32), prefix_map=jnp.asarray(pm),
                   prefix_run=2)
        tkw = dict(shared_prefix=torch.from_numpy(heads), prefix_map=torch.from_numpy(pm))
        ids = actions[:, 0]
    else:
        jkw, tkw, ids = {}, {}, prompt
    cfg = t_roll.WMRolloutConfig(**SPEC_ROLL)
    plain = t_roll.generate_sequences(tm, torch.Generator(), torch.from_numpy(ids),
                                      torch.from_numpy(actions), cfg, **tkw)
    stats = {}
    spec = t_roll.generate_sequences(tm, torch.Generator(), torch.from_numpy(ids),
                                     torch.from_numpy(actions),
                                     dataclasses.replace(cfg, speculative_k=k), stats=stats,
                                     **tkw)
    jcfg = j_roll.WMRolloutConfig(**SPEC_ROLL, speculative_k=k)
    j_spec = jax.jit(lambda p, i, a: j_roll.generate_sequences(
        jm, p, jax.random.key(0), i, a, jcfg, **jkw))(
        params, jnp.asarray(ids, jnp.int32), jnp.asarray(actions, jnp.int32))
    np.testing.assert_array_equal(spec.numpy(), plain.numpy())
    np.testing.assert_array_equal(spec.numpy(), np.asarray(j_spec))
    assert stats["calls"] == 1 + stats["verify_calls"] + SPEC_ROLL["num_frames"]
    assert stats["verify_calls"] >= SPEC_ROLL["num_frames"]


def test_speculative_greedy_on_the_trained_push_wm_accepts_drafts():
    """The push preset's trained WM (tools/rft_evidence.py's, 6 layers of
    256) on recorded token prompts, 2 frames: drafts from the previous frame
    are accepted, so rows advance by different amounts and the per-row
    offsets diverge; the tokens equal plain greedy decode's."""
    kw = dict(vocab_size=9008, hidden_size=256, intermediate_size=1024, num_layers=6,
              num_heads=4, num_kv_heads=4)
    jm = j_tf.Decoder(j_tf.TransformerConfig(dtype=jnp.float32, param_dtype=jnp.float32,
                                             attn_impl="xla", **kw))
    like = jax.eval_shape(lambda r: jm.init(r, jnp.zeros((1, 8), jnp.int32)), jax.random.key(0))
    params = _load_tree(os.path.join(EVIDENCE, "wm.npz"), like)
    tm = t_tf.Decoder(t_tf.TransformerConfig(dtype=torch.float32, param_dtype=torch.float32,
                                             **kw))
    tm.load_state_dict(flax_to_torch(params, "wm"), strict=True)
    with np.load(os.path.join(EVIDENCE, "wm_tokens.npz")) as z:
        rows = np.asarray(z["ids"][:: 4096][:4], np.int64)
    P, V, A, F = 87, 16, 7, 2
    prompt = rows[:, :P]
    resp = rows[:, P:].reshape(4, -1, V + A)
    actions = np.concatenate([prompt[:, None, P - A:], resp[:, :, V:]], axis=1)[:, :F + 1]
    cfg = t_roll.WMRolloutConfig(prompt_length=P, response_length=F * (V + A), num_frames=F,
                                 interact_max_tokens=V, action_dim=A, do_sample=False,
                                 cache_segments=1)
    run = lambda c, stats=None: t_roll.generate_sequences(
        tm.eval(), torch.Generator(), torch.from_numpy(prompt), torch.from_numpy(actions), c,
        stats=stats)
    stats = {}
    spec = run(dataclasses.replace(cfg, speculative_k=4), stats)
    np.testing.assert_array_equal(spec.numpy(), run(cfg).numpy())
    assert stats["accepted"] > 0, stats
    assert stats["verify_calls"] < F * V  # accepted drafts save calls


def test_speculative_sampling_keeps_the_decode_distribution():
    """192 rows of one prompt, one frame sampled at top_p 0.9: the histogram
    of each visual token with speculation (k = 2) against plain decode's is
    within the plain-vs-plain total variation + 0.12 (the reference's
    test_wm_speculative_sampling_distribution)."""
    _, _, tm = _pair("bf16", vocab=120, seed=12)
    B, P0, V, A = 192, 20, 4, 2
    rng = np.random.default_rng(3)
    heads = torch.from_numpy(rng.integers(0, 100, (1, P0)))
    actions = torch.from_numpy(np.repeat(rng.integers(100, 119, (1, 2, A)), B, axis=0))
    cfg = t_roll.WMRolloutConfig(prompt_length=P0 + A, response_length=V + A, num_frames=1,
                                 interact_max_tokens=V, action_dim=A, do_sample=True, top_p=0.9)
    run = lambda seed, k: t_roll.generate_sequences(
        tm.eval(), torch.Generator().manual_seed(seed), actions[:, 0],
        actions, dataclasses.replace(cfg, speculative_k=k), shared_prefix=heads,
        prefix_map=torch.zeros(B, dtype=torch.int32)).numpy()
    ref, ref2, out = run(7, 0), run(23, 0), run(11, 2)
    hist = lambda r, pos: np.bincount(r[:, pos], minlength=120) / B
    for pos in range(V):
        null_tv = 0.5 * np.abs(hist(ref, pos) - hist(ref2, pos)).sum()
        tv = 0.5 * np.abs(hist(ref, pos) - hist(out, pos)).sum()
        assert tv < null_tv + 0.12, (pos, tv, null_tv)


# ------------------------------------------------------------ trainer steps
VARIANTS = {"ac_reward": ["trainer.use_ac_reward=true"],
            "wm_logprob": ["trainer.reward_fn=wm_logprob"],
            "remax": ["algorithm.adv_estimator=remax"]}
VAL_ITERS = 2


@pytest.fixture(scope="module")
def jax_variants(tiny_params, tmp_path_factory):
    """The reference trainer's training_step for each variant and its
    validate(), from the same weights and first batch, with the draws they
    made.  Later trainers reuse the first one's compiled stages (the first
    is a GRPO-advantage one: its `_advantage` is the one they call)."""
    _, params = tiny_params
    mesh = make_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    out, first = {}, None
    for name, extra in [*VARIANTS.items(), ("validate", [f"trainer.val_iters={VAL_ITERS}"])]:
        argv = _tiny_overrides(tmp_path_factory.mktemp("j")) + extra
        cfg = j_default_config().apply_overrides(argv)
        cfg.mesh = {"dp": 1, "fsdp": 1, "tp": 1, "sp": 1}
        tr = JTrainer(cfg, preset="tiny", mesh=mesh, params=params)
        if first is not None:
            for fn in STAGE_FNS:
                setattr(tr, fn, getattr(first, fn))
        first = first or tr
        n = cfg.actor_rollout_ref.rollout.n
        if name == "validate":
            # the draws of validate(): key(seed + 99) split per batch
            val = JDataset(tr.val_dataset.cfg)
            rng, pinned = jax.random.key(tr._seed + 99), []
            for _ in range(VAL_ITERS):
                jb = {k: jnp.asarray(v) for k, v in val.next_batch().items()}
                rng, r_noise, r_roll, _, _ = jax.random.split(rng, 5)
                pinned.append(_jax_rollout(tr, jb, n, r_noise, r_roll)[1])
            out[name] = dict(argv=argv, metrics=tr.validate(), pinned=pinned)
            continue
        batch = tr.dataset.next_batch()
        key = jax.random.key(11)
        r_noise, r_roll, _, _, _ = jax.random.split(key, 5)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        hidden_u, rollout = _jax_rollout(tr, jb, n, r_noise, r_roll)
        base = tr._rollout_det(tr.params["expert"], r_roll, hidden_u,
                               tr._sample_noisy(jax.random.fold_in(r_noise, 1_000_003),
                                                jb["actions"])["noise"],
                               jb["proprio"])["predicted_actions"]
        out[name] = dict(argv=argv, batch=batch, metrics=tr.training_step(batch, key),
                         pinned={**rollout, "base_actions": np.asarray(base, np.float32)})
    return out


def _jax_rollout(tr, jb, n, r_noise, r_roll):
    """(the unique context, {"noise": the sample_noisy_actions dict and
    "rollout": the flow rollout of the B*n rows}) as training_step and
    validate draw them."""
    hidden_u = tr._encode(tr.params["vla"], {
        "input_ids": jb["input_ids"], "attention_mask": jb["attention_mask"],
        "labels": jb["labels"], "pixels": jb["pixel_values"]})
    noise = tr._sample_noisy(r_noise, jnp.repeat(jb["actions"], n, axis=0))
    rollout = tr._rollout(tr.params["expert"], r_roll, jnp.repeat(hidden_u, n, axis=0),
                          noise["noise"], jnp.repeat(jb["proprio"], n, axis=0))
    f32 = lambda d: {k: np.asarray(v, np.float32) for k, v in d.items()}
    return hidden_u, {"noise": f32(noise), "rollout": f32(rollout)}


def _bf16(pinned):
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return {k: ({kk: to(vv) for kk, vv in v.items()} if isinstance(v, dict) else to(v))
            for k, v in pinned.items()}


def _port_trainer(tiny_params, argv):
    _, params = tiny_params
    cfg = vla_rft_default_config().apply_overrides(argv)
    return TTrainer(cfg, preset="tiny", device="cpu",
                    params={m: flax_to_torch(params[m], m) for m in MODULES})


def _close(got, ref):
    return abs(got - ref) <= 1e-3 * abs(ref) + 1e-5


@pytest.mark.slow  # the module's JAX trainers compile for about 65 s on the CPU
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_tiny_variant_step_matches_jax(tiny_params, jax_variants, variant):
    s = jax_variants[variant]
    tr = _port_trainer(tiny_params, s["argv"])
    metrics = tr.training_step(s["batch"], step=1, pinned=_bf16(s["pinned"]))
    ref = {k: float(v) for k, v in s["metrics"].items()}
    keys = {"ac_reward": ["critic/l1_loss/mean"],
            "wm_logprob": ["critic/wm_dyn_logprob/mean", "critic/recon_loss/mean",
                           "critic/perceptual_loss/mean"],
            "remax": ["critic/reward_baseline/mean", "critic/recon_loss/mean",
                      "critic/perceptual_loss/mean", "critic/advantages/mean"]}[variant]
    keys += [k for k in COMPARED if k in ref and "loss/mean" not in k]
    assert set(keys) <= set(metrics) and set(keys) <= set(ref), set(keys) - set(metrics)
    for k in keys:
        assert _close(metrics[k], ref[k]), (k, metrics[k], ref[k])
    assert ("timing_s/ac_reward" in metrics) == (variant == "ac_reward")
    assert ("timing_s/wm_rollout" in metrics) == (variant != "ac_reward")


@pytest.mark.slow  # shares test_tiny_variant_step_matches_jax's JAX trainers
def test_validate_matches_jax(tiny_params, jax_variants, tmp_path):
    s = jax_variants["validate"]
    tr = _port_trainer(tiny_params, s["argv"] + [f"trainer.img_save_dir={tmp_path}"])
    got = tr.validate(pinned=[_bf16(p) for p in s["pinned"]])
    ref = {k: float(v) for k, v in s["metrics"].items()}
    assert set(got) == set(ref) and ref["val/on_train_stream"] == got["val/on_train_stream"] == 0
    for k in ref:
        assert _close(got[k], ref[k]), (k, got[k], ref[k])
    (png,) = os.listdir(tmp_path)
    assert png.startswith("0_val_frames_reward") and png.endswith(".png")
    F, S = tr.bundle.reward_cfg.num_frames, tr.bundle.image_size
    assert _read_png(os.path.join(tmp_path, png)).shape == (3 * S, F * S, 3)


# ------------------------------------------------------------------ the CLI
@pytest.mark.parametrize("overrides", [
    ["algorithm.adv_estimator=remax"], ["trainer.use_ac_reward=true"],
    ["trainer.reward_fn=wm_logprob"],
    ["trainer.val_before_train=true", "trainer.test_freq=1", "trainer.val_iters=1"],
    ["world_model_rollout.rollout.speculative_k=7", "algorithm.adv_estimator=remax"],
], ids=["remax", "ac_reward", "wm_logprob", "validation", "speculative"])
def test_cli_runs_the_ported_surface(tmp_path, overrides):
    seen = []
    tr = main_vla_rft_grpo.run(
        ["--preset=tiny", "--device=cpu"] + _tiny_overrides(tmp_path)
        + ["trainer.total_training_steps=1", "trainer.save_freq=-1", "trainer.save_last_freq=-1"]
        + overrides, on_step_end=lambda step, m: seen.append(dict(m)))
    (m,) = seen
    assert tr.global_steps == 2 and all(np.isfinite(v) for v in m.values())
    if "algorithm.adv_estimator=remax" in overrides:
        assert "critic/reward_baseline/mean" in m
    if any("speculative_k" in o for o in overrides):
        assert m["wm_rollout/verify_calls"] > 0 and 0 <= m["wm_rollout/acceptance_rate"] <= 1
