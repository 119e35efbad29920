"""The port's tokenizer, LPIPS and MSP reward against the JAX package, on the CPU.

All weights are f32 (random numpy leaves in the Flax trees' shapes, or the
trained push tokenizer), inputs come from numpy with fixed seeds, and each
port module gets its weights through `convert.flax_to_torch`.

* FSQ codes and indices: equal.
* Tokenizer: `tokenize` indices equal, `detokenize` / `ctx_decode` pixels
  within atol 1e-4 (f32 convolutions summed in another order); the trained
  push tokenizer (artifacts/rft_evidence32/tokenizer.npz) gives the same
  codes on recorded frames (segments.npz).
* LPIPS and `msp_reward`, with and without `gt_responses`: within
  atol/rtol 1e-4 in f32.
* The whole slice at the tiny preset (process -> greedy shared-prefix
  rollout with each sample's gt row after its n rollouts -> context
  features -> gt frames decoded once -> reward): tokens equal, rewards
  within atol/rtol 1e-4.
"""
import os
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vla_rft_tpu.config import vla_rft_default_config
from vla_rft_tpu.models import fsq as j_fsq
from vla_rft_tpu.models.factory import build_models
from vla_rft_tpu.models.tokenizers import CompressiveVQModelFSQ as JTokenizer
from vla_rft_tpu.workers import processor as j_proc
from vla_rft_tpu.workers import reward as j_reward
from vla_rft_tpu.workers import wm_rollout as j_roll
from vla_rft_tpu_torch.convert import flax_to_torch
from vla_rft_tpu_torch.models import fsq as t_fsq
from vla_rft_tpu_torch.models.factory import build_wm_reward
from vla_rft_tpu_torch.models.tokenizers import CompressiveVQModelFSQ as TTokenizer
from vla_rft_tpu_torch.models.tokenizers import TokenizerConfig
from vla_rft_tpu_torch.workers import processor as t_proc
from vla_rft_tpu_torch.workers import reward as t_reward
from vla_rft_tpu_torch.workers import wm_rollout as t_roll

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVIDENCE = os.path.join(ROOT, "artifacts", "rft_evidence32")
ATOL = RTOL = 1e-4
PUSH_TOKENIZER = dict(block_out_channels=(16, 32, 32), layers_per_block=1, latent_channels=4,
                      norm_num_groups=4, resolution=32, ctx_res=(8, 8), dyn_res=(4, 4),
                      patch_size=2, max_att_resolution=8)


def _random_tree(shapes, seed):
    """N(0, 0.1) leaves; norm scales near 1."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        noise = rng.normal(scale=0.1, size=s.shape).astype(np.float32)
        return noise + 1.0 if name == "scale" else noise

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def tiny():
    """The JAX tiny preset's WM, tokenizer and LPIPS (the tiny CLI run's
    data overrides) with random weights, and the port's tiny bundle
    carrying the same weights."""
    cfg = vla_rft_default_config().apply_overrides([
        "processor.tokens_per_frame=4", "world_model_rollout.rollout.interact_max_tokens=4",
        "data.max_prompt_length=75", "data.max_response_length=88",
    ])
    b = build_models(cfg, preset="tiny")
    key = jax.random.key(0)
    px = jnp.zeros((1, 3, 32, 32, 3))
    im = jnp.zeros((1, 32, 32, 3))
    params = {
        "wm": _random_tree(jax.eval_shape(lambda r: b.wm.init(r, jnp.zeros((1, 8), jnp.int32)),
                                          key), 0),
        "tokenizer": _random_tree(jax.eval_shape(lambda r: b.tokenizer.init(r, px), key), 1),
        "lpips": _random_tree(jax.eval_shape(lambda r: b.lpips.init(r, im, im), key), 2),
    }
    lins = params["lpips"]["params"]
    for name in [k for k in lins if k.startswith("lin")]:
        lins[name]["kernel"] = np.abs(lins[name]["kernel"])  # trained LPIPS heads are >= 0
    port = build_wm_reward("tiny", device="cpu")
    for name in ("wm", "tokenizer", "lpips"):
        getattr(port, name).load_state_dict(flax_to_torch(params[name], name), strict=True)
    return b, params, port


# ------------------------------------------------------------------ FSQ
@pytest.mark.parametrize("levels", [12, 8, 16])
def test_fsq_codes_and_indices_equal_jax(levels):
    rng = np.random.default_rng(levels)
    lv = j_fsq.get_fsq_levels(levels)
    z = (rng.normal(size=(4096, len(lv))) * 2).astype(np.float32)
    jq = j_fsq.FSQ(lv)
    tq = t_fsq.FSQ(t_fsq.get_fsq_levels(levels))
    j_codes, j_idx = jq(jnp.asarray(z))
    t_codes, t_idx = tq(torch.from_numpy(z))
    np.testing.assert_array_equal(t_codes.numpy(), np.asarray(j_codes))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    idx = rng.integers(0, jq.codebook_size, 1000)
    np.testing.assert_array_equal(tq.indices_to_codes(torch.from_numpy(idx)).numpy(),
                                  np.asarray(jq.indices_to_codes(jnp.asarray(idx))))
    np.testing.assert_array_equal(tq.codes_to_indices(tq.indices_to_codes(torch.from_numpy(idx))),
                                  idx)


# ------------------------------------------------------------ tokenizer
def test_tokenize_and_detokenize_match_jax(tiny):
    b, params, port = tiny
    rng = np.random.default_rng(3)
    px = rng.uniform(size=(2, 4, 32, 32, 3)).astype(np.float32)
    jc, jd = jax.jit(lambda p, x: b.tokenizer.apply(p, x, method=b.tokenizer.tokenize))(
        params["tokenizer"], jnp.asarray(px))
    with torch.no_grad():
        tc, td = port.tokenizer.tokenize(torch.from_numpy(px))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    jpix = jax.jit(lambda p, c, d: b.tokenizer.apply(p, c, d, method=b.tokenizer.detokenize))(
        params["tokenizer"], jc, jd)
    with torch.no_grad():
        tpix = port.tokenizer.detokenize(tc, td)
    np.testing.assert_allclose(tpix.numpy(), np.asarray(jpix), atol=ATOL, rtol=RTOL)


def _npz_rows(path, key, n):
    """The first n rows of one array of an .npz, read from the zip stream
    without inflating the rest."""
    with zipfile.ZipFile(path) as zf, zf.open(key + ".npy") as f:
        version = np.lib.format.read_magic(f)
        read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                else np.lib.format.read_array_header_2_0)
        shape, _, dtype = read(f)
        count = n * int(np.prod(shape[1:]))
        return np.frombuffer(f.read(count * dtype.itemsize), dtype).reshape((n,) + shape[1:])


def test_trained_push_tokenizer_codes_equal_jax():
    jt = JTokenizer(**PUSH_TOKENIZER)
    like = jax.eval_shape(lambda r: jt.init(r, jnp.zeros((1, 4, 32, 32, 3))), jax.random.key(0))
    with np.load(os.path.join(EVIDENCE, "tokenizer.npz")) as z:
        leaves, treedef = jax.tree_util.tree_flatten(like)
        assert len(z.files) == len(leaves)
        params = jax.tree_util.tree_unflatten(
            treedef, [np.asarray(z[f"p{i}"], l.dtype) for i, l in enumerate(leaves)])
    tt = TTokenizer(TokenizerConfig(**PUSH_TOKENIZER)).eval()
    tt.load_state_dict(flax_to_torch(params, "tokenizer"), strict=True)
    frames = _npz_rows(os.path.join(EVIDENCE, "segments.npz"), "raw_pixel_values", 4)
    px = frames.astype(np.float32) / 255.0  # (4, 9, 32, 32, 3) recorded push frames
    jc, jd = jax.jit(lambda p, x: jt.apply(p, x, method=jt.tokenize))(params, jnp.asarray(px))
    with torch.no_grad():
        tc, td = tt.tokenize(torch.from_numpy(px))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # the trained tokenizer reconstructs the frames it tokenized
    with torch.no_grad():
        rec = tt.detokenize(tc, td).numpy()
    assert np.abs(rec.clip(0, 1) - px).mean() < 0.1


# ----------------------------------------------------------------- LPIPS
def test_lpips_matches_jax(tiny):
    b, params, port = tiny
    rng = np.random.default_rng(4)
    real = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    pred = np.clip(real + rng.normal(scale=0.3, size=real.shape), -1, 1).astype(np.float32)
    j = jax.jit(b.lpips.apply)(params["lpips"], jnp.asarray(real), jnp.asarray(pred))
    with torch.no_grad():
        t = port.lpips(torch.from_numpy(real), torch.from_numpy(pred))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=RTOL)
    assert (np.asarray(j) > 0).all()  # lin heads are non-negative, as trained LPIPS's


# ------------------------------------------------------------ msp_reward
@pytest.mark.parametrize("with_gt", [False, True])
def test_msp_reward_matches_jax(tiny, with_gt):
    b, params, port = tiny
    rng = np.random.default_rng(5 + with_gt)
    B, F = 3, 8
    per = b.proc_cfg.tokens_per_frame + b.proc_cfg.action_dim
    responses = rng.integers(0, 9008, (B, F * per)).astype(np.int32)
    ctx = (rng.integers(0, 4375, (B, 1, 64)) + 4375).astype(np.int32)
    real = rng.uniform(size=(B, F, 32, 32, 3)).astype(np.float32)
    gt = rng.integers(0, 4375, (B, F * per)).astype(np.int32) if with_gt else None
    j_r, j_m = jax.jit(lambda tp, lp, r, c, rf, g: j_reward.msp_reward(
        b.tokenizer, tp, b.lpips, lp, b.proc_cfg, b.reward_cfg, r, c, real_frames=rf,
        gt_responses=g))(params["tokenizer"], params["lpips"], jnp.asarray(responses),
                         jnp.asarray(ctx), None if with_gt else jnp.asarray(real),
                         None if gt is None else jnp.asarray(gt))
    with torch.no_grad():
        t_r, t_m = t_reward.msp_reward(
            port.tokenizer, port.lpips, port.proc_cfg, port.reward_cfg, torch.from_numpy(responses),
            torch.from_numpy(ctx), real_frames=None if with_gt else torch.from_numpy(real),
            gt_responses=None if gt is None else torch.from_numpy(gt))
    np.testing.assert_allclose(t_r.numpy(), np.asarray(j_r), atol=ATOL, rtol=RTOL)
    for k in j_m:
        np.testing.assert_allclose(t_m[k].item(), float(j_m[k]), atol=ATOL, rtol=RTOL)
    assert (t_r.numpy()[:, :-1] == 0).all() and (t_r.numpy()[:, -1] < 0).all()


# ------------------------------------------------------- the whole slice
def _slice_inputs(seed, B, n):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (B, 9, 32, 32, 3), dtype=np.uint8)
    pred_actions = rng.uniform(-1, 1, (B * n, 8, 7)).astype(np.float32)
    gt_actions = rng.uniform(-1, 1, (B, 8, 7)).astype(np.float32)
    return raw, pred_actions, gt_actions


def _interleave(B_u, n):
    """Row order of the WM call: each sample's n rollouts then its gt row."""
    return np.concatenate([np.concatenate([np.arange(s * n, (s + 1) * n), [B_u * n + s]])
                           for s in range(B_u)])


def _jax_slice(b, params, raw, pred, gt, n, ranges):
    pc, roll = b.proc_cfg, b.wm_roll_cfg

    @jax.jit
    def process(tok_params, raw, pred, gt):  # the trainer's process_fn
        pixels, _ = j_proc.add_context_frame(raw.astype(jnp.float32) / 255.0, gt)
        idx_c, idx_d = b.tokenizer.apply(tok_params, pixels, method=b.tokenizer.tokenize)
        idx_c, idx_d = jnp.repeat(idx_c, n, 0), jnp.repeat(idx_d, n, 0)
        pad = lambda a: jnp.concatenate([a[:, :1], a, a[:, -1:]], axis=1)
        out = j_proc.ctx_msp_process(pc, idx_c, idx_d, pad(pred), ranges)
        gt_ids = j_proc.discretize_actions(pad(jnp.repeat(gt, n, 0))[:, 1:], ranges,
                                           pc.action_bins) + 2 * pc.visual_token_num
        return out, gt_ids

    out, gt_ids = process(params["tokenizer"], jnp.asarray(raw), jnp.asarray(pred),
                          jnp.asarray(gt))
    B_u, total = raw.shape[0], raw.shape[0] * n
    prompt = out["input_ids"][:, : roll.prompt_length]
    p0 = roll.prompt_length - pc.action_dim
    gt_u = gt_ids[::n]
    idx = _interleave(B_u, n)
    pm = np.concatenate([np.arange(B_u).repeat(n), np.arange(B_u)])[idx]
    both = jax.jit(lambda p, i, a, sp, m: j_roll.generate_sequences(
        b.wm, p, jax.random.key(0), i, a, roll, shared_prefix=sp, prefix_map=m,
        prefix_run=n + 1))(params["wm"], jnp.concatenate([prompt[:, p0:], gt_u[:, 0]])[idx],
                           jnp.concatenate([out["action_ids"], gt_u])[idx], prompt[::n, :p0],
                           jnp.asarray(pm, jnp.int32))
    both = both[np.argsort(idx)]
    responses, gt_responses = both[:total], both[total:]
    _, feats = jax.jit(lambda p, c: b.tokenizer.apply(p, c, method=b.tokenizer.ctx_decode))(
        params["tokenizer"], out["ctx_tokens"][::n] - pc.visual_token_num)
    gt_frames = jax.jit(lambda p, g, f: j_reward.detokenize_response_frames(
        b.tokenizer, p, pc, b.reward_cfg.num_frames, g, f, jnp.arange(B_u, dtype=jnp.int32)))(
        params["tokenizer"], gt_responses, feats)
    cmap = jnp.asarray(np.arange(B_u).repeat(n), jnp.int32)
    reward, _ = jax.jit(lambda tp, lp, r, rf, f, m: j_reward.msp_reward(
        b.tokenizer, tp, b.lpips, lp, pc, b.reward_cfg, r, None, real_frames=rf, ctx_feats=f,
        ctx_map=m))(params["tokenizer"], params["lpips"], responses, gt_frames[cmap], feats, cmap)
    return out["input_ids"], responses, gt_responses, reward


def _port_slice(p, raw, pred, gt, n, ranges):
    pc, roll = p.proc_cfg, p.roll_cfg
    pixels, _ = t_proc.add_context_frame(torch.from_numpy(raw).float() / 255.0,
                                         torch.from_numpy(gt))
    idx_c, idx_d = p.tokenizer.tokenize(pixels)
    idx_c, idx_d = idx_c.repeat_interleave(n, 0), idx_d.repeat_interleave(n, 0)
    pad = lambda a: torch.cat([a[:, :1], a, a[:, -1:]], dim=1)
    out = t_proc.ctx_msp_process(pc, idx_c, idx_d, pad(torch.from_numpy(pred)), ranges)
    gt_ids = t_proc.discretize_actions(pad(torch.from_numpy(gt).repeat_interleave(n, 0))[:, 1:],
                                       ranges, pc.action_bins) + 2 * pc.visual_token_num
    B_u, total = raw.shape[0], raw.shape[0] * n
    prompt = out["input_ids"][:, : roll.prompt_length]
    p0 = roll.prompt_length - pc.action_dim
    gt_u = gt_ids[::n]
    idx = torch.from_numpy(_interleave(B_u, n))
    pm = torch.cat([torch.arange(B_u).repeat_interleave(n), torch.arange(B_u)])[idx]
    both = t_roll.generate_sequences(
        p.wm, torch.Generator().manual_seed(0), torch.cat([prompt[:, p0:], gt_u[:, 0]])[idx],
        torch.cat([out["action_ids"], gt_u])[idx], roll, shared_prefix=prompt[::n, :p0],
        prefix_map=pm)
    both = both[torch.argsort(idx)]
    responses, gt_responses = both[:total], both[total:]
    _, feats = p.tokenizer.ctx_decode(out["ctx_tokens"][::n] - pc.visual_token_num)
    gt_frames = t_reward.detokenize_response_frames(p.tokenizer, pc, p.reward_cfg.num_frames,
                                                    gt_responses, feats, torch.arange(B_u))
    cmap = torch.arange(B_u).repeat_interleave(n)
    reward, _ = t_reward.msp_reward(p.tokenizer, p.lpips, pc, p.reward_cfg, responses,
                                    real_frames=gt_frames[cmap], ctx_feats=feats, ctx_map=cmap)
    return out["input_ids"], responses, gt_responses, reward


def test_whole_reward_slice_matches_jax(tiny):
    import dataclasses

    b, params, port = tiny
    # greedy; one cache segment on the JAX side compiles one scan (the
    # segment count bounds cache reads and changes no token)
    b = dataclasses.replace(b, wm_roll_cfg=dataclasses.replace(b.wm_roll_cfg, do_sample=False,
                                                               cache_segments=1))
    port = dataclasses.replace(port, roll_cfg=dataclasses.replace(port.roll_cfg, do_sample=False))
    n = 2
    raw, pred, gt = _slice_inputs(8, 2, n)
    ranges = np.stack([-np.ones(7), np.ones(7)], -1).astype(np.float32)
    j_ids, j_resp, j_gt, j_rew = _jax_slice(b, params, raw, pred, gt, n, jnp.asarray(ranges))
    with torch.no_grad():
        t_ids, t_resp, t_gt, t_rew = _port_slice(port, raw, pred, gt, n, torch.from_numpy(ranges))
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(t_resp.numpy(), np.asarray(j_resp))
    np.testing.assert_array_equal(t_gt.numpy(), np.asarray(j_gt))
    assert t_resp.shape == (4, 88) and t_gt.shape == (2, 88)
    np.testing.assert_allclose(t_rew.numpy(), np.asarray(j_rew), atol=ATOL, rtol=RTOL)
    assert (t_rew.numpy()[:, -1] < 0).all()


def test_processor_matches_jax():
    rng = np.random.default_rng(9)
    B, T, Nc, Nd = 3, 4, 16, 4
    cfg_j, cfg_t = j_proc.ProcessorConfig(tokens_per_frame=Nd), t_proc.ProcessorConfig(
        tokens_per_frame=Nd)
    ctx = rng.integers(0, 4375, (B, 1, Nc)).astype(np.int32)
    dyn = rng.integers(0, 4375, (B, T, Nd)).astype(np.int32)
    acts = rng.uniform(-1.2, 1.2, (B, T, 7)).astype(np.float32)  # some outside the range
    pixels = rng.uniform(size=(B, T, 4, 4, 3)).astype(np.float32)
    ranges = np.stack([-np.ones(7), np.linspace(0.5, 1.0, 7)], -1).astype(np.float32)
    jp, ja = j_proc.add_context_frame(jnp.asarray(pixels), jnp.asarray(acts[:, :-1]))
    tp, ta = t_proc.add_context_frame(torch.from_numpy(pixels), torch.from_numpy(acts[:, :-1]))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    j = j_proc.ctx_msp_process(cfg_j, jnp.asarray(ctx), jnp.asarray(dyn), ja, jnp.asarray(ranges))
    t = t_proc.ctx_msp_process(cfg_t, torch.from_numpy(ctx), torch.from_numpy(dyn), ta,
                               torch.from_numpy(ranges))
    assert set(t) == set(j)
    for k in j:
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]), err_msg=k)
    resp = rng.integers(0, 9008, (B, 2 * (Nd + 7))).astype(np.int32)
    np.testing.assert_array_equal(
        t_proc.split_response_tokens(cfg_t, torch.from_numpy(resp), 2).numpy(),
        np.asarray(j_proc.split_response_tokens(cfg_j, jnp.asarray(resp), 2)))


@pytest.mark.parametrize("aggregate", ["mean", "last", "discount"])
@pytest.mark.parametrize("kind", ["mae", "mse"])
def test_recon_loss_and_aggregate_match_jax(kind, aggregate):
    rng = np.random.default_rng(10)
    real, pred = (rng.uniform(size=(2, 5, 4, 4, 3)).astype(np.float32) for _ in range(2))
    jl = j_reward._recon_loss(jnp.asarray(real), jnp.asarray(pred), kind)
    tl = t_reward._recon_loss(torch.from_numpy(real), torch.from_numpy(pred), kind)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6, rtol=1e-6)
    jc = j_reward.RewardConfig(msp_reward_aggregate=aggregate, num_frames=5)
    tc = t_reward.RewardConfig(msp_reward_aggregate=aggregate, num_frames=5)
    np.testing.assert_allclose(t_reward.aggregate_msp(tl, tc).numpy(),
                               np.asarray(j_reward.aggregate_msp(jl, jc)), atol=1e-6, rtol=1e-6)
