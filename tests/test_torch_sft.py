"""The port's supervised fine-tuning path against the JAX package, on the CPU.

Each trainer pair starts from the same weights (random numpy leaves in the
shapes of the Flax tree, converted by `convert.flax_to_torch`), sees the
same batches and the same noise dicts (drawn once by the reference's
`sample_noisy_actions` and handed to both), and takes 2 steps.  The JAX
side runs the reference trainer's own `_loss`, `jax.value_and_grad` and
`tx.update` (one jitted step per module).  All f32.  Tolerances:
* loss at each step within 1e-5 (relative), the global gradient norm within
  1e-5 (relative): the same f32 function summed in another order;
* every parameter after 2 steps within atol 2e-6 / rtol 1e-5 (VLA and
  expert, lr <= 1e-4) or atol 2e-5 / rtol 1e-4 (the text decoder at lr
  1.25e-3 after warmup): Adam divides each gradient by its own running
  size, so a gradient element near zero moves its parameter by up to lr
  per step whatever its f32 round-off;
* frozen parameters bit-identical to their start, on both sides.
Also: `noisy_actions` equals the reference's flow-matching dict bit for bit,
`SyntheticVLADataset` batches equal the reference's bit for bit, and
`main_sft.run` trains every mode in process (text from a parquet and an HF
tokenizer directory; vla_align on synthetic captions and on a chat JSON)
and refuses a missing tokenizer path and unknown modes.
"""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import sft_data

from vla_rft_tpu.config import vla_rft_default_config
from vla_rft_tpu.data import synthetic as j_synth
from vla_rft_tpu.models.action_head import sample_noisy_actions as j_sample_noisy
from vla_rft_tpu.models.factory import build_models, init_params
from vla_rft_tpu.models.transformer import TransformerConfig as JTransformerConfig
from vla_rft_tpu.parallel.mesh import MeshConfig, make_mesh
from vla_rft_tpu.trainer import sft_trainer as j_sft
from vla_rft_tpu_torch.convert import flax_to_torch
from vla_rft_tpu_torch.data import synthetic as t_synth
from vla_rft_tpu_torch.models.action_head import noisy_actions
from vla_rft_tpu_torch.models.factory import build_decoder, build_policy
from vla_rft_tpu_torch.models.transformer import TransformerConfig
from vla_rft_tpu_torch.trainer import main_sft
from vla_rft_tpu_torch.trainer import sft_trainer as t_sft
from vla_rft_tpu_torch.trainer.optim import global_norm

LOSS_RTOL = NORM_RTOL = 1e-5
VLA_TOL = dict(atol=2e-6, rtol=1e-5)
TEXT_TOL = dict(atol=2e-5, rtol=1e-4)
STEPS = 2


def _random_tree(shapes, seed):
    """Numpy leaves: near one for norm scales and LayerScale gammas,
    N(0, 0.05) elsewhere (as tests/test_torch_policy.py)."""
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = str(getattr(path[-1], "key", path[-1])).lower()
        noise = rng.normal(scale=0.05, size=sd.shape).astype(np.float32)
        return noise + 1.0 if name in ("scale", "weight") or "gamma" in name else noise

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_step(loss_fn, tx):
    """The reference trainers' `_train_step` body with the noise dict passed
    in: value_and_grad -> tx.update -> apply_updates, plus the global norm."""

    def step(params, opt_state, *args):
        loss, grads = jax.value_and_grad(loss_fn)(params, *args)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, optax.global_norm(grads)

    return jax.jit(step)


def _to_torch_noise(nd):
    """The reference's noise dict (bf16 leaves) as torch bf16 tensors."""
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
            for k, v in nd.items()}


def _assert_state_close(port_module, tree, which, tol, skip=()):
    ref = flax_to_torch(jax.tree_util.tree_map(np.asarray, tree), which)
    got = port_module.state_dict()
    assert set(ref) == set(got)
    for k, v in got.items():
        if any(s in k for s in skip):
            continue
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), err_msg=k, **tol)


# ------------------------------------------------------------- VLA trainers
@pytest.fixture(scope="module")
def vla_setup():
    """The reference's tiny bundle and weights, its VLAAdapterSFTTrainer
    (vision towers frozen) and VLAFlowSFTTrainer with jitted steps, and the
    data and noise of 2 steps."""
    bundle = build_models(vla_rft_default_config(), preset="tiny")
    shapes = jax.eval_shape(lambda key: init_params(bundle, key), jax.random.key(0))
    vp, ep = _random_tree(shapes["vla"], 0), _random_tree(shapes["expert"], 1)
    adapter = j_sft.VLAAdapterSFTTrainer(bundle.vla, bundle.expert, vp, ep,
                                         freeze_vision_backbone=True)
    flow = j_sft.VLAFlowSFTTrainer(bundle.expert, ep, lr=1e-4)
    data = j_synth.SyntheticVLADataset(j_synth.SyntheticVLAConfig(
        batch_size=2, seq_len=bundle.policy_seq_len, num_action_tokens=bundle.vla_cfg.num_tokens,
        policy_image_size=bundle.policy_image_size, wm_image_size=bundle.wm_image_size,
        num_frames=bundle.num_raw_frames, action_chunk=bundle.expert_cfg.num_actions_chunk,
        action_dim=bundle.expert_cfg.action_dim, proprio_dim=bundle.vla_cfg.proprio_dim,
        seed=3))
    batches, noise = [], []
    for i in range(STEPS):
        b = data.next_batch()
        batches.append({"input_ids": b["input_ids"], "attention_mask": b["attention_mask"],
                        "labels": b["labels"], "pixels": b["pixel_values"],
                        "proprio": b["proprio"], "actions": b["actions"]})
        noise.append(j_sample_noisy(jax.random.key(i), jnp.asarray(b["actions"]),
                                    bundle.expert_cfg))
    return dict(bundle=bundle, vp=vp, ep=ep, adapter=adapter, flow=flow, batches=batches,
                noise=noise, adapter_step=_jax_step(adapter._loss, adapter.tx),
                flow_step=_jax_step(flow._loss, flow.tx))


def _port_policy(s):
    port = build_policy("tiny", device="cpu", trainable=True)
    port.vla.load_state_dict(flax_to_torch(s["vp"], "vla"), strict=True)
    port.expert.load_state_dict(flax_to_torch(s["ep"], "expert"), strict=True)
    return port


def test_vla_adapter_trainer_matches_jax(vla_setup):
    s = vla_setup
    port = _port_policy(s)
    tr = t_sft.VLAAdapterSFTTrainer(port.vla, port.expert, freeze_vision_backbone=True)
    frozen = {k: v.clone() for k, v in port.vla.state_dict().items() if "featurizer" in k}
    assert frozen and all(tr.labels[f"vla.{k}"] == "frozen" for k in frozen)
    params, opt_state = s["adapter"].params, s["adapter"].opt_state
    for batch, nd in zip(s["batches"], s["noise"]):
        params, opt_state, j_loss, j_norm = s["adapter_step"](
            params, opt_state, {k: jnp.asarray(v) for k, v in batch.items()}, nd)
        tb = t_sft.to_device(batch, "cpu")
        loss = tr.compute_loss(tb, _to_torch_noise(nd))
        grads = tr.backward(loss)
        norm = tr.update(grads)
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(norm), float(j_norm), rtol=NORM_RTOL)
        # the frozen towers' gradients are in the clipped norm, as in optax
        n_frozen = sum(1 for v in tr.labels.values() if v == "frozen")
        assert float(global_norm(grads[:-n_frozen])) < float(norm)
    _assert_state_close(port.vla, params["vla"], "vla", VLA_TOL)
    _assert_state_close(port.expert, params["expert"], "expert", VLA_TOL)
    after = port.vla.state_dict()
    j_after = flax_to_torch(jax.tree_util.tree_map(np.asarray, params["vla"]), "vla")
    for k, v in frozen.items():
        assert torch.equal(after[k], v) and torch.equal(j_after[k], v), k
    moved = [k for k, v in after.items() if "language_model" in k
             and not torch.equal(v, flax_to_torch(s["vp"], "vla")[k])]
    assert moved  # the LLM trains


def test_vla_flow_trainer_matches_jax(vla_setup):
    s = vla_setup
    port = _port_policy(s)
    tr = t_sft.VLAFlowSFTTrainer(port.expert, lr=1e-4)
    rng = np.random.default_rng(4)
    cfg = s["bundle"].vla_cfg
    hidden = rng.normal(size=(2, cfg.total_patches + cfg.num_tokens, cfg.llm.hidden_size))
    hidden = hidden.astype(np.float32)
    params, opt_state = s["flow"].params, s["flow"].opt_state
    for batch, nd in zip(s["batches"], s["noise"]):
        params, opt_state, j_loss, j_norm = s["flow_step"](
            params, opt_state, jnp.asarray(hidden), jnp.asarray(batch["actions"]),
            jnp.asarray(batch["proprio"]), nd)
        loss = tr.training_step(None, torch.from_numpy(hidden), torch.from_numpy(batch["actions"]),
                                torch.from_numpy(batch["proprio"]), _to_torch_noise(nd))
        np.testing.assert_allclose(loss, float(j_loss), rtol=LOSS_RTOL)
    _assert_state_close(port.expert, params, "expert", VLA_TOL)


def test_noisy_actions_equal_the_reference_bit_for_bit(vla_setup):
    s = vla_setup
    for batch, nd in zip(s["batches"], s["noise"]):
        got = noisy_actions(_to_torch_noise(nd)["noise"], _to_torch_noise(nd)["gt_timesteps"],
                            torch.from_numpy(batch["actions"]))
        for k, v in got.items():
            assert v.dtype == torch.bfloat16, k
            np.testing.assert_array_equal(v.float().numpy(), np.asarray(nd[k], np.float32),
                                          err_msg=k)


# ------------------------------------------------------------- text SFT
# tests/test_sft.py's tiny decoder
CFG = dict(vocab_size=50, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
           num_kv_heads=4)


def test_text_sft_trainer_matches_jax():
    jcfg = JTransformerConfig(dtype=jnp.float32, param_dtype=jnp.float32, attn_impl="xla", **CFG)
    mesh = make_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    jt = j_sft.SFTTrainer(jcfg, lr=5e-3, warmup_steps=4, mesh=mesh)
    tcfg = TransformerConfig(dtype=torch.float32, param_dtype=torch.float32, **CFG)
    llm = build_decoder(tcfg, device="cpu")
    llm.load_state_dict(flax_to_torch(jax.tree_util.tree_map(np.asarray, jt.params), "decoder"),
                        strict=True)
    tt = t_sft.SFTTrainer(tcfg, lr=5e-3, warmup_steps=4, llm=llm)
    step = _jax_step(jt._loss, jt.tx)
    rng = np.random.default_rng(0)
    params, opt_state = jt.params, jt.opt_state
    for _ in range(STEPS):
        ids = rng.integers(3, 50, (3, 12)).astype(np.int32)
        attn = np.ones((3, 12), np.int32)
        attn[1, 9:], attn[2, 5:] = 0, 0  # right padding
        labels = np.where(attn > 0, ids, -100).astype(np.int32)
        labels[:, :4] = -100  # the prompt
        batch = {"input_ids": ids, "labels": labels, "attention_mask": attn}
        params, opt_state, j_loss, _ = step(params, opt_state,
                                            {k: jnp.asarray(v) for k, v in batch.items()})
        loss = tt.training_step(batch)
        np.testing.assert_allclose(loss, float(j_loss), rtol=LOSS_RTOL)
    assert tt.groups[0].count == STEPS
    _assert_state_close(llm, params, "decoder", TEXT_TOL)


# ------------------------------------------------------------- data and CLI
@pytest.mark.parametrize("shape", ["tiny", "libero_widths"])
def test_synthetic_dataset_equals_the_reference_bit_for_bit(shape):
    kw = dict(batch_size=2, seed=5)
    if shape == "tiny":
        kw.update(seq_len=32, num_action_tokens=8, policy_image_size=28, wm_image_size=32)
    else:  # libero widths at batch 2: 96 tokens, 224 px policy and 256 px WM frames
        kw.update(num_images=2)
    ref = j_synth.SyntheticVLADataset(j_synth.SyntheticVLAConfig(**kw))
    port = t_synth.SyntheticVLADataset(t_synth.SyntheticVLAConfig(**kw))
    port.load_state_dict({"step": 1})
    ref.load_state_dict(port.state_dict())
    for _ in range(2):
        a, b = ref.next_batch(), port.next_batch()
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("mode,tag", [("vla_flow", "flow_bc_loss"),
                                      ("vla_adapter", "adapter_bc_loss")])
def test_main_sft_runs_in_process_on_cpu(mode, tag, capsys):
    seen = []
    res = main_sft.run(["--preset=tiny", "--device=cpu", f"sft.mode={mode}",
                        "trainer.total_training_steps=2", "data.train_batch_size=2",
                        "sft.freeze_llm=true"], on_step=lambda i, loss, sec: seen.append(i))
    out = capsys.readouterr().out
    assert f"[sft step 2] {tag}" in out and seen == [1, 2]
    assert len(res.losses) == 2 and np.isfinite(res.losses).all()


@pytest.fixture
def auto_tokenizer(monkeypatch):
    """transformers.AutoTokenizer as the PreTrainedTokenizerFast it gives for
    a directory that sft_data.write_word_tokenizer wrote, keeping the paths
    it is asked for (transformers' auto classes take some 9 s to import on
    the CPU; the card's sft_text and sft_align phases load through the real
    one)."""
    import transformers
    from transformers import PreTrainedTokenizerFast

    paths = []

    class AutoTokenizer:
        @staticmethod
        def from_pretrained(path, *args, **kwargs):
            paths.append(str(path))
            return PreTrainedTokenizerFast.from_pretrained(path, *args, **kwargs)

    monkeypatch.setitem(transformers.__dict__, "AutoTokenizer", AutoTokenizer)
    return paths


def test_main_sft_text_runs_in_process_on_cpu(tmp_path, monkeypatch, capsys, auto_tokenizer):
    """sft.mode=text from a parquet and an HF tokenizer directory (read
    from actor_rollout_ref.model.ckpt_path), with the Qwen2.5-0.5B config
    cut to a tiny one."""
    words = sft_data.write_sft_parquet(str(tmp_path / "train.parquet"), 6, (4, 40), 30, seed=0)
    sft_data.write_word_tokenizer(str(tmp_path / "tok"), [" ".join(words)])
    tiny = TransformerConfig(dtype=torch.float32, param_dtype=torch.float32, qkv_bias=True,
                             tie_word_embeddings=True, **dict(CFG, num_kv_heads=2))
    monkeypatch.setattr(main_sft.TransformerConfig, "qwen25_0_5b", staticmethod(lambda: tiny))
    res = main_sft.run(["--device=cpu", "sft.mode=text", "trainer.total_training_steps=2",
                        f"data.train_files={tmp_path / 'train.parquet'}",
                        f"actor_rollout_ref.model.ckpt_path={tmp_path / 'tok'}",
                        "data.train_batch_size=2", "data.max_prompt_length=16",
                        "data.max_response_length=8", "actor_rollout_ref.actor.optim.lr=1e-3"])
    out = capsys.readouterr().out
    assert "[sft step 1] loss " in out and "[sft step 2] loss " in out
    assert res.bundle is None and res.trainer.llm.cfg is tiny
    assert auto_tokenizer == [str(tmp_path / "tok")]
    assert len(res.losses) == 2 and np.isfinite(res.losses).all()
    assert res.trainer.groups[0].count == 2


@pytest.mark.parametrize("route", ["synthetic", "align", "finetune"])
def test_main_sft_vla_align_runs_in_process_on_cpu(route, tmp_path, capsys, request):
    """sft.mode=vla_align at the tiny preset: synthetic captions, or a chat
    JSON (tokenizer from actor_rollout_ref.model.path, not ckpt_path); only
    the projector moves."""
    argv = ["--preset=tiny", "--device=cpu", "sft.mode=vla_align",
            "trainer.total_training_steps=2", "data.train_batch_size=2"]
    loaded = []
    if route != "synthetic":
        loaded = request.getfixturevalue("auto_tokenizer")
        paths = sft_data.write_chat_data(str(tmp_path), size=32, n_images=4, n_align=3)
        sft_data.write_word_tokenizer(str(tmp_path / "tok"), paths["texts"])
        argv += [f"sft.chat_json={paths[route]}", f"sft.stage={route}",
                 f"sft.image_dir={tmp_path}", f"actor_rollout_ref.model.path={tmp_path / 'tok'}",
                 f"actor_rollout_ref.model.ckpt_path={tmp_path / 'not_read'}"]
    start = build_policy("tiny", device="cpu", trainable=True).vla.state_dict()
    res = main_sft.run(argv)
    out = capsys.readouterr().out
    assert "[align 1] loss " in out and "[align 2] loss " in out
    assert len(res.losses) == 2 and np.isfinite(res.losses).all()
    assert loaded == ([] if route == "synthetic" else [str(tmp_path / "tok")])
    for k, v in res.bundle.vla.state_dict().items():
        assert torch.equal(v, start[k]) != k.startswith("projector."), k


def test_main_sft_refuses_a_missing_tokenizer_path_and_unknown_modes():
    with pytest.raises(SystemExit, match="ckpt_path is required for text SFT"):
        main_sft.run(["--device=cpu", "sft.mode=text"])
    with pytest.raises(SystemExit, match="unknown sft.mode 'vla_pretrain'"):
        main_sft.run(["--device=cpu", "sft.mode=vla_pretrain"])
