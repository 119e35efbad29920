"""The port's policy modules against the JAX package, f32 on the CPU.

Each test builds the JAX module and the port's module with the same weights
(random numpy leaves in the shapes of the Flax tree, converted by
`convert.flax_to_torch`),
feeds both the same numpy inputs and compares the outputs.  Tolerances are
f32 round-off through a few layers: atol/rtol 1e-4 for hidden states and
logits, 5e-4 for actions after 10 Euler steps (the chain is kept in bf16 by
both implementations, so a difference would show as a whole bf16 step).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vla_rft_tpu.config import vla_rft_default_config
from vla_rft_tpu.models import transformer as j_tf
from vla_rft_tpu.models import vit as j_vit
from vla_rft_tpu.models.action_masks import ACTION_TOKEN_BEGIN_IDX
from vla_rft_tpu.models.factory import build_models, init_params
from vla_rft_tpu.workers.flow_actor import encode_context as j_encode_context
from vla_rft_tpu.workers.predict import predict_action as j_predict_action
from vla_rft_tpu_torch.convert import flax_to_torch
from vla_rft_tpu_torch.models import transformer as t_tf
from vla_rft_tpu_torch.models import vit as t_vit
from vla_rft_tpu_torch.models.factory import build_policy
from vla_rft_tpu_torch.workers.predict import encode_context, predict_action

ATOL = RTOL = 1e-4
ACTION_ATOL = 5e-4


def _random_tree(shapes, seed):
    """Numpy leaves for a Flax tree of shapes: near one for norm scales and
    LayerScale gammas, N(0, 0.05) elsewhere, so zero-initialised leaves such
    as adaLN and the action queries take part in the comparison."""
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = str(getattr(path[-1], "key", path[-1])).lower()
        noise = rng.normal(scale=0.05, size=sd.shape).astype(np.float32)
        return noise + 1.0 if name in ("scale", "weight") or "gamma" in name else noise

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def policies():
    """The JAX package's tiny VLA + expert (`build_models(preset="tiny")`,
    parameter shapes from `init_params`) and the port's tiny policy carrying
    the same weights."""
    bundle = build_models(vla_rft_default_config(), preset="tiny")
    shapes = jax.eval_shape(lambda key: init_params(bundle, key), jax.random.key(0))
    vp, ep = _random_tree(shapes["vla"], 0), _random_tree(shapes["expert"], 1)
    port = build_policy("tiny", device="cpu")
    port.vla.load_state_dict(flax_to_torch(vp, "vla"), strict=True)
    port.expert.load_state_dict(flax_to_torch(ep, "expert"), strict=True)
    return dict(vla=bundle.vla, expert=bundle.expert, vp=vp, ep=ep, vcfg=bundle.vla_cfg,
                port=port)


def _batch(seed, vcfg, B=2, S=32):
    rng = np.random.default_rng(seed)
    n = vcfg.num_tokens
    labels = np.full((B, S), -100, np.int64)
    aids = ACTION_TOKEN_BEGIN_IDX + 1 + rng.integers(0, 64, (B, n))
    labels[:, 10: 10 + n] = aids
    ids = rng.integers(5, 1000, (B, S))
    ids[:, 10: 10 + n] = aids
    mask = np.ones((B, S), np.int64)
    mask[1, 24:] = 0  # right padding on row 1
    pixels = rng.uniform(size=(B, 28, 28, 6)).astype(np.float32)
    proprio = rng.normal(size=(B, 8)).astype(np.float32)
    jb = {
        "input_ids": jnp.asarray(ids, jnp.int32), "labels": jnp.asarray(labels, jnp.int32),
        "attention_mask": jnp.asarray(mask, jnp.int32), "pixels": jnp.asarray(pixels),
        "proprio": jnp.asarray(proprio),
    }
    tb = {
        "input_ids": torch.as_tensor(ids), "labels": torch.as_tensor(labels),
        "attention_mask": torch.as_tensor(mask), "pixels": torch.as_tensor(pixels),
        "proprio": torch.as_tensor(proprio),
    }
    return jb, tb


DECODERS = {
    # the Qwen shape: GQA with qkv bias and tied embeddings
    "qwen_tiny": dict(num_heads=4, num_kv_heads=2, qkv_bias=True, tie_word_embeddings=True,
                      rope_theta=1_000_000.0),
    # the LLaMA shape: MHA, no bias, an lm_head
    "llama_tiny": dict(num_heads=4, num_kv_heads=4, qkv_bias=False,
                       tie_word_embeddings=False),
}


@pytest.mark.parametrize("name", list(DECODERS))
def test_decoder_full_forward_matches_jax(name):
    kw = dict(vocab_size=97, hidden_size=64, intermediate_size=128, num_layers=2,
              **DECODERS[name])
    jcfg = j_tf.TransformerConfig(dtype=jnp.float32, param_dtype=jnp.float32,
                                  attn_impl="xla", **kw)
    tcfg = t_tf.TransformerConfig(dtype=torch.float32, param_dtype=torch.float32, **kw)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 97, (2, 12))
    kv_lens = np.asarray([12, 7], np.int32)
    jdec = j_tf.Decoder(jcfg)
    params = _random_tree(jax.eval_shape(jdec.init, jax.random.key(0), jnp.asarray(ids)), 2)
    jl, jh, _ = jdec.apply(params, jnp.asarray(ids), kv_lens=jnp.asarray(kv_lens))
    tdec = t_tf.Decoder(tcfg)
    tdec.load_state_dict(flax_to_torch(params, "decoder"), strict=True)
    with torch.no_grad():
        tl, th = tdec(torch.as_tensor(ids), kv_lens=torch.as_tensor(kv_lens))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("tower", ["featurizer", "fused_featurizer"])
def test_vit_tower_matches_jax(policies, tower):
    vcfg = policies["vcfg"]
    jcfg = vcfg.dino if tower == "featurizer" else vcfg.siglip
    tree = policies["vp"]["params"]["vision_backbone"][tower]
    images = np.random.default_rng(6).normal(size=(2, 28, 28, 3)).astype(np.float32)
    ref = j_vit.ViT(jcfg).apply({"params": tree}, jnp.asarray(images))
    tcfg = dataclasses.replace(
        t_vit.ViTConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
                           if f.name not in ("dtype", "param_dtype")}),
        dtype=torch.float32, param_dtype=torch.float32,
    )
    vit = t_vit.ViT(tcfg)
    vit.load_state_dict(flax_to_torch(tree, "vit"), strict=True)
    with torch.no_grad():
        out = vit(torch.from_numpy(images))
    assert out.shape == (2, jcfg.num_patches, jcfg.hidden_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_encode_context_matches_jax(policies):
    p = policies
    jb, tb = _batch(7, p["vcfg"])
    ref = np.asarray(jax.jit(j_encode_context, static_argnums=0)(p["vla"], p["vp"], jb))
    with torch.no_grad():
        out = encode_context(p["port"].vla, tb).numpy()
    assert out.shape == ref.shape == (2, 4 + 8, 32)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_predict_action_matches_jax_with_injected_noise(policies):
    p = policies
    jb, tb = _batch(8, p["vcfg"])
    key = jax.random.key(3)
    ref = np.asarray(
        jax.jit(j_predict_action, static_argnums=(0, 1, 6))(
            p["vla"], p["expert"], p["vp"], p["ep"], key, jb, 10
        ), np.float32,
    )
    # predict_action draws its start point exactly so: f32 normal -> bf16
    noise = np.array(jax.random.normal(key, (2, 8, 7), jnp.float32))
    out = predict_action(
        p["port"].vla, p["port"].expert, tb, 10, noise=torch.from_numpy(noise)
    ).float().numpy()
    assert out.shape == (2, 8, 7) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=ACTION_ATOL, rtol=0)
