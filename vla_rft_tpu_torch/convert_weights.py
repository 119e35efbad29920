"""Checkpoint converters: torch / HF / timm state dicts -> Flax-layout trees.

A copy of tools/convert_weights.py without JAX: the same pure dict -> dict
maps over numpy arrays (torch tensors accepted, widened to f32), returning
the same trees, which `convert.flax_to_torch` turns into the port's state
dicts.  Families:

* `convert_hf_decoder`: HF LlamaForCausalLM / Qwen2ForCausalLM (the world
  model, the policy's Qwen backbone);
* `convert_timm_vit`, `convert_openvla`: timm SigLIP / DINOv2 towers and
  OpenVLAForActionPrediction;
* `convert_dit`, `convert_action_expert`: the action head, sigma net and
  proprio / noisy-action projector component files (action_head--*.pt ...);
* `convert_compressive_vq`: the CompressiveVQModelFSQ visual tokenizer
  (diffusers-style module names);
* `convert_lpips`: torchvision VGG16 features + the lpips `vgg.pth` heads.

Layer weights are stacked on a leading axis (the Flax `nn.scan` layout),
as the reference does; `flax_to_torch` unstacks them.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().to("cpu").float().numpy()
    return np.asarray(x)


def _stack(tensors: List[np.ndarray]) -> np.ndarray:
    return np.stack(tensors, axis=0)


def _stack_trees(trees: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Trees of one structure -> one tree, each leaf stacked on a new axis 0."""
    return {k: _stack_trees([t[k] for t in trees]) if isinstance(v, dict)
            else _stack([t[k] for t in trees]) for k, v in trees[0].items()}


# ================================================================ LLaMA / Qwen2
def convert_hf_decoder(sd: Dict[str, Any], cfg, prefix: str = "") -> Dict:
    """HF LlamaForCausalLM/Qwen2ForCausalLM state dict -> Decoder params.

    cfg: TransformerConfig. Layer weights are stacked on axis 0 (nn.scan
    layout). HF Linear weights are (out, in) -> transposed to (in, out) and
    attention projections reshaped to DenseGeneral (in, heads, hd) layout.
    """
    L, D = cfg.num_layers, cfg.hidden_size
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd

    def g(key):
        for p in (prefix, "model.", ""):
            k = p + key
            if k in sd:
                return _np(sd[k])
        raise KeyError(f"{prefix}{key} not in state dict")

    def qkv(i, name, n_heads):
        w = g(f"layers.{i}.self_attn.{name}.weight")  # (n*hd, D)
        return w.T.reshape(D, n_heads, hd)

    def qkv_bias(i, name, n_heads):
        return g(f"layers.{i}.self_attn.{name}.bias").reshape(n_heads, hd)

    layers = {
        "input_layernorm": {
            "weight": _stack([g(f"layers.{i}.input_layernorm.weight") for i in range(L)])
        },
        "post_attention_layernorm": {
            "weight": _stack(
                [g(f"layers.{i}.post_attention_layernorm.weight") for i in range(L)]
            )
        },
        "self_attn": {
            "q_proj": {"kernel": _stack([qkv(i, "q_proj", nh) for i in range(L)])},
            "k_proj": {"kernel": _stack([qkv(i, "k_proj", nkv) for i in range(L)])},
            "v_proj": {"kernel": _stack([qkv(i, "v_proj", nkv) for i in range(L)])},
            "o_proj": {
                "kernel": _stack(
                    [
                        g(f"layers.{i}.self_attn.o_proj.weight").T.reshape(nh, hd, D)
                        for i in range(L)
                    ]
                )
            },
        },
        "mlp": {
            "gate_proj": {
                "kernel": _stack([g(f"layers.{i}.mlp.gate_proj.weight").T for i in range(L)])
            },
            "up_proj": {
                "kernel": _stack([g(f"layers.{i}.mlp.up_proj.weight").T for i in range(L)])
            },
            "down_proj": {
                "kernel": _stack([g(f"layers.{i}.mlp.down_proj.weight").T for i in range(L)])
            },
        },
    }
    if cfg.qkv_bias:
        for name, n in (("q_proj", nh), ("k_proj", nkv), ("v_proj", nkv)):
            layers["self_attn"][name]["bias"] = _stack(
                [qkv_bias(i, name, n) for i in range(L)]
            )

    params = {
        "embed_tokens": {"embedding": g("embed_tokens.weight")},
        "layers": layers,
        "norm": {"weight": g("norm.weight")},
    }
    if not cfg.tie_word_embeddings:
        # lm_head lives outside the 'model.' prefix in HF
        for k in ("lm_head.weight", prefix + "lm_head.weight"):
            if k in sd:
                params["lm_head"] = {"kernel": _np(sd[k]).T}
                break
        else:
            raise KeyError("lm_head.weight not found")
    return {"params": params}


# ===================================================================== timm ViT
def convert_timm_vit(sd: Dict[str, Any], cfg, prefix: str = "") -> Dict:
    """timm VisionTransformer state dict -> ViT params.

    Handles: patch_embed.proj (conv OIHW -> HWIO), cls_token, reg_token,
    pos_embed, blocks.N.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2,
    ls1.gamma,ls2.gamma}. The fused qkv is split into q/k/v DenseGeneral.
    """
    D, nh = cfg.hidden_size, cfg.num_heads
    hd = D // nh

    def g(key):
        return _np(sd[prefix + key])

    params: Dict[str, Any] = {
        "patch_embed": {
            "kernel": g("patch_embed.proj.weight").transpose(2, 3, 1, 0),  # OIHW->HWIO
            "bias": g("patch_embed.proj.bias"),
        },
    }
    pos = g("pos_embed")
    if cfg.class_token and not cfg.pos_embed_prefix and pos.shape[1] == cfg.num_patches + 1:
        pos = pos[:, 1:]
    params["pos_embed"] = pos
    if cfg.class_token:
        params["cls_token"] = g("cls_token")
    if cfg.reg_tokens:
        params["reg_tokens"] = g("reg_token")

    blocks: List[Dict[str, Any]] = []
    for i in range(cfg.depth - 1):  # only blocks 0..depth-2 are used (feature tap)
        b = f"blocks.{i}."
        qkv_w = g(b + "attn.qkv.weight")  # (3D, D)
        qkv_b = g(b + "attn.qkv.bias") if prefix + b + "attn.qkv.bias" in sd else None
        qw, kw, vw = np.split(qkv_w, 3, axis=0)
        blk = {
            "norm1": {"scale": g(b + "norm1.weight"), "bias": g(b + "norm1.bias")},
            "norm2": {"scale": g(b + "norm2.weight"), "bias": g(b + "norm2.bias")},
            "q": {"kernel": qw.T.reshape(D, nh, hd)},
            "k": {"kernel": kw.T.reshape(D, nh, hd)},
            "v": {"kernel": vw.T.reshape(D, nh, hd)},
            "proj": {
                "kernel": g(b + "attn.proj.weight").T.reshape(nh, hd, D),
                "bias": g(b + "attn.proj.bias"),
            },
            "mlp_fc1": {"kernel": g(b + "mlp.fc1.weight").T, "bias": g(b + "mlp.fc1.bias")},
            "mlp_fc2": {"kernel": g(b + "mlp.fc2.weight").T, "bias": g(b + "mlp.fc2.bias")},
        }
        if qkv_b is not None:
            qb, kb, vb = np.split(qkv_b, 3, axis=0)
            blk["q"]["bias"] = qb.reshape(nh, hd)
            blk["k"]["bias"] = kb.reshape(nh, hd)
            blk["v"]["bias"] = vb.reshape(nh, hd)
        if cfg.layerscale:
            # reference renames gamma->scale_factor (modeling_prismatic.py:63-66)
            for src in ("ls1.gamma", "ls1.scale_factor"):
                if prefix + b + src in sd:
                    blk["ls1_gamma"] = g(b + src)
            for src in ("ls2.gamma", "ls2.scale_factor"):
                if prefix + b + src in sd:
                    blk["ls2_gamma"] = g(b + src)
        blocks.append(blk)
    # stacked nn.scan layout: one 'blocks' subtree with a leading layer axis
    params["blocks"] = _stack_trees(blocks)
    return params


# ================================================================== OpenVLA VLM
def convert_openvla(sd: Dict[str, Any], vla_cfg) -> Dict:
    """OpenVLAForActionPrediction HF state dict -> OpenVLA params."""
    proj_keys = {"fc1", "fc2", "fc3"}
    params: Dict[str, Any] = {
        "vision_backbone": {
            # featurizer = timm_model_ids[0] = DINOv2; fused = SigLIP
            # (configuration_prismatic.py:36, modeling_prismatic.py:103-113)
            "featurizer": convert_timm_vit(
                sd, vla_cfg.dino, prefix="vision_backbone.featurizer."
            ),
            "fused_featurizer": convert_timm_vit(
                sd, vla_cfg.siglip, prefix="vision_backbone.fused_featurizer."
            ),
        },
        "projector": {
            k: {
                "kernel": _np(sd[f"projector.{k}.weight"]).T,
                "bias": _np(sd[f"projector.{k}.bias"]),
            }
            for k in proj_keys
        },
        "action_queries": {"embedding": _np(sd["action_queries.weight"])},
        "language_model": convert_hf_decoder(
            sd, vla_cfg.llm, prefix="language_model.model."
        )["params"],
    }
    return {"params": params}


# ============================================================== action expert
def _mlp_projector(sd, prefix):
    return {
        "fc1": {"kernel": _np(sd[prefix + "fc1.weight"]).T, "bias": _np(sd[prefix + "fc1.bias"])},
        "fc2": {"kernel": _np(sd[prefix + "fc2.weight"]).T, "bias": _np(sd[prefix + "fc2.bias"])},
    }


def convert_dit(sd: Dict[str, Any], dit_cfg, prefix: str) -> Dict:
    """DiT_SingleTokenAction_OneCtx torch module -> DiTSingleTokenActionOneCtx."""
    D = dit_cfg.hidden_size
    nh = dit_cfg.num_heads
    hd = D // nh

    def g(k):
        return _np(sd[prefix + k])

    def lin(k):
        return {"kernel": g(k + ".weight").T, "bias": g(k + ".bias")}

    params: Dict[str, Any] = {
        "x_embedder": lin("x_embedder"),
        "proprio_embedder": lin("proprio_embedder"),
        "context_adapter": lin("context_adapter"),
        "t_embedder": {"fc1": lin("t_embedder.mlp.0"), "fc2": lin("t_embedder.mlp.2")},
        "final_adaLN": lin("final_layer.adaLN_modulation.1"),
        "final_linear": lin("final_layer.linear"),
    }
    for i in range(dit_cfg.depth):
        b = f"blocks.{i}."
        blk: Dict[str, Any] = {
            "adaLN_modulation": lin(b + "adaLN_modulation.1"),
            "attn_temporal": {
                "qkv": lin(b + "attn_temporal.qkv"),
                "proj": lin(b + "attn_temporal.proj"),
            },
            "mlp_fc1": lin(b + "mlp.fc1"),
            "mlp_fc2": lin(b + "mlp.fc2"),
        }
        use_cross = (i % dit_cfg.ctx_every == 0) or (i == dit_cfg.depth - 1) or (i == 0)
        if use_cross:
            ca = b + "cross_attn."
            blk["cross_attn"] = {
                "layer_norm_v": {"scale": g(ca + "layer_norm_v.weight"), "bias": g(ca + "layer_norm_v.bias")},
                "layer_norm_l": {"scale": g(ca + "layer_norm_l.weight"), "bias": g(ca + "layer_norm_l.bias")},
                "v_proj": {"kernel": g(ca + "attn.v_proj.weight").T.reshape(D, nh, hd), "bias": g(ca + "attn.v_proj.bias").reshape(nh, hd)},
                "l_proj": {"kernel": g(ca + "attn.l_proj.weight").T.reshape(D, nh, hd), "bias": g(ca + "attn.l_proj.bias").reshape(nh, hd)},
                "values_l_proj": {"kernel": g(ca + "attn.values_l_proj.weight").T.reshape(D, nh, hd), "bias": g(ca + "attn.values_l_proj.bias").reshape(nh, hd)},
                "out_v_proj": {"kernel": g(ca + "attn.out_v_proj.weight").T.reshape(nh, hd, D), "bias": g(ca + "attn.out_v_proj.bias")},
                "gamma_v": g(ca + "gamma_v"),
            }
        params[f"blocks_{i}"] = blk
    return params


def convert_action_expert(
    action_head_sd: Dict[str, Any],
    sigma_sd: Optional[Dict[str, Any]],
    proprio_sd: Dict[str, Any],
    noisy_sd: Dict[str, Any],
    expert_cfg,
) -> Dict:
    """The four component checkpoints (action_head--*.pt etc.,
    openvla_utils.find_checkpoint_file) -> one ActionExpert tree."""
    params: Dict[str, Any] = {
        "action_head": {
            "dit": convert_dit(action_head_sd, expert_cfg.dit_cfg(), "flow_predictor.dit.")
        },
        "proprio_projector": _mlp_projector(proprio_sd, ""),
        "noisy_action_projector": _mlp_projector(noisy_sd, ""),
    }
    if sigma_sd is not None:
        params["sigma_net"] = {
            "dit": convert_dit(sigma_sd, expert_cfg.dit_cfg(), "std_predictor.dit.")
        }
    return {"params": params}


# ============================================================ visual tokenizer
def _conv(sd, key):
    """torch Conv2d OIHW -> flax HWIO."""
    return {
        "kernel": _np(sd[key + ".weight"]).transpose(2, 3, 1, 0),
        "bias": _np(sd[key + ".bias"]),
    }


def _gn(sd, key):
    return {"scale": _np(sd[key + ".weight"]), "bias": _np(sd[key + ".bias"])}


def _lin(sd, key):
    return {"kernel": _np(sd[key + ".weight"]).T, "bias": _np(sd[key + ".bias"])}


def _resnet(sd, p):
    out = {
        "norm1": _gn(sd, p + "norm1"),
        "conv1": _conv(sd, p + "conv1"),
        "norm2": _gn(sd, p + "norm2"),
        "conv2": _conv(sd, p + "conv2"),
    }
    if p + "conv_shortcut.weight" in sd:
        out["conv_shortcut"] = _conv(sd, p + "conv_shortcut")
    return out


def _mid_block(sd, p):
    attn = p + "attentions.0."
    return {
        "resnets_0": _resnet(sd, p + "resnets.0."),
        "resnets_1": _resnet(sd, p + "resnets.1."),
        "attentions_0": {
            "group_norm": _gn(sd, attn + "group_norm"),
            "to_q": _lin(sd, attn + "to_q"),
            "to_k": _lin(sd, attn + "to_k"),
            "to_v": _lin(sd, attn + "to_v"),
            "to_out": _lin(sd, attn + "to_out.0"),
        },
    }


def _encoder(sd, prefix, n_blocks, layers_per_block):
    out = {"conv_in": _conv(sd, prefix + "conv_in"),
           "conv_norm_out": _gn(sd, prefix + "conv_norm_out"),
           "conv_out": _conv(sd, prefix + "conv_out"),
           "mid_block": _mid_block(sd, prefix + "mid_block.")}
    for i in range(n_blocks):
        blk = {}
        for j in range(layers_per_block):
            blk[f"resnets_{j}"] = _resnet(sd, f"{prefix}down_blocks.{i}.resnets.{j}.")
        ds = f"{prefix}down_blocks.{i}.downsamplers.0.conv"
        if ds + ".weight" in sd:
            blk["downsamplers_0"] = {"conv": _conv(sd, f"{prefix}down_blocks.{i}.downsamplers.0.conv")}
        out[f"down_blocks_{i}"] = blk
    return out


def _decoder(sd, prefix, n_blocks, layers_per_block):
    out = {"conv_in": _conv(sd, prefix + "conv_in"),
           "conv_norm_out": _gn(sd, prefix + "conv_norm_out"),
           "conv_out": _conv(sd, prefix + "conv_out"),
           "mid_block": _mid_block(sd, prefix + "mid_block.")}
    for i in range(n_blocks):
        blk = {}
        for j in range(layers_per_block + 1):  # decoders use layers+1 resnets
            blk[f"resnets_{j}"] = _resnet(sd, f"{prefix}up_blocks.{i}.resnets.{j}.")
        us = f"{prefix}up_blocks.{i}.upsamplers.0.conv"
        if us + ".weight" in sd:
            blk["upsamplers_0"] = {"conv": _conv(sd, f"{prefix}up_blocks.{i}.upsamplers.0.conv")}
        out[f"up_blocks_{i}"] = blk
    return out


def _cross_att_blocks(sd, prefix, num_heads=4):
    """conditional_vae CrossAttentionBlock: packed nn.MultiheadAttention
    in_proj split into q/k/v DenseGeneral heads."""
    out = {}
    i = 0
    while f"{prefix}cross_att_blocks.{i}.att.in_proj_weight" in sd:
        p = f"{prefix}cross_att_blocks.{i}."
        C = _np(sd[p + "att.in_proj_weight"]).shape[1]
        hd = C // num_heads
        in_w = _np(sd[p + "att.in_proj_weight"])  # (3C, C)
        in_b = _np(sd[p + "att.in_proj_bias"])
        qw, kw, vw = np.split(in_w, 3, 0)
        qb, kb, vb = np.split(in_b, 3, 0)
        out[f"cross_att_blocks_{i}"] = {
            "q_norm": _gn(sd, p + "q_norm"),
            "kv_norm": _gn(sd, p + "kv_norm"),
            "q_pos_emb": _np(sd[p + "q_pos_emb"]),
            "kv_pos_emb": _np(sd[p + "kv_pos_emb"]),
            "q_proj": {"kernel": qw.T.reshape(C, num_heads, hd), "bias": qb.reshape(num_heads, hd)},
            "k_proj": {"kernel": kw.T.reshape(C, num_heads, hd), "bias": kb.reshape(num_heads, hd)},
            "v_proj": {"kernel": vw.T.reshape(C, num_heads, hd), "bias": vb.reshape(num_heads, hd)},
            "out_proj": {
                "kernel": _np(sd[p + "att.out_proj.weight"]).T.reshape(num_heads, hd, C),
                "bias": _np(sd[p + "att.out_proj.bias"]),
            },
        }
        i += 1
    return out


def convert_compressive_vq(sd: Dict[str, Any], n_blocks: int = 4, layers_per_block: int = 2) -> Dict:
    """CompressiveVQModelFSQ torch checkpoint -> flax tokenizer params
    (ivideogpt/ctx_tokenizer/compressive_vq_model.py module names)."""
    params = {
        "encoder": _encoder(sd, "encoder.", n_blocks, layers_per_block),
        "decoder": _decoder(sd, "decoder.", n_blocks, layers_per_block),
        "cond_encoder": {
            **_encoder(sd, "cond_encoder.", n_blocks, layers_per_block),
            **_cross_att_blocks(sd, "cond_encoder."),
        },
        "cond_decoder": {
            **_decoder(sd, "cond_decoder.", n_blocks, layers_per_block),
            **_cross_att_blocks(sd, "cond_decoder."),
        },
        "quant_conv": _conv(sd, "quant_conv"),
        "post_quant_conv": _conv(sd, "post_quant_conv"),
        "quant_linear": _lin(sd, "quant_linear"),
        "post_quant_linear": _lin(sd, "post_quant_linear"),
    }
    return {"params": params}


def convert_lpips(vgg_sd: Dict[str, Any], lin_sd: Optional[Dict[str, Any]] = None) -> Dict:
    """torchvision VGG16 features + lpips vgg.pth lin heads -> LPIPS params.

    vgg_sd keys: features.{idx}.weight/bias for conv indices
    (0,2,5,7,10,12,14,17,19,21,24,26,28); lin_sd keys: lin{i}.model.1.weight.
    """
    conv_idx = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    vgg = {}
    for n, i in enumerate(conv_idx):
        vgg[f"conv{n}"] = {
            "kernel": _np(vgg_sd[f"features.{i}.weight"]).transpose(2, 3, 1, 0),
            "bias": _np(vgg_sd[f"features.{i}.bias"]),
        }
    params = {"vgg": vgg}
    if lin_sd is not None:
        for i in range(5):
            w = _np(lin_sd[f"lin{i}.model.1.weight"])  # (1, C, 1, 1)
            params[f"lin{i}"] = {"kernel": w.transpose(2, 3, 1, 0)}
    return {"params": params}
