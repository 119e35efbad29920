"""Weight bridge: the JAX package's Flax param trees -> this port's state dicts.

`flax_to_torch(tree, which)` takes a tree of
`vla_rft_tpu.models.factory.init_params` (leaves as numpy arrays, with or
without the top-level "params" key) and returns the state dict of the
port's module: "vla" (`models.prismatic.OpenVLA`), "expert"
(`models.action_head.ActionExpert`), "wm" (the world model's
`models.transformer.Decoder`, untied lm_head), "tokenizer"
(`models.tokenizers.CompressiveVQModelFSQ`) and "lpips"
(`models.lpips.LPIPS`); "decoder" and "vit" convert a lone `Decoder` or
`ViT` tree the same way, "critic" a `models.critic.CriticModel` tree (its
`backbone` decoder and `value_head`) and "reward_model" a
`models.reward_model.SequenceRewardModel` tree (its `backbone` and
`score_head`):

* the `nn.scan`-stacked ViT blocks and decoder layers are unstacked into
  `blocks.{i}` / `layers.{i}`; the DiT's `blocks_{i}` become `blocks.{i}`;
* Dense kernels (in, *out) become (out, in) weights; the multi-axis-input
  projections (`o_proj`, ViT `proj`, `out_v_proj`, kernel (H, hd, out))
  flatten their input axes; (H, hd) biases flatten;
* every conv kernel (kh, kw, in, out) becomes (out, in, kh, kw) (the port's
  convolutions are NCHW);
* LayerNorm / GroupNorm `scale` and Embed `embedding` become `weight`;
* the VAE blocks keep their Flax names (`down_blocks_0.resnets_1.conv1`).

`torch_to_flax(state_dict, which, module)` is its exact inverse: the
module says what a state dict does not hold (which 2-D `weight` is an
embedding, which 1-D one a norm's `scale`, the head splits of the
multi-axis projections, which `blocks` were scanned).  `flax_leaves`
flattens a nested tree in the order of `jax.tree_util.tree_flatten` (sorted
keys at each level), the order of the tools' `p0..pN` files.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

# layers whose Flax kernel has several input axes: (H, hd, out)
_MULTI_IN = {"o_proj", "proj", "out_v_proj", "out_proj"}
# modules whose Flax params are stacked on a leading layer axis (nn.scan)
_STACKED = {"blocks", "layers"}
WHICH = ("vla", "expert", "decoder", "vit", "wm", "tokenizer", "lpips", "critic",
         "reward_model")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _leaf(path, arr) -> Dict[str, np.ndarray]:
    """One Flax leaf -> {torch leaf name: array} (before unstacking)."""
    name, owner = path[-1], path[-2] if len(path) > 1 else ""
    if name == "kernel":
        if arr.ndim == 4:  # a 2-D conv (scanned layers are unstacked before this)
            return {"weight": arr.transpose(3, 2, 0, 1)}
        if owner in _MULTI_IN:
            return {"weight": arr.reshape(-1, arr.shape[-1]).T}
        return {"weight": arr.reshape(arr.shape[0], -1).T}
    if name == "bias":
        return {"bias": arr.reshape(-1)}
    if name in ("scale", "embedding"):
        return {"weight": arr}
    return {name: arr}


def _convert(tree) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for path, arr in _flatten(tree):
        stacked = next((i for i, p in enumerate(path[:-1]) if p in _STACKED), None)
        if stacked is None:
            for leaf, val in _leaf(path, arr).items():
                out[".".join(path[:-1] + (leaf,))] = val
            continue
        head, tail = path[: stacked + 1], path[stacked + 1:]
        for i in range(arr.shape[0]):
            for leaf, val in _leaf(tail, arr[i]).items():
                out[".".join(head + (str(i),) + tail[:-1] + (leaf,))] = val
    return out


def flax_to_torch(tree: Dict[str, Any], which: str) -> Dict[str, torch.Tensor]:
    """Convert a Flax tree (one of `WHICH`) into the port's torch state dict."""
    if which not in WHICH:
        raise ValueError(f"which must be one of {WHICH}, got {which!r}")
    if "params" in tree:
        tree = tree["params"]
    sd = _convert(tree)
    renamed = {}
    for k, v in sd.items():
        parts = k.split(".")
        parts = [
            f"blocks.{p[len('blocks_'):]}" if p.startswith("blocks_") else p for p in parts
        ]
        renamed[".".join(parts)] = torch.from_numpy(np.ascontiguousarray(v))
    return renamed


# ---------------------------------------------------------------- inverse
def flax_leaves(tree, prefix=()):
    """[(path, leaf)] of a nested dict in jax.tree_util.tree_flatten's order:
    the keys of each dict sorted, depth first."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict) or hasattr(v, "items"):
            out += flax_leaves(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def _layouts(module) -> Dict[str, tuple]:
    """{module name: (kind, head dim, multi-axis names)} for every module of
    `module` whose parameters do not map by name alone."""
    from vla_rft_tpu_torch.models import dit, transformer, vae, vit
    from vla_rft_tpu_torch.models.layers import Conv, Dense, Embed, GroupNorm, LayerNorm

    out = {}
    for name, m in module.named_modules():
        if isinstance(m, vit.ViTBlock):
            out[name] = ("heads", m.cfg.hidden_size // m.cfg.num_heads, ("q", "k", "v"), ("proj",))
        elif isinstance(m, dit.CrossAttention):
            out[name] = ("heads", m.cfg.hidden_size // m.cfg.num_heads,
                         ("v_proj", "l_proj", "values_l_proj"), ("out_v_proj",))
        elif isinstance(m, vae.CrossAttentionBlock2D):
            out[name] = ("heads", m.q_proj.weight.shape[0] // m.num_heads,
                         ("q_proj", "k_proj", "v_proj"), ("out_proj",))
        elif isinstance(m, transformer.Attention):
            out[name] = ("heads", m.cfg.hd, ("q_proj", "k_proj", "v_proj"), ("o_proj",))
        elif isinstance(m, (Dense, Conv, vit.PatchEmbed)):
            out[name] = ("kernel",)
        elif isinstance(m, (LayerNorm, GroupNorm)):
            out[name] = ("scale",)
        elif isinstance(m, Embed):
            out[name] = ("embedding",)
        elif isinstance(m, dit.DiTSingleTokenActionOneCtx):
            out[name] = ("unscanned",)  # its blocks_{i} were never stacked
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def torch_to_flax(state_dict: Dict[str, torch.Tensor], which: str, module) -> Dict[str, Any]:
    """The exact inverse of `flax_to_torch`: the port's state dict of `module`
    (one of `WHICH`) -> the Flax tree {"params": ...} of numpy arrays, with
    the scanned layers stacked again (bf16 leaves come back as f32)."""
    if which not in WHICH:
        raise ValueError(f"which must be one of {WHICH}, got {which!r}")
    lay = _layouts(module)
    flat: Dict[tuple, Any] = {}
    for key, t in state_dict.items():
        parts = key.split(".")
        owner, leaf = ".".join(parts[:-1]), parts[-1]
        arr = _to_numpy(t)
        kind = lay.get(owner, ("plain",))
        parent = lay.get(".".join(parts[:-2]), ("plain",))
        if kind[0] in ("kernel",) and leaf == "weight":
            attn = parent if parent[0] == "heads" else None
            name = parts[-2]
            if arr.ndim == 4:
                arr = arr.transpose(2, 3, 1, 0)
            elif attn and name in attn[2]:  # (H*hd, in) -> (in, H, hd)
                arr = arr.T.reshape(arr.shape[1], -1, attn[1])
            elif attn and name in attn[3]:  # (out, H*hd) -> (H, hd, out)
                arr = arr.T.reshape(-1, attn[1], arr.shape[0])
            else:
                arr = arr.T
            leaf = "kernel"
        elif kind[0] == "kernel" and leaf == "bias" and parent[0] == "heads" \
                and parts[-2] in parent[2]:
            arr = arr.reshape(-1, parent[1])
        elif kind[0] in ("scale", "embedding") and leaf == "weight":
            leaf = kind[0]
        path = parts[:-1] + [leaf]
        # a ModuleList index: scanned (stacked on a leading axis) unless its
        # owner never scanned its blocks (the DiT's blocks_{i})
        for i, p in enumerate(path[:-1]):
            if p in _STACKED and path[i + 1].isdigit():
                if lay.get(".".join(parts[:i]), ("plain",))[0] == "unscanned":
                    path = path[:i] + [f"{p}_{path[i + 1]}"] + path[i + 2:]
                else:
                    path = path[:i + 1] + ["#" + path[i + 1]] + path[i + 2:]
                break
        flat[tuple(path)] = arr
    tree: Dict[str, Any] = {}
    stacked: Dict[tuple, Dict[int, np.ndarray]] = {}
    for path, arr in flat.items():
        idx = next((i for i, p in enumerate(path) if p.startswith("#")), None)
        if idx is None:
            _put(tree, path, arr)
        else:
            stacked.setdefault(path[:idx] + path[idx + 1:], {})[int(path[idx][1:])] = arr
    for path, layers in stacked.items():
        _put(tree, path, np.stack([layers[i] for i in range(len(layers))]))
    return {"params": tree}


def _put(tree: Dict[str, Any], path, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value
