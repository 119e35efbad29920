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
