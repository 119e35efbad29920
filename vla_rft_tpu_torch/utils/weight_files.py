"""Reading checkpoint files: safetensors, torch pickles, config.json.

The reference reads `*.safetensors` through `safetensors.numpy.load_file`
and torch files through `torch.load` (vla_rft_tpu/trainer/main_vla_rft_grpo.py,
tools/convert_weights.py).  This module reads the same files with torch,
numpy and the standard library only:

* `load_file(path)`: one `.safetensors` file -> {name: tensor}.  The format
  is a little-endian u64 header length, a JSON header mapping each name to
  its dtype, shape and `data_offsets` (begin, end) into the byte buffer that
  follows, and an optional `__metadata__` entry (ignored).  BF16 tensors
  come back as `torch.bfloat16`, which numpy does not have;
* `load_dir(path)`: every `*.safetensors` in a directory, merged (nothing
  for a directory without one, as the reference's `glob` gives);
* `load_torch_state_dict`, `find_checkpoint_file`: the component-file
  helpers of tools/convert_weights.py;
* `load_state_dicts`, `read_model_config`: the reference entry point's
  `_load_state_dicts` / `_read_model_config`.
"""
from __future__ import annotations

import glob
import json
import os
import struct
from typing import Any, Dict, List

import torch

DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I8": torch.int8, "I32": torch.int32, "I64": torch.int64,
    "U8": torch.uint8, "BOOL": torch.bool,
}
# a header larger than this is not a safetensors header (the format's own cap)
MAX_HEADER_BYTES = 100 * 2 ** 20


def _read_header(f, path: str, size: int):
    raw = f.read(8)
    if len(raw) < 8:
        raise ValueError(f"{path}: {size} bytes is too short for a safetensors file")
    (n,) = struct.unpack("<Q", raw)
    if n > MAX_HEADER_BYTES or 8 + n > size:
        raise ValueError(f"{path}: header of {n} bytes does not fit in {size} bytes")
    header = json.loads(f.read(n))
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    header.pop("__metadata__", None)
    return header, 8 + n


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one `.safetensors` file, in host memory."""
    size = os.path.getsize(path)
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        header, base = _read_header(f, path, size)
        for name, info in header.items():
            dtype = DTYPES.get(info.get("dtype"))
            if dtype is None:
                raise ValueError(f"{path}: {name} has unsupported dtype {info.get('dtype')!r}")
            shape = [int(s) for s in info["shape"]]
            begin, end = (int(o) for o in info["data_offsets"])
            t = torch.empty(shape, dtype=dtype)
            nbytes = t.numel() * t.element_size()
            if not 0 <= begin <= end or end - begin != nbytes or base + end > size:
                raise ValueError(f"{path}: {name} ({info['dtype']} {shape}) has data_offsets "
                                 f"[{begin}, {end}] outside the {size - base}-byte buffer")
            if nbytes:
                f.seek(base + begin)
                buf = t.view(-1).view(torch.uint8).numpy()
                if f.readinto(memoryview(buf)) != nbytes:
                    raise ValueError(f"{path}: {name} is cut short")
            out[name] = t
    return out


WEIGHT_PATTERNS = ("*.safetensors", "*.bin", "*.pt", "*.pth", "*.ckpt")


def weight_files(path: str, patterns=WEIGHT_PATTERNS) -> List[str]:
    """The files a load of `path` reads: the file itself, or a directory's
    files matching `patterns`, in name order."""
    if not os.path.isdir(path):
        return [path]
    return sorted(f for pat in patterns for f in glob.glob(os.path.join(path, pat)))


def load_dir(path: str) -> Dict[str, torch.Tensor]:
    """Every `*.safetensors` under directory `path`, merged in name order."""
    sd: Dict[str, torch.Tensor] = {}
    for f in sorted(glob.glob(os.path.join(path, "*.safetensors"))):
        sd.update(load_file(f))
    return sd


def load_torch_state_dict(path: str) -> Dict[str, Any]:
    """A torch checkpoint's state dict (`weights_only`), unwrapped from a
    "state_dict" entry, with DDP's `module.` prefixes stripped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {(k[7:] if k.startswith("module.") else k): v for k, v in sd.items()}


def find_checkpoint_file(dir_path: str, pattern: str) -> str:
    """The one `.pt` file in `dir_path` whose name holds `pattern`
    (openvla_utils.find_checkpoint_file)."""
    matches = [f for f in os.listdir(dir_path) if pattern in f and f.endswith(".pt")]
    if len(matches) != 1:
        raise FileNotFoundError(
            f"expected exactly one '{pattern}' checkpoint in {dir_path}, got {matches}")
    return os.path.join(dir_path, matches[0])


def load_state_dicts(path: str) -> Dict[str, Any]:
    """Every weight file at `path` (a file, or a directory's `*.safetensors`,
    `*.bin`, `*.pt`, `*.pth` and `*.ckpt`) merged into one state dict."""
    files = weight_files(path)
    if not files:
        raise FileNotFoundError(f"no weight files under {path}")
    sd: Dict[str, Any] = {}
    for f in files:
        sd.update(load_file(f) if f.endswith(".safetensors") else load_torch_state_dict(f))
    return sd


def read_model_config(path: str) -> Dict[str, Any]:
    """A directory's `config.json`, or {} (for a file, or without one)."""
    cfg_file = os.path.join(path, "config.json") if os.path.isdir(path) else None
    if cfg_file and os.path.exists(cfg_file):
        with open(cfg_file) as f:
            return json.load(f)
    return {}
