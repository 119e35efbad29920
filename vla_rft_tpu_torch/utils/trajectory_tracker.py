"""TrajectoryTracker: named arrays dumped for offline diffing (port of
vla_rft_tpu/utils/trajectory_tracker.py).  Each dump is one
`{root}/{name}_step{step}.npz` and a line of `{root}/manifest.jsonl`; the
files are the reference's, so either package reads the other's."""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np


def _numpy(v) -> np.ndarray:
    """A torch tensor (any device) or array-like as a numpy array."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


class TrajectoryTracker:
    def __init__(self, root: str, enabled: bool = True):
        self.root = root
        self.enabled = enabled
        if enabled:
            os.makedirs(root, exist_ok=True)
        self._manifest_path = os.path.join(root, "manifest.jsonl")

    def dump(self, name: str, step: int, tree: Dict[str, Any]) -> Optional[str]:
        """Save a dict of arrays as {root}/{name}_step{step}.npz."""
        if not self.enabled:
            return None
        arrays = {k: _numpy(v) for k, v in tree.items()}
        path = os.path.join(self.root, f"{name}_step{step}.npz")
        np.savez_compressed(path, **arrays)
        with open(self._manifest_path, "a") as f:
            f.write(json.dumps({"name": name, "step": step, "path": path, "ts": time.time(),
                                "keys": sorted(arrays)}) + "\n")
        return path

    def load(self, name: str, step: int) -> Dict[str, np.ndarray]:
        path = os.path.join(self.root, f"{name}_step{step}.npz")
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    def diff(self, name: str, step: int, tree: Dict[str, Any], atol: float = 1e-5):
        """Max abs difference per key between live arrays and a dump."""
        ref = self.load(name, step)
        out = {}
        for k, v in tree.items():
            if k in ref:
                out[k] = float(np.abs(_numpy(v).astype(np.float32)
                                      - ref[k].astype(np.float32)).max())
        return out
