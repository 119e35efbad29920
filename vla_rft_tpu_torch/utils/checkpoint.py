"""Checkpoints with verl's cadence (port of vla_rft_tpu/utils/checkpoint.py):
per-step directories `global_step_{N}` under a root, a
`latest_checkpointed_iteration.txt` marker for resume_mode auto.  The state is written with `torch.save` (one file per
step, tensors moved to the CPU) instead of orbax."""
from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import torch

LATEST_MARKER = "latest_checkpointed_iteration.txt"


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


class CheckpointManager:
    def __init__(self, root: str):
        self.root = os.path.abspath(root)

    def step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"global_step_{step}")

    def latest_step(self) -> Optional[int]:
        marker = os.path.join(self.root, LATEST_MARKER)
        if not os.path.exists(marker):
            return None
        with open(marker) as f:
            return int(f.read().strip())

    def save(self, step: int, state: Any) -> str:
        path = self.step_dir(step)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
        torch.save(_to_cpu(state), os.path.join(path, "state.pt"))
        with open(os.path.join(self.root, LATEST_MARKER), "w") as f:
            f.write(str(step))
        return path

    def restore(self, step: Optional[int] = None, map_location=None) -> Any:
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(os.path.join(self.step_dir(step), "state.pt"),
                          map_location=map_location, weights_only=True)


def should_save(step: int, total_steps: int, save_freq: int, save_last_freq: int,
                save_last_num: int) -> bool:
    """Every save_freq steps and at the last step, plus a save-last-K window
    near the end (ray_trainer.py:1762-1769)."""
    is_last = step >= total_steps
    if save_freq > 0 and (is_last or step % save_freq == 0):
        return True
    remaining = total_steps - step
    return (save_last_freq > 0 and remaining <= save_last_freq * save_last_num
            and remaining % save_last_freq == 0)
