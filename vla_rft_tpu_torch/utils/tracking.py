"""Metric logger (port of vla_rft_tpu/utils/tracking.py): one
`.log(data, step)` fanned out to backends.  The `console` and `jsonl`
backends are ported; the others (tensorboard, wandb, mlflow, swanlab) are
not, and are skipped with a message, as the reference skips a backend it
cannot start."""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterable


class _ConsoleBackend:
    def log(self, data: Dict[str, Any], step: int) -> None:
        parts = " ".join(f"{k}:{_fmt(v)}" for k, v in sorted(data.items()))
        print(f"[step {step}] {parts}", flush=True)

    def finish(self):
        pass


class _JsonlBackend:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def log(self, data: Dict[str, Any], step: int) -> None:
        rec = {"step": step, "ts": time.time()}
        rec.update({k: _to_py(v) for k, v in data.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def finish(self):
        self._f.close()


class Tracking:
    def __init__(self, project_name: str, experiment_name: str,
                 default_backend: Iterable[str] = ("console",), log_dir: str = "logs"):
        self.backends = []
        for b in default_backend:
            if b == "console":
                self.backends.append(_ConsoleBackend())
            elif b == "jsonl":
                self.backends.append(
                    _JsonlBackend(os.path.join(log_dir, f"{experiment_name}.jsonl")))
            else:
                print(f"[tracking] backend {b!r} is not ported, skipping")

    def log(self, data: Dict[str, Any], step: int) -> None:
        for b in self.backends:
            b.log(data, step)

    def finish(self) -> None:
        for b in self.backends:
            b.finish()


def _to_py(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


def _fmt(v) -> str:
    try:
        return f"{float(v):.4g}"
    except (TypeError, ValueError):
        return str(v)


def reduce_metrics(metrics: Dict[str, Any]) -> Dict[str, float]:
    """Average list-valued metrics; scalars pass through as floats."""
    out = {}
    for k, v in metrics.items():
        if isinstance(v, (list, tuple)) and v:
            out[k] = float(sum(float(x) for x in v) / len(v))
        else:
            try:
                out[k] = float(v)
            except (TypeError, ValueError):
                pass
    return out
