"""Metric logger (port of vla_rft_tpu/utils/tracking.py): one
`.log(data, step)` fanned out to the console, jsonl, tensorboard
(`torch.utils.tensorboard`), wandb, mlflow and swanlab backends, the last
four imported on use.  A backend that cannot start (its package missing,
no network) is skipped with a message, as the reference skips it."""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterable, Optional


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


class _TensorboardBackend:
    def __init__(self, log_dir: str):
        from torch.utils.tensorboard import SummaryWriter

        self._w = SummaryWriter(log_dir=log_dir)

    def log(self, data: Dict[str, Any], step: int) -> None:
        for k, v in data.items():
            try:
                self._w.add_scalar(k, float(v), step)
            except (TypeError, ValueError):
                pass

    def finish(self):
        self._w.close()


class _WandbBackend:
    def __init__(self, project: str, name: str, config: Optional[dict]):
        import wandb

        self._run = wandb.init(project=project, name=name, config=config)

    def log(self, data, step):
        self._run.log(data, step=step)

    def finish(self):
        self._run.finish()


class _MlflowBackend:
    """The project is MLflow's experiment, the experiment its run; the
    config goes in flattened as params."""

    def __init__(self, project: str, name: str, config: Optional[dict]):
        import mlflow

        uri = os.environ.get("MLFLOW_TRACKING_URI")
        if uri:
            mlflow.set_tracking_uri(uri)
        exp = mlflow.set_experiment(project)
        mlflow.start_run(experiment_id=exp.experiment_id, run_name=name)
        if config:
            mlflow.log_params(_flatten(config))
        self._mlflow = mlflow

    def log(self, data, step):
        self._mlflow.log_metrics(
            {k.replace("/", "_"): float(v) for k, v in data.items() if _is_number(v)},
            step=step)

    def finish(self):
        self._mlflow.end_run()


class _SwanlabBackend:
    """Login, log directory and mode from the SWANLAB_* variables."""

    def __init__(self, project: str, name: str, config: Optional[dict]):
        import swanlab

        key = os.environ.get("SWANLAB_API_KEY")
        if key:
            swanlab.login(key)
        swanlab.init(
            project=project, experiment_name=name,
            config={"FRAMEWORK": "vla_rft_tpu", **(config or {})},
            logdir=os.environ.get("SWANLAB_LOG_DIR", "swanlog"),
            mode=os.environ.get("SWANLAB_MODE", "cloud"),
        )
        self._swanlab = swanlab

    def log(self, data, step):
        self._swanlab.log(data, step=step)

    def finish(self):
        self._swanlab.finish()


class Tracking:
    def __init__(self, project_name: str, experiment_name: str,
                 default_backend: Iterable[str] = ("console",), config: Optional[dict] = None,
                 log_dir: str = "logs"):
        self.backends = []
        for b in default_backend:
            try:
                if b == "console":
                    self.backends.append(_ConsoleBackend())
                elif b == "jsonl":
                    self.backends.append(
                        _JsonlBackend(os.path.join(log_dir, f"{experiment_name}.jsonl")))
                elif b == "tensorboard":
                    tb_dir = os.environ.get("TENSORBOARD_DIR",
                                            os.path.join(log_dir, "tb", experiment_name))
                    self.backends.append(_TensorboardBackend(tb_dir))
                elif b == "wandb":
                    self.backends.append(_WandbBackend(project_name, experiment_name, config))
                elif b == "mlflow":
                    self.backends.append(_MlflowBackend(project_name, experiment_name, config))
                elif b == "swanlab":
                    self.backends.append(_SwanlabBackend(project_name, experiment_name, config))
                else:
                    print(f"[tracking] unknown backend {b!r}, skipping")
            except Exception as e:  # a missing package, no network: the run goes on
                print(f"[tracking] backend {b!r} unavailable: {e}")

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


def _is_number(v) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False


def _flatten(d: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A nested config as dotted flat params."""
    out: Dict[str, Any] = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, prefix=f"{key}."))
        else:
            out[key] = v
    return out


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
