"""The port's metric logger (utils/tracking.py) and filesystem helpers
(utils/fs.py) against the JAX package, on the CPU.

The tensorboard backend writes real event files, read back with
tensorboard's EventAccumulator.  wandb, mlflow and swanlab are not installed
here: stub modules in sys.modules record every call, and the port's backends
must make the same calls as the reference's under the same stubs.
"""
import json
import os
import sys
import types

import pytest

from vla_rft_tpu.utils import fs as j_fs
from vla_rft_tpu.utils import tracking as j_tracking
from vla_rft_tpu_torch.utils import fs as t_fs
from vla_rft_tpu_torch.utils import tracking as t_tracking

CONFIG = {"trainer": {"lr": 1e-4, "steps": {"total": 2}}, "seed": 3}
METRICS = [{"actor/loss": 0.5, "critic/score": 2, "note": "skip-me"},
           {"actor/loss": 0.25, "critic/score": 3.5}]


class _Recorder:
    """An attribute path of a stub module: calling it records the call in
    `calls` and returns the path of its result."""

    def __init__(self, path, calls):
        self._path, self._calls = path, calls

    def __getattr__(self, attr):
        return _Recorder(f"{self._path}.{attr}", self._calls)

    def __call__(self, *args, **kw):
        self._calls.append((self._path, args, kw))
        return _Recorder(f"{self._path}()", self._calls)

    def __eq__(self, other):  # what a call returned, passed on to another
        return isinstance(other, _Recorder) and other._path == self._path

    def __hash__(self):
        return hash(self._path)


def _stub(name, calls):
    mod = types.ModuleType(name)
    mod.__getattr__ = lambda attr: _Recorder(f"{name}.{attr}", calls)
    return mod


def _run(tracking, backends, tmp_path, **kw):
    t = tracking.Tracking("proj", "exp", backends, config=CONFIG, log_dir=str(tmp_path), **kw)
    for step, m in enumerate(METRICS, 1):
        t.log(m, step)
    t.finish()
    return t


@pytest.mark.parametrize("backend", ["wandb", "mlflow", "swanlab"])
def test_backends_make_the_reference_calls(backend, tmp_path, monkeypatch):
    monkeypatch.setenv("MLFLOW_TRACKING_URI", "file:///nowhere")
    monkeypatch.setenv("SWANLAB_API_KEY", "k")
    recorded = {}
    for pkg in (t_tracking, j_tracking):
        calls = recorded.setdefault(pkg.__name__, [])
        monkeypatch.setitem(sys.modules, backend, _stub(backend, calls))
        t = _run(pkg, [backend], tmp_path)
        assert len(t.backends) == 1
    t_calls, j_calls = recorded.values()
    assert t_calls == j_calls and len(t_calls) >= 4


def test_tensorboard_event_file_reads_back(tmp_path, monkeypatch):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    scalars = {}
    for pkg in (t_tracking, j_tracking):
        log_dir = tmp_path / pkg.__name__
        _run(pkg, ["tensorboard"], log_dir)
        acc = EventAccumulator(str(log_dir / "tb" / "exp"))
        acc.Reload()
        scalars[pkg.__name__] = {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
                                 for tag in acc.Tags()["scalars"]}
    t_s, j_s = scalars.values()
    assert t_s == j_s == {"actor/loss": [(1, 0.5), (2, 0.25)], "critic/score": [(1, 2.0), (2, 3.5)]}
    monkeypatch.setenv("TENSORBOARD_DIR", str(tmp_path / "env"))
    _run(t_tracking, ["tensorboard"], tmp_path / "x")
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(tmp_path / "env"))


def test_missing_and_unknown_backends_degrade_as_the_reference(tmp_path, monkeypatch, capsys):
    for name in ("wandb", "mlflow", "swanlab"):
        monkeypatch.setitem(sys.modules, name, None)
    out = {}
    for pkg in (t_tracking, j_tracking):
        t = _run(pkg, ["console", "wandb", "mlflow", "swanlab", "bogus"], tmp_path / pkg.__name__)
        assert len(t.backends) == 1
        out[pkg.__name__] = capsys.readouterr().out
    t_out, j_out = out.values()
    assert t_out == j_out
    assert t_out.count("unavailable") == 3 and "unknown backend 'bogus'" in t_out
    assert "[step 2] actor/loss:0.25 critic/score:3.5 note" not in t_out


def test_jsonl_flatten_and_reduce_equal_the_reference(tmp_path):
    for pkg in (t_tracking, j_tracking):
        _run(pkg, ["jsonl"], tmp_path / pkg.__name__)
    recs = [[json.loads(line) for line in (tmp_path / pkg.__name__ / "exp.jsonl").read_text()
             .splitlines()] for pkg in (t_tracking, j_tracking)]
    strip = lambda rs: [{k: v for k, v in r.items() if k != "ts"} for r in rs]
    assert strip(recs[0]) == strip(recs[1]) and recs[0][0]["note"] == "skip-me"
    assert t_tracking._flatten(CONFIG) == j_tracking._flatten(CONFIG) == {
        "trainer.lr": 1e-4, "trainer.steps.total": 2, "seed": 3}
    m = {"a": [1.0, 3.0], "b": 2, "c": "skip-me", "d": []}
    assert t_tracking.reduce_metrics(m) == j_tracking.reduce_metrics(m)


# ---------------------------------------------------------------------- fs
def test_cache_paths_equal_the_reference(tmp_path, monkeypatch):
    paths = []
    for fs in (t_fs, j_fs):
        calls = []
        monkeypatch.setattr(fs, "_copy_remote",
                            lambda s, d, calls=calls: (calls.append(s), open(d, "w").write("r")))
        cache = tmp_path / fs.__name__
        a = fs.copy_to_local("gs://b/dir/model.bin", cache_dir=str(cache))
        assert fs.copy_to_local("gs://b/dir/model.bin", cache_dir=str(cache)) == a
        assert calls == ["gs://b/dir/model.bin"]  # the second call hits the cache
        paths.append(os.path.relpath(a, cache))
    assert paths[0] == paths[1]
    assert t_fs.md5_encode("hdfs://nn/x") == j_fs.md5_encode("hdfs://nn/x")
    p = tmp_path / "local.txt"
    p.write_text("x")
    for src in (str(p), f"file://{p}"):
        assert t_fs.copy_to_local(src) == j_fs.copy_to_local(src) == str(p)
    for path in ("gs://a", "s3://a", "hdfs://a", "/a", "file:///a"):
        assert t_fs.is_non_local(path) == j_fs.is_non_local(path)


def test_copy_makedirs_and_hdfs_commands_equal_the_reference(tmp_path, monkeypatch):
    src = tmp_path / "tree" / "in"
    src.mkdir(parents=True)
    (src / "f").write_text("x")
    t_fs.makedirs(str(tmp_path / "a" / "b"))
    t_fs.copy(str(tmp_path / "tree"), str(tmp_path / "tree2"))
    t_fs.copy(str(src / "f"), str(tmp_path / "a" / "b" / "g"))
    assert (tmp_path / "tree2" / "in" / "f").read_text() == (tmp_path / "a" / "b" / "g").read_text()
    cmds = {}
    for fs in (t_fs, j_fs):
        runs = cmds.setdefault(fs.__name__, [])
        monkeypatch.setattr(fs.subprocess, "run", lambda cmd, check, runs=runs: runs.append(cmd))
        fs.hdfs_copy("hdfs://nn/a", "hdfs://nn/b")
        fs.hdfs_copy("hdfs://nn/a", "/tmp/b")
        fs.hdfs_copy("/tmp/a", "hdfs://nn/b")
        fs.makedirs("hdfs://nn/d")
        fs.copy("hdfs://nn/a", "/tmp/c")
    t_cmds, j_cmds = cmds.values()
    assert t_cmds == j_cmds and len(t_cmds) == 5
