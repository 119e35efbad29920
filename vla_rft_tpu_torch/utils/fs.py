"""Filesystem helpers for remote model and checkpoint paths (port of
vla_rft_tpu/utils/fs.py).

Parity with verl/utils/fs.py (copy_to_local / is_non_local, an md5-keyed
local cache) and verl/utils/hdfs_io.py (copy / makedirs through the hdfs
CLI).  `gs://` and `s3://` go through tensorflow.io.gfile or fsspec,
whichever is installed, each imported on use; `hdfs://` through the `hdfs`
command.  They serve explicit "materialise this remote file locally" calls
(HF snapshots, dataset statistics, action-range files).
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional

_REMOTE_SCHEMES = ("hdfs://", "gs://", "s3://")


def is_non_local(path: str) -> bool:
    return any(path.startswith(s) for s in _REMOTE_SCHEMES)


def md5_encode(path: str) -> str:
    return hashlib.md5(path.encode()).hexdigest()


def _default_cache_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "vla_rft_cache")


def _gfile():
    try:
        from tensorflow.io import gfile  # type: ignore
    except ImportError:
        return None
    return gfile


def _copy_remote(src: str, dst: str) -> None:
    if src.startswith("hdfs://"):
        hdfs_copy(src, dst)
        return
    gfile = _gfile()
    if gfile is not None and gfile.exists(src):
        if gfile.isdir(src):
            os.makedirs(dst, exist_ok=True)
            for name in gfile.listdir(src):
                _copy_remote(os.path.join(src, name), os.path.join(dst, name))
        else:
            gfile.copy(src, dst, overwrite=True)
        return
    try:
        import fsspec  # type: ignore

        fs, _ = fsspec.core.url_to_fs(src)
        fs.get(src, dst, recursive=True)
        return
    except ImportError:
        pass
    raise RuntimeError(
        f"no filesystem backend for {src!r}: need tensorflow.io.gfile or "
        "fsspec for gs://|s3://, or the hdfs CLI for hdfs://"
    )


def copy_to_local(src: str, cache_dir: Optional[str] = None, verbose: bool = False) -> str:
    """Return a local path for `src`, downloading into an md5-keyed cache dir
    if it is remote (verl/utils/fs.py:copy_to_local). Local paths (including
    file://) pass through untouched; repeated calls hit the cache."""
    if src.startswith("file://"):
        return src[len("file://") :]
    if not is_non_local(src):
        return src
    cache_dir = cache_dir or _default_cache_dir()
    sub = os.path.join(cache_dir, md5_encode(src))
    os.makedirs(sub, exist_ok=True)
    local = os.path.join(sub, os.path.basename(src.rstrip("/")))
    done_marker = local + ".done"
    if os.path.exists(done_marker):
        return local
    if verbose:
        print(f"[fs] fetching {src} -> {local}")
    _copy_remote(src, local)
    with open(done_marker, "w") as f:
        f.write(src)
    return local


def copy(src: str, dst: str) -> None:
    """Local/remote-aware copy (hdfs_io.copy parity)."""
    if is_non_local(src) or is_non_local(dst):
        if src.startswith("hdfs://") or dst.startswith("hdfs://"):
            hdfs_copy(src, dst)
            return
        gfile = _gfile()
        if gfile is None:
            raise RuntimeError("remote copy needs tensorflow.io.gfile or the hdfs CLI")
        gfile.copy(src, dst, overwrite=True)
        return
    if os.path.isdir(src):
        shutil.copytree(src, dst, dirs_exist_ok=True)
    else:
        shutil.copy2(src, dst)


def makedirs(path: str, exist_ok: bool = True) -> None:
    """mkdir -p across local / hdfs / gfile backends (hdfs_io.makedirs)."""
    if path.startswith("hdfs://"):
        subprocess.run(["hdfs", "dfs", "-mkdir", "-p", path], check=True)
        return
    if is_non_local(path):
        gfile = _gfile()
        if gfile is None:
            raise RuntimeError("remote makedirs needs tensorflow.io.gfile")
        gfile.makedirs(path)
        return
    os.makedirs(path, exist_ok=exist_ok)


def hdfs_copy(src: str, dst: str) -> None:
    """hdfs_io.copy: shells out to the hdfs CLI (-put/-get/-cp by locality)."""
    src_r, dst_r = src.startswith("hdfs://"), dst.startswith("hdfs://")
    if src_r and dst_r:
        cmd = ["hdfs", "dfs", "-cp", "-f", src, dst]
    elif src_r:
        cmd = ["hdfs", "dfs", "-get", src, dst]
    else:
        cmd = ["hdfs", "dfs", "-put", "-f", src, dst]
    subprocess.run(cmd, check=True)
