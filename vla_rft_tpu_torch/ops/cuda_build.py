"""Build and load the port's CUDA kernels: plain nvcc into a ctypes library.

Each kernel source `csrc/<name>.cu` exposes a plain C entry point and is
compiled at first use by nvcc into `_build/lib<name>_<key>.so` beside the
package, where <key> hashes the source, the shared headers `csrc/*.cuh` and
the flags, so an unchanged tree does not rebuild.  No PyTorch headers are involved, so a build takes seconds.
`build` starts one nvcc per missing library, all at once, and waits for all.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    """Where the build of csrc/<name>.cu (and the headers beside it) with
    the current flags lives."""
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


def build(*names: str) -> Dict[str, dict]:
    """Compile csrc/<name>.cu for every name whose library is missing, one
    nvcc process each, started together.  Returns {name: {path, seconds,
    built, log}}; `seconds` is the wall time from the common start until
    that build was collected."""
    results: Dict[str, dict] = {}
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            results[name] = {"path": str(out), "seconds": 0.0, "built": False, "log": ""}
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, cmd, tmp, out, time.perf_counter())
    for name, (proc, cmd, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
        os.replace(tmp, out)
        results[name] = {"path": str(out), "seconds": seconds, "built": True, "log": log}
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(build(name)[name]["path"])
    return _libs[name]
