"""Build and load the port's native libraries: plain nvcc (CUDA kernels) or
g++ (host code) into a ctypes library.

Each kernel source `csrc/<name>.cu` exposes a plain C entry point and is
compiled at first use by nvcc into `_build/lib<name>_<key>.so` beside the
package, where <key> hashes the source, the shared headers `csrc/*.cuh` and
the flags, so an unchanged tree does not rebuild.  No PyTorch headers are involved, so a build takes seconds.
A host source `csrc/<name>.cc` (the data pipeline's TFRecord scanner and
image resize / crop) is built the same way by the host C++ compiler; its
key hashes the source and the flags.
`build` starts one compiler per missing library, all at once, and waits for
all.  A failed build raises: nothing falls back to another route.
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

HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
HOST_LIBS = ("-lpthread",)

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _cxx() -> str:
    cand = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cand:
        raise RuntimeError("no host C++ compiler (set CXX or put g++ on PATH)")
    return cand


def _source(name: str) -> Path:
    """csrc/<name>.cu for a CUDA kernel, else csrc/<name>.cc for host code."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cc"


def _flags(name: str) -> tuple:
    if _source(name).suffix == ".cu":
        return NVCC_FLAGS
    return (*HOST_FLAGS, *HOST_LIBS)


def library_path(name: str) -> Path:
    """Where the build of csrc/<name>.cu (and the headers beside it) or of
    csrc/<name>.cc with the current flags lives."""
    src = _source(name)
    parts = [src, *sorted(CSRC.glob("*.cuh"))] if src.suffix == ".cu" else [src]
    data = b"".join(p.read_bytes() for p in parts)
    key = hashlib.sha256(data + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


def _command(name: str, out: Path) -> list:
    src = _source(name)
    if src.suffix == ".cu":
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]
    # the link libraries follow the source, as the linker reads them in order
    return [_cxx(), *HOST_FLAGS, "-o", str(out), str(src), *HOST_LIBS]


def build(*names: str) -> Dict[str, dict]:
    """Compile csrc/<name>.cu (or .cc) for every name whose library is
    missing, one compiler process each, started together.  Returns {name: {path, seconds,
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
        cmd = _command(name, tmp)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, cmd, tmp, out, time.perf_counter())
    for name, (proc, cmd, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(cmd[0])} failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
        os.replace(tmp, out)
        results[name] = {"path": str(out), "seconds": seconds, "built": True, "log": log}
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (or .cc), built first if needed."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(build(name)[name]["path"])
    return _libs[name]
