"""Rank processes for the parallel tests: `spawn(world, suite, inputs)`
starts `world` processes of this file over a gloo group on the CPU, each
runs the named suite on the inputs (a torch.save'd dict) and writes its
results to a file; the parent reads them back.  Imports no JAX."""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(world: int, suite: str, inputs: dict, timeout: float = 300.0, threads: int = 1):
    """Run `suite` on `world` ranks; returns the list of per-rank results."""
    with tempfile.TemporaryDirectory() as d:
        torch.save(inputs, os.path.join(d, "in.pt"))
        port = free_port()
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), OMP_NUM_THREADS=str(threads),
                   PYTHONPATH=os.pathsep.join([ROOT, HERE, os.environ.get("PYTHONPATH", "")]))
        procs = []
        for r in range(world):
            e = dict(env, RANK=str(r), LOCAL_RANK=str(r))
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), suite, d],
                                          env=e, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        logs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=timeout)
                logs.append(out.decode(errors="replace"))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} of {suite} exited {p.returncode}:\n{logs[r][-6000:]}")
        return [torch.load(os.path.join(d, f"out{r}.pt"), weights_only=False)
                for r in range(world)]


def _main():
    suite, d = sys.argv[1], sys.argv[2]
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    from vla_rft_tpu_torch.parallel import distributed as pd

    if suite not in ("cli", "text_cli"):  # the CLIs start their own group
        pd.initialize_distributed(device_type="cpu")
    inputs = torch.load(os.path.join(d, "in.pt"), weights_only=False)
    import torch_parallel_suites as suites

    out = getattr(suites, suite)(inputs)
    torch.save(out, os.path.join(d, f"out{os.environ['RANK']}.pt"))
    pd.shutdown()


if __name__ == "__main__":
    _main()
