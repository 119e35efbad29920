"""Process-group start-up, per-rank data slices and the port's collectives
(port of vla_rft_tpu/parallel/distributed.py).

The reference's `jax.distributed.initialize` becomes
`torch.distributed.init_process_group` from torchrun's environment (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT); at world size 1 it does
nothing, as the reference's does.  The backend is NCCL for CUDA, gloo for
the CPU, or the one the caller names.  A rank's device is
cuda:{LOCAL_RANK % device_count}, so ranks may share a card (NCCL refuses
that; gloo takes it).

Every collective that `ulysses.py`, `pp.py` and the trainers call goes
through this module.  On a gloo group a CUDA tensor is staged through host
memory for the collectives gloo does not carry on CUDA: send and receive
(gloo writes from the device pointer as if it were host memory and aborts
the process; torch 2.11's gloo carries all-reduce, broadcast, all-gather
and all-to-all on CUDA, as chip_smoke.py's gloo probe shows).  The choice
follows the group's backend and the collective, never a caught error, and
`staged()` says whether a collective stages.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

# the collectives gloo carries on CUDA tensors without staging
GLOO_CUDA = frozenset({"all_reduce", "broadcast", "all_gather", "all_to_all"})


def initialize_distributed(backend: Optional[str] = None,
                           device_type: str = "cuda") -> bool:
    """Start the default process group from torchrun's variables.  Returns
    whether this call started it: False at WORLD_SIZE 1 or unset (nothing
    to do, as in the reference) and when a group is already up."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return False
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    rank = int(os.environ["RANK"])
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ["MASTER_PORT"]
    if device_type == "cuda":
        torch.cuda.set_device(rank_device("cuda"))
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", rank=rank,
                            world_size=world)
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def rank_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: cuda:{LOCAL_RANK % device_count} (ranks beyond
    the card count share cards), or the CPU."""
    if device_type != "cuda":
        return torch.device(device_type)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device(f"cuda:{local % torch.cuda.device_count()}")


def local_batch_slice(global_batch_size: int, count: Optional[int] = None,
                      index: Optional[int] = None) -> slice:
    """This rank's contiguous share of a global batch (of `count` shares,
    the world size by default); a batch that does not divide raises."""
    n = world_size() if count is None else count
    i = rank() if index is None else index
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} does not divide over {n} ranks")
    per = global_batch_size // n
    return slice(i * per, (i + 1) * per)


def staged(op: str, t: torch.Tensor, group=None) -> bool:
    """Whether `op` on `t` goes through host memory: a CUDA tensor on a
    gloo group, for a collective gloo does not carry on CUDA."""
    return t.is_cuda and dist.get_backend(group) == "gloo" and op not in GLOO_CUDA


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """In-place all-reduce (gloo and NCCL both carry CUDA tensors)."""
    dist.all_reduce(t, op=op, group=group)
    return t


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    dist.broadcast(t, src, group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """The group's tensors of equal shape, concatenated on dim 0 in rank
    order (gloo and NCCL both carry CUDA tensors)."""
    n = dist.get_world_size(group)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=0)


def all_to_all_single(t: torch.Tensor, group=None) -> torch.Tensor:
    """Equal splits of dim 0: chunk j goes to rank j, and the result's chunk
    j came from rank j (gloo and NCCL both carry CUDA tensors)."""
    t = t.contiguous()  # and so is the output empty_like makes
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


def send(t: torch.Tensor, dst: int, group=None) -> None:
    """Send to group rank `dst`."""
    g = dst if group is None else dist.get_global_rank(group, dst)
    dist.send(t.detach().cpu().contiguous() if staged("send", t, group) else t.contiguous(),
              g, group=group)


def recv(shape, dtype, device, src: int, group=None) -> torch.Tensor:
    """Receive a tensor of `shape` from group rank `src` onto `device`."""
    g = src if group is None else dist.get_global_rank(group, src)
    probe = torch.empty(0, device=device)
    if staged("recv", probe, group):
        h = torch.empty(shape, dtype=dtype)
        dist.recv(h, g, group=group)
        return h.to(device)
    out = torch.empty(shape, dtype=dtype, device=device)
    dist.recv(out, g, group=group)
    return out


def shutdown() -> None:
    """destroy_process_group when one is up."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
