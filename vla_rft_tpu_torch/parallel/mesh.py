"""The (dp, fsdp, tp, sp) device mesh and the FSDP placement rule (port of
vla_rft_tpu/parallel/mesh.py).

Axes, as the reference's:
  dp    data parallel: every rank of a dp group holds the whole model
  fsdp  parameters sharded (ZeRO-3); the batch is split over dp x fsdp
  tp    tensor parallel (tp.py)
  sp    sequence parallel (ulysses.py)
`make_mesh` is torch's `init_device_mesh` over the world with those names.
`shard_params_fsdp` places a module's parameters by the reference's rule
through FSDP2's `fully_shard` on the mesh's fsdp axis: a parameter under
2^16 elements, or with no dimension that divides by the fsdp size, is left
out of FSDP (`ignored_params`) and stays replicated; every other one is
sharded on its largest divisible dimension.  `shard_batch` gives a rank its
rows of the (dp, fsdp) axes; ranks along tp and sp get the same rows.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from vla_rft_tpu_torch.parallel import distributed as pd
from vla_rft_tpu_torch.trainer.optim import AdamW, clip_by_global_norm


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = -1  # -1: use all remaining ranks
    fsdp: int = 1
    tp: int = 1
    sp: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        fixed = self.fsdp * self.tp * self.sp
        dp = self.dp
        if dp == -1:
            if n_devices % fixed != 0:
                raise ValueError(f"{n_devices} devices not divisible by fsdp*tp*sp={fixed}")
            dp = n_devices // fixed
        if dp * fixed != n_devices:
            raise ValueError(
                f"mesh {dp}x{self.fsdp}x{self.tp}x{self.sp} != {n_devices} devices"
            )
        return MeshConfig(dp=dp, fsdp=self.fsdp, tp=self.tp, sp=self.sp)


AXES = ("dp", "fsdp", "tp", "sp")


def make_mesh(cfg: MeshConfig = MeshConfig(), device_type: str = "cuda"):
    """The world's ranks as a (dp, fsdp, tp, sp) DeviceMesh (the process
    group must be up when the world has more than one rank)."""
    from torch.distributed.device_mesh import init_device_mesh

    cfg = cfg.resolve(pd.world_size())
    return init_device_mesh(device_type, (cfg.dp, cfg.fsdp, cfg.tp, cfg.sp),
                            mesh_dim_names=AXES)


def data_rank(mesh) -> Tuple[int, int]:
    """(index, count) of this rank's share of a batch split over (dp, fsdp)."""
    if mesh is None:
        return 0, 1
    fsdp = mesh["fsdp"].size()
    return (mesh["dp"].get_local_rank() * fsdp + mesh["fsdp"].get_local_rank(),
            mesh["dp"].size() * fsdp)


def shard_batch(mesh, tree: Any) -> Any:
    """This rank's rows (dim 0) of every [B, ...] leaf, split over (dp,
    fsdp); a B that does not divide raises."""
    index, count = data_rank(mesh)

    def take(x):
        return x[pd.local_batch_slice(x.shape[0], count, index)]

    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    return take(tree)


class DataRanks:
    """The ranks that split a batch, as the trainers use them: this rank's
    (dp, fsdp) share of a global batch (`index` of `count`), the group of
    the ranks that hold the same (tp, sp) coordinate (tp and sp ranks
    replicate rows, as in the reference's trainers), and the reductions a
    step makes over it.  With no mesh (one process) every method is the
    identity.  Building one is a collective: every rank of the world
    builds it at the same point (torch.distributed.new_group).

    A step follows one rule: each rank backpropagates its share of the
    global loss times `count` (`backward`), so that FSDP2's reduce-scatter,
    which averages over fsdp, and `summed_grads`' mean over the other data
    ranks give the sum of the shares' gradients; `step` sums them, clips
    them by the norm of the whole gradient and steps the optimizers."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.index, self.count = data_rank(mesh)
        self.group = self.dp_group = self.fsdp_group = None
        if mesh is None:
            return
        ranks, me = mesh.mesh, pd.rank()
        for t in range(ranks.shape[2]):
            for s in range(ranks.shape[3]):
                members = ranks[:, :, t, s].flatten().tolist()
                g = torch.distributed.new_group(members)  # every rank makes every group
                if me in members:
                    self.group = g
        self.dp_group = mesh["dp"].get_group()
        self.fsdp_group = mesh["fsdp"].get_group()

    def rows(self, x):
        """This rank's (dp, fsdp) share of a global tensor's (or dict's) rows."""
        return x if self.mesh is None else shard_batch(self.mesh, x)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The data ranks' rows of a tensor, in rank order (the global rows)."""
        return x if self.count == 1 else pd.all_gather(x, self.group)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the data ranks (in place; `t` at one rank)."""
        return t if self.count == 1 else pd.all_reduce(t, group=self.group)

    def mean(self, values: Dict[str, float], device) -> Dict[str, float]:
        """Each value's mean over the data ranks (reduced on `device`)."""
        if self.count == 1 or not values:
            return values
        keys = sorted(values)
        t = torch.tensor([values[k] for k in keys], dtype=torch.float64, device=device)
        t = self.sum(t) / self.count
        return {k: float(v) for k, v in zip(keys, t.tolist())}

    def backward(self, share: torch.Tensor) -> None:
        """Backpropagate this rank's share of a global loss (times `count`:
        FSDP2 and `summed_grads` average over the ranks)."""
        (share * self.count if self.count > 1 else share).backward()

    def take_grads(self, params) -> List[torch.Tensor]:
        """Each parameter's gradient as `backward` left it, this rank's shard
        of a sharded one, zeros for a parameter the loss did not reach (as
        `jax.value_and_grad` gives them); the `.grad`s are cleared."""
        out = []
        for p in params:
            g = p.grad
            out.append(torch.zeros_like(local(p)) if g is None else local(g))
            p.grad = None
        return out

    def summed_grads(self, params, grads: Optional[List[torch.Tensor]] = None
                     ) -> List[torch.Tensor]:
        """The gradients of `params` summed over the data ranks: `grads` (as
        `take_grads` gives them), or those `backward` left.  An FSDP shard
        is already reduce-scattered (averaged) over fsdp and is averaged
        over dp; a replicated leaf is averaged over every data rank."""
        grads = self.take_grads(params) if grads is None else grads
        out = []
        for p, g in zip(params, grads):
            if placement_dim(p) is None:
                out.append(g if self.count == 1 else self.sum(g) / self.count)
            else:
                dp = self.mesh["dp"].size()
                out.append(pd.all_reduce(g, group=self.dp_group) / dp if dp > 1 else g)
        return out

    def norm(self, grads: Sequence[torch.Tensor], params) -> torch.Tensor:
        """The f32 global norm of a whole gradient held as this rank's
        shards of `params`' sharded leaves (summed over fsdp) and their
        replicated leaves (counted once)."""
        sq = lambda gs: sum((g.float() * g.float()).sum() for g in gs)
        sharded = [placement_dim(p) is not None for p in params]
        shards = [g for g, s in zip(grads, sharded) if s]
        rest = [g for g, s in zip(grads, sharded) if not s]
        dev = (shards or rest)[0].device
        total = torch.zeros((), dtype=torch.float32, device=dev)
        if shards:
            total = total + pd.all_reduce(sq(shards) + total, group=self.fsdp_group)
        if rest:
            total = total + sq(rest)
        return torch.sqrt(total)

    def step(self, params, opts: Sequence[AdamW], max_norm: float,
             grads: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """One optimizer step: the gradients of `params` (`grads` as
        `take_grads` gives them, or those `backward` left) summed over the
        data ranks, clipped by the norm of the whole gradient (every
        parameter's, frozen ones included, as the reference clips before
        its `multi_transform`), then each of `opts` (AdamWs over some of
        `params` or their local shards) steps its own.  Returns the norm
        before clipping."""
        grads = self.summed_grads(params, grads)
        grads, norm = clip_by_global_norm(grads, max_norm, self.norm(grads, params))
        by_memory = {_memory(local(p)): g for p, g in zip(params, grads)}
        for opt in opts:
            opt.step([by_memory[_memory(p)] for p in opt.params])
        return norm


def _memory(t: torch.Tensor) -> Tuple[int, int, Tuple[int, ...]]:
    """Where a tensor's elements lie: a parameter and a view of its local
    shard have one key."""
    return t.untyped_storage().data_ptr(), t.storage_offset(), tuple(t.shape)


def _fsdp_spec_for(shape: tuple, fsdp_size: int, min_size: int = 2**16) -> tuple:
    """ZeRO-3-style parameter spec: shard the largest divisible dim over 'fsdp'.

    Small params (< min_size elements) stay replicated — the reference keeps
    small heads in DDP (fsdp_workers.py:336-359), i.e. replicated, too.
    Returns the reference's PartitionSpec as a tuple: () or one 'fsdp'.
    """
    if fsdp_size <= 1 or int(np.prod(shape)) < min_size:
        return ()
    # prefer the largest dim divisible by fsdp_size
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if shape[i] % fsdp_size == 0:
            spec = [None] * len(shape)
            spec[i] = "fsdp"
            return tuple(spec)
    return ()


def fsdp_dim(shape, fsdp_size: int, min_size: int = 2**16) -> Optional[int]:
    """The dimension `_fsdp_spec_for` shards, or None (replicated)."""
    spec = _fsdp_spec_for(tuple(shape), fsdp_size, min_size)
    return spec.index("fsdp") if spec else None


def shard_params_fsdp(mesh, module: nn.Module, min_size: int = 2**16,
                      reshard_after_forward: bool = True) -> nn.Module:
    """Place `module`'s parameters by `_fsdp_spec_for` over the mesh's fsdp
    axis (replicated over dp, tp and sp): FSDP2's fully_shard with each
    sharded parameter on its dimension, the rest left out of FSDP.  At fsdp
    1, or when no parameter shards, the module is returned as it is."""
    if mesh is None or mesh["fsdp"].size() <= 1:
        return module
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    n = mesh["fsdp"].size()
    dims: Dict[int, int] = {}
    ignored = set()
    for p in module.parameters():
        d = fsdp_dim(p.shape, n, min_size)
        if d is None:
            ignored.add(p)
        else:
            dims[id(p)] = d
    if not dims:
        return module
    fully_shard(module, mesh=mesh["fsdp"], reshard_after_forward=reshard_after_forward,
                shard_placement_fn=lambda p: Shard(dims[id(p)]), ignored_params=ignored)
    return module


def placement_dim(p: torch.Tensor) -> Optional[int]:
    """The sharded dimension of a parameter placed here, or None."""
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(p, DTensor):
        for pl in p.placements:
            if isinstance(pl, Shard):
                return pl.dim
    return None


def is_sharded(module: nn.Module) -> bool:
    from torch.distributed.fsdp import FSDPModule

    return isinstance(module, FSDPModule)


@contextlib.contextmanager
def gathered(*modules: nn.Module) -> Iterator[None]:
    """Hold each FSDP-sharded module's parameters whole for the block (one
    all-gather in, the shards back out); other modules pass through.  The
    frozen towers are used through methods other than `forward`, which
    FSDP's hooks do not see."""
    fs = [m for m in modules if is_sharded(m)]
    for m in fs:
        m.unshard()
    try:
        yield
    finally:
        for m in fs:
            m.reshard()


def local(t: torch.Tensor) -> torch.Tensor:
    """The local shard of a DTensor (sharing its storage), or `t`."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def whole_like(local: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The whole tensor of which `local` is this rank's shard, sharded as
    the DTensor `like` is (one dimension over a 1-D mesh, in torch.chunk's
    pieces as FSDP2 cuts them): the shards padded to one size, gathered
    with `distributed.all_gather` (a collective: every rank of the mesh
    calls it), the padding cut off.  DTensor's own `full_tensor` goes
    through the functional collectives, which crash on a gloo group with
    CUDA tensors (torch 2.11)."""
    from torch.distributed.tensor import Shard

    dims = [pl.dim for pl in like.placements if isinstance(pl, Shard)]
    if not dims:
        return local
    (d,) = dims
    n, whole = like.device_mesh.size(), like.shape[dims[0]]
    per = -(-whole // n)
    x = local.movedim(d, 0)
    if x.shape[0] < per:
        x = torch.cat([x, x.new_zeros((per - x.shape[0],) + tuple(x.shape[1:]))])
    return pd.all_gather(x, like.device_mesh.get_group())[:whole].movedim(0, d).contiguous()


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole (`whole_like`), or `t`."""
    from torch.distributed.tensor import DTensor

    return whole_like(t.to_local(), t) if isinstance(t, DTensor) else t


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """`module.state_dict()` with every sharded entry gathered whole."""
    return {k: full_tensor(v) for k, v in module.state_dict().items()}


@torch.no_grad()
def load_full_state_dict(module: nn.Module, sd: Dict[str, torch.Tensor], strict: bool = True):
    """`module.load_state_dict` from whole tensors: a sharded entry takes
    its own shard of the whole tensor (no collective).  Returns
    (missing, unexpected) as load_state_dict does."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    own = module.state_dict()
    missing = [k for k in own if k not in sd]
    unexpected = [k for k in sd if k not in own]
    if strict and (missing or unexpected):
        raise RuntimeError(f"missing {missing[:8]}, unexpected {unexpected[:8]}")
    for k, v in sd.items():
        if k not in own:
            continue
        dst = own[k]
        if isinstance(dst, DTensor):
            src = distribute_tensor(v.to(dst.device, dst.dtype), dst.device_mesh, dst.placements,
                                    src_data_rank=None)
            dst.to_local().copy_(src.to_local())
        else:
            dst.copy_(v.to(dst.device, dst.dtype))
    return missing, unexpected
