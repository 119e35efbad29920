"""Batch: the wire format between pipeline stages (port of
vla_rft_tpu/protocol.py).

The counterpart of verl's ``DataProto``: named arrays with a common leading
dimension, numpy object arrays for what is not a tensor (uids, strings), and
a free-form ``meta`` dict.  The arrays are numpy arrays or torch tensors (on
any device); every operation keeps each field's type and device.  The
surface (chunk / concat / union / select / pop / repeat / reorder /
make_iterator / pad_to_divisor) is the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

_ARRAY_TYPES = (np.ndarray, torch.Tensor)


def _is_array(x: Any) -> bool:
    return isinstance(x, _ARRAY_TYPES)


def _take(v, indices: np.ndarray):
    """Rows `indices` of a numpy array or a tensor (on the tensor's device)."""
    if isinstance(v, torch.Tensor):
        return v[torch.as_tensor(indices, dtype=torch.long, device=v.device)]
    return v[indices]


def _repeat(v, times: int, interleave: bool):
    if isinstance(v, torch.Tensor):
        if interleave:
            return torch.repeat_interleave(v, times, dim=0)
        return v.repeat((times,) + (1,) * (v.dim() - 1))
    if interleave:
        return np.repeat(v, times, axis=0)
    return np.tile(v, (times,) + (1,) * (v.ndim - 1))


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


@dataclasses.dataclass
class Batch:
    """A batch of named arrays with a common leading dimension.

    Attributes:
      data: name -> array with shape [B, ...] (numpy or torch).
      non_tensor: name -> numpy object array with shape [B, ...] (uids, strings).
      meta: free-form metadata (not batched).
    """

    data: Dict[str, Any] = dataclasses.field(default_factory=dict)
    non_tensor: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------------ basics
    def __post_init__(self):
        self.check_consistency()

    def check_consistency(self) -> None:
        """Every field has the same leading size (DataProto.check_consistency)."""
        sizes = {k: v.shape[0] for k, v in self.data.items()}
        sizes.update({k: v.shape[0] for k, v in self.non_tensor.items()})
        if sizes:
            uniq = set(sizes.values())
            if len(uniq) != 1:
                raise ValueError(f"inconsistent batch sizes: {sizes}")

    def __len__(self) -> int:
        for v in self.data.values():
            return int(v.shape[0])
        for v in self.non_tensor.values():
            return int(v.shape[0])
        return 0

    def keys(self):
        return self.data.keys()

    def __contains__(self, key: str) -> bool:
        return key in self.data or key in self.non_tensor

    def __getitem__(self, item):
        if isinstance(item, str):
            if item in self.data:
                return self.data[item]
            return self.non_tensor[item]
        # index / slice -> sub-batch
        if isinstance(item, int):
            item = slice(item, item + 1)
        return Batch(
            data={k: v[item] for k, v in self.data.items()},
            non_tensor={k: v[item] for k, v in self.non_tensor.items()},
            meta=dict(self.meta),
        )

    def __setitem__(self, key: str, value) -> None:
        if _is_array(value) and value.dtype != object:
            self.data[key] = value
        else:
            self.non_tensor[key] = np.asarray(value, dtype=object)

    # --------------------------------------------------------------- creation
    @classmethod
    def from_dict(
        cls,
        tensors: Optional[Dict[str, Any]] = None,
        non_tensors: Optional[Dict[str, Any]] = None,
        meta: Optional[Dict[str, Any]] = None,
    ) -> "Batch":
        tensors = dict(tensors or {})
        nt = {k: np.asarray(v, dtype=object) for k, v in (non_tensors or {}).items()}
        return cls(data=tensors, non_tensor=nt, meta=dict(meta or {}))

    @classmethod
    def from_single_dict(
        cls, d: Dict[str, Any], meta: Optional[Dict[str, Any]] = None
    ) -> "Batch":
        """Split a flat dict into array / object fields (from_single_dict)."""
        tensors, non_tensors = {}, {}
        for k, v in d.items():
            if _is_array(v) and v.dtype != object:
                tensors[k] = v
            else:
                non_tensors[k] = np.asarray(v, dtype=object)
        return cls(data=tensors, non_tensor=non_tensors, meta=dict(meta or {}))

    # ------------------------------------------------------------- operations
    def select(
        self,
        batch_keys: Optional[Sequence[str]] = None,
        non_tensor_keys: Optional[Sequence[str]] = None,
        meta_keys: Optional[Sequence[str]] = None,
    ) -> "Batch":
        pick = lambda d, keys: {k: d[k] for k in keys} if keys is not None else dict(d)
        return Batch(data=pick(self.data, batch_keys),
                     non_tensor=pick(self.non_tensor, non_tensor_keys),
                     meta=pick(self.meta, meta_keys))

    def pop(
        self,
        batch_keys: Optional[Sequence[str]] = None,
        non_tensor_keys: Optional[Sequence[str]] = None,
    ) -> "Batch":
        """Remove and return the named fields as a new Batch."""
        data = {k: self.data.pop(k) for k in (batch_keys or [])}
        nt = {k: self.non_tensor.pop(k) for k in (non_tensor_keys or [])}
        return Batch(data=data, non_tensor=nt, meta=dict(self.meta))

    def union(self, other: "Batch") -> "Batch":
        """Merge the fields of `other` into self; `other` wins on a shared key."""
        if len(other) and len(self) and len(other) != len(self):
            raise ValueError(
                f"union requires equal batch sizes, got {len(self)} vs {len(other)}"
            )
        self.data.update(other.data)
        self.non_tensor.update(other.non_tensor)
        self.meta.update(other.meta)
        return self

    def chunk(self, chunks: int) -> List["Batch"]:
        """Split into `chunks` equal parts along dim 0."""
        n = len(self)
        if n % chunks != 0:
            raise ValueError(f"batch size {n} not divisible into {chunks} chunks")
        step = n // chunks
        return [self[i * step : (i + 1) * step] for i in range(chunks)]

    def split(self, size: int) -> List["Batch"]:
        n = len(self)
        return [self[i : min(i + size, n)] for i in range(0, n, size)]

    @staticmethod
    def concat(batches: Sequence["Batch"]) -> "Batch":
        """Concatenate along dim 0."""
        if not batches:
            return Batch()
        data = {}
        for k in batches[0].data:
            vals = [b.data[k] for b in batches]
            if isinstance(vals[0], torch.Tensor):
                data[k] = torch.cat(vals, dim=0)
            else:
                data[k] = np.concatenate(vals, axis=0)
        nt = {
            k: np.concatenate([b.non_tensor[k] for b in batches], axis=0)
            for k in batches[0].non_tensor
        }
        return Batch(data=data, non_tensor=nt, meta=dict(batches[0].meta))

    def repeat(self, repeat_times: int, interleave: bool = True) -> "Batch":
        """Repeat each row. interleave=True -> [a,a,b,b], else [a,b,a,b]."""
        return Batch(
            data={k: _repeat(v, repeat_times, interleave) for k, v in self.data.items()},
            non_tensor={k: _repeat(v, repeat_times, interleave)
                        for k, v in self.non_tensor.items()},
            meta=dict(self.meta),
        )

    def reorder(self, indices) -> "Batch":
        """Reorder rows by integer indices."""
        indices = np.asarray(indices)
        return Batch(
            data={k: _take(v, indices) for k, v in self.data.items()},
            non_tensor={k: v[indices] for k, v in self.non_tensor.items()},
            meta=dict(self.meta),
        )

    def rename(self, old: str, new: str) -> "Batch":
        if old in self.data:
            self.data[new] = self.data.pop(old)
        elif old in self.non_tensor:
            self.non_tensor[new] = self.non_tensor.pop(old)
        return self

    def make_iterator(
        self,
        mini_batch_size: int,
        epochs: int = 1,
        seed: Optional[int] = None,
        shuffle: bool = False,
    ) -> Iterator["Batch"]:
        """Mini-batches in order, or in a numpy permutation per epoch."""
        n = len(self)
        rng = np.random.default_rng(seed)
        for _ in range(epochs):
            order = rng.permutation(n) if shuffle else np.arange(n)
            for i in range(0, n, mini_batch_size):
                yield self.reorder(order[i : i + mini_batch_size])

    # ------------------------------------------------------------- conversion
    def to_numpy(self) -> "Batch":
        return Batch(
            data={k: _to_numpy(v) for k, v in self.data.items()},
            non_tensor=dict(self.non_tensor),
            meta=dict(self.meta),
        )

    def map(self, fn: Callable[[Any], Any]) -> "Batch":
        return Batch(
            data={k: fn(v) for k, v in self.data.items()},
            non_tensor=dict(self.non_tensor),
            meta=dict(self.meta),
        )


def pad_to_divisor(batch: Batch, divisor: int) -> tuple[Batch, int]:
    """Pad batch rows (by cycling from the start) so len % divisor == 0.
    Returns (padded, pad_size)."""
    n = len(batch)
    if n % divisor == 0:
        return batch, 0
    pad = divisor - n % divisor
    idx = np.concatenate([np.arange(n), np.arange(pad) % n])
    return batch.reorder(idx), pad


def unpad(batch: Batch, pad_size: int) -> Batch:
    if pad_size == 0:
        return batch
    return batch[: len(batch) - pad_size]
