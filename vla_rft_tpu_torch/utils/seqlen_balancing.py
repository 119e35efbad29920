"""Sequence-length-balanced partitions (port of
vla_rft_tpu/utils/seqlen_balancing.py, verl's Karmarkar-Karp partitioner):
split a batch into k groups with near-equal token sums (equal group sizes
when asked), the micro-batch re-arranger of dynamic batch sizing, and the
before / after statistics the PPO trainer's `balance_batch` logs."""
from __future__ import annotations

import heapq
from typing import List, Tuple


def karmarkar_karp(seqlens: List[int], k_partitions: int, equal_size: bool = True) -> List[List[int]]:
    """k index partitions with balanced sums (largest differencing)."""
    n = len(seqlens)
    if equal_size and n % k_partitions != 0:
        raise ValueError(f"{n} items cannot split into {k_partitions} equal groups")

    class State:
        def __init__(self, items: List[Tuple[int, int]], k: int):
            # k buckets of [sum, indices], sorted by descending sum
            self.buckets = [[0, []] for _ in range(k)]
            for seqlen, idx in items:
                self.buckets[-1][0] += seqlen
                self.buckets[-1][1].append(idx)
                self.buckets.sort(key=lambda b: -b[0])

        @property
        def spread(self):
            return self.buckets[0][0] - self.buckets[-1][0]

        def merge(self, other: "State"):
            # the largest bucket takes the other's smallest, and so on
            for b, o in zip(self.buckets, reversed(other.buckets)):
                b[0] += o[0]
                b[1].extend(o[1])
            self.buckets.sort(key=lambda b: -b[0])

    heap = []
    for i, s in enumerate(seqlens):
        st = State([(s, i)], k_partitions)
        heapq.heappush(heap, (-st.spread, i, st))
    uid = len(seqlens)
    while len(heap) > 1:
        _, _, a = heapq.heappop(heap)
        _, _, b = heapq.heappop(heap)
        a.merge(b)
        heapq.heappush(heap, (-a.spread, uid, a))
        uid += 1
    state = heap[0][2]
    parts = [sorted(b[1]) for b in state.buckets]
    if equal_size:
        # even out the counts greedily, keeping the sums close
        target = n // k_partitions
        parts.sort(key=len)
        flat_extra = []
        for p in parts:
            while len(p) > target:
                flat_extra.append(p.pop())
        for p in parts:
            while len(p) < target:
                p.append(flat_extra.pop())
        parts = [sorted(p) for p in parts]
    return parts


def get_seqlen_balanced_partitions(seqlens: List[int], k_partitions: int, equal_size: bool = True):
    return karmarkar_karp(seqlens, k_partitions, equal_size)


def rearrange_micro_batches(seqlens: List[int], max_token_len: int) -> List[List[int]]:
    """Indices packed into micro-batches of at most max_token_len tokens."""
    assert max(seqlens) <= max_token_len, "a single sequence exceeds max_token_len"
    k = max(1, -(-sum(seqlens) // max_token_len))
    while True:
        try:
            parts = karmarkar_karp(seqlens, k, equal_size=False)
        except ValueError:
            k += 1
            continue
        if all(sum(seqlens[i] for i in p) <= max_token_len for p in parts):
            return [p for p in parts if p]
        k += 1


def get_reverse_idx(idx_list: List[int]) -> List[int]:
    rev = [0] * len(idx_list)
    for pos, i in enumerate(idx_list):
        rev[i] = pos
    return rev


def log_seqlen_unbalance(seqlen_list, partitions, prefix):
    """Token sums per rank before (contiguous blocks) and after balancing."""
    k = len(partitions)
    bs = len(seqlen_list) // k
    naive = [sum(seqlen_list[o : o + bs]) for o in range(0, len(seqlen_list), bs)]
    balanced = [sum(seqlen_list[i] for i in p) for p in partitions]
    return {
        f"{prefix}/min": min(naive),
        f"{prefix}/max": max(naive),
        f"{prefix}/minmax_diff": max(naive) - min(naive),
        f"{prefix}/balanced_min": min(balanced),
        f"{prefix}/balanced_max": max(balanced),
        f"{prefix}/mean": sum(naive) / len(naive),
    }
