"""Per-phase wall-clock timers and the `timing_s/*` metric family (port of
vla_rft_tpu/utils/timers.py).  On the card a phase's time is meaningful
only if the phase ends in a device synchronize; the trainer does that."""
from __future__ import annotations

import contextlib
import time
from typing import Dict


@contextlib.contextmanager
def timer(name: str, timing: Dict[str, float]):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        timing[name] = timing.get(name, 0.0) + (time.perf_counter() - t0)


def timing_metrics(timing: Dict[str, float]) -> Dict[str, float]:
    return {f"timing_s/{k}": v for k, v in timing.items()}
