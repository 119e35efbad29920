"""Where one policy request's time goes on the GPU.

    python -m vla_rft_tpu_torch.serving.profile_request

Builds the libero policy as the action server does (`build_policy_fn`),
warms it up with two requests, times `make_batch` and `predict_action` over
three more on the host clock (ending in a synchronize), and traces one
`predict_action` with torch.profiler.  Prints one JSON line: host ms per
stage, the device's busy time (the union of the kernels' intervals in the
trace) and idle share, the number of kernels launched, the flash kernel's
count and time, and the kernels that took the most device time.  Needs a
CUDA device.
"""
from __future__ import annotations

import json
import time
from collections import defaultdict

import numpy as np
import torch

from vla_rft_tpu_torch.eval.policy import build_policy_fn
from vla_rft_tpu_torch.workers.predict import predict_action


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def main() -> None:
    policy_fn = build_policy_fn(preset="libero", device="cuda", seed=7)
    bundle = policy_fn.bundle
    rng = np.random.default_rng(0)
    obs = {"full_image": rng.integers(0, 256, (224, 224, 3), dtype=np.uint8),
           "proprio": rng.normal(size=8).astype(np.float32)}
    instruction = "put both the alphabet soup and the tomato sauce in the basket"
    for _ in range(2):
        policy_fn(obs, instruction)

    host = defaultdict(list)
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = policy_fn.make_batch(obs, instruction)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        predict_action(bundle.vla, bundle.expert, batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host["make_batch_ms"].append((t1 - t0) * 1e3)
        host["predict_action_ms"].append((t2 - t1) * 1e3)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict_action(bundle.vla, bundle.expert, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.end - e.time_range.start
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    flash = [v for k, v in by_name.items() if "flash_fwd_kernel" in k]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "preset": "libero",
        "host_ms_median": {k: float(np.median(v)) for k, v in host.items()},
        "traced_predict_action": {
            "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_idle_share": (1.0 - busy / wall_us) if kernels else None,
            "kernels_launched": len(kernels),
            "flash_fwd": {"launches": sum(c for c, _ in flash),
                          "device_ms": sum(t for _, t in flash) / 1e3},
            "top_kernels": [{"name": k[:80], "count": c, "device_ms": t / 1e3}
                            for k, (c, t) in top],
        },
    }), flush=True)


if __name__ == "__main__":
    main()
