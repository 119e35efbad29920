"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. build    - nvcc builds the flash-forward kernel library from the sources
                in this checkout (vla_rft_tpu_torch/csrc/flash_fwd.cu);
  2. flash    - the kernel against its plain PyTorch twin on the card over
                masked, padded and ragged cases, and its time beside the
                twin's, scaled_dot_product_attention's (a yardstick only: the
                port never calls it) and the bound of the card;
  3. serving  - the libero-width policy (SigLIP-so400m + DINOv2-L +
                Qwen2.5-0.5B + DiT action expert, seeded random weights)
                behind ActionServer on localhost answers 4 POST /act
                requests; every request must launch the kernel once per Qwen
                layer (24), and the kernel path must agree with the plain
                path on one request;
then the card's name and power limit, the kernel table as one JSON line, and
last `{"ok": true, "device": {...}}`.  Any failure raises: the script exits
non-zero and prints no `ok` line.  It needs a CUDA device and the rest of the
repository beside it.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM data-sheet peaks (dense): the bound of a kernel is the larger of
# its bytes over the memory rate and its operations over the bf16 rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

N_REQUESTS = 4
O_TOL = 2e-2  # bf16 O (2^-8 relative) and bf16 P in the P.V product
LSE_TOL = 1e-3  # f32 LSE; scores are exact bf16 products summed in f32
HIDDEN_TOL = 5e-2  # kernel vs plain path, relative to max|hidden|, 24 bf16 layers
ACTION_TOL = 5e-2  # normalized actions after 10 bf16 Euler steps


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of fn() in ms (CUDA events around `iters` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flash_work(q, k, kv_lens, kv_starts, q_offset, causal):
    """(bytes, flops) the function needs on these inputs: each input read
    once, each output written once; 4*D flops per valid (query, key) pair."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    io = 2 * (B * Sq * Hq * D + 2 * B * Sk * Hkv * D) + 2 * B * Sq * Hq * D + 4 * B * Sq * Hq
    kv = torch.arange(Sk, device=q.device)[None, None, :]
    qp = torch.arange(Sq, device=q.device)[None, :, None] + q_offset[:, None, None]
    valid = (kv < kv_lens[:, None, None]) & (kv >= kv_starts[:, None, None])
    if causal:
        valid = valid & (qp >= kv)
    pairs = int(valid.sum()) * Hq
    return io, 4 * D * pairs


def phase_build(attention) -> dict:
    info = attention.build_flash_fwd()
    attention._load()
    ptxas = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "smem" in ln]
    out = {"phase": "build", "seconds": round(info["seconds"], 3), "built": info["built"],
           "library": os.path.relpath(info["path"]), "ptxas": ptxas}
    emit(out)
    return out


def phase_flash(attention) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    Hq, Hkv, D = 14, 2, 64
    cases = [
        # (name, B, Sq, Sk, per-row kwargs); all causal, as the Qwen forward
        ("serving_b1", 1, 352, 352, {}),
        ("right_pad_b4", 4, 352, 352, {"kv_lens": [352, 300, 161, 97]}),
        ("left_pad_b4_608", 4, 608, 608, {"kv_starts": [0, 64, 100, 333]}),
        ("q_offset_chunk", 1, 100, 608, {"q_offset": [508]}),
        ("fully_masked_row", 4, 352, 352, {"kv_lens": [352, 0, 352, 200],
                                           "kv_starts": [0, 0, 352, 50]}),
        ("ragged_300", 4, 300, 300, {"kv_lens": [300, 299, 250, 1]}),
    ]
    results, err_o, err_lse = [], 0.0, 0.0
    for name, B, Sq, Sk, kw in cases:
        q = torch.randn(B, Sq, Hq, D, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, Sk, Hkv, D, generator=gen, device=dev).bfloat16()
        v = torch.randn(B, Sk, Hkv, D, generator=gen, device=dev).bfloat16()
        args = {a: torch.tensor(x, dtype=torch.int32, device=dev) for a, x in kw.items()}
        o, lse = attention.flash_fwd(q, k, v, causal=True, **args)
        torch.cuda.synchronize()
        o_ref, lse_ref = attention.attention_plain(q, k, v, causal=True, return_lse=True, **args)
        e_o = (o.float() - o_ref.float()).abs().max().item()
        e_l = (lse - lse_ref).abs().max().item()
        if not (e_o <= O_TOL and e_l <= LSE_TOL and torch.isfinite(o.float()).all()):
            raise AssertionError(f"flash case {name}: max|dO|={e_o} max|dLSE|={e_l}")
        if "fully_masked" in name:
            dead = o[1].float().abs().max().item(), o[2].float().abs().max().item()
            if dead != (0.0, 0.0) or not bool((lse[1] == attention.NEG_INF).all()):
                raise AssertionError(f"fully-masked rows not zero: {dead}")
        err_o, err_lse = max(err_o, e_o), max(err_lse, e_l)
        results.append({"case": name, "B": B, "Sq": Sq, "Sk": Sk, "max_abs_err_o": e_o,
                        "max_abs_err_lse": e_l})

    # time at the serving shape: one request, S = 96 text + 256 patches
    B, S = 1, 352
    q = torch.randn(B, S, Hq, D, generator=gen, device=dev).bfloat16()
    k = torch.randn(B, S, Hkv, D, generator=gen, device=dev).bfloat16()
    v = torch.randn(B, S, Hkv, D, generator=gen, device=dev).bfloat16()
    rows = {"kv_lens": torch.full((B,), S, dtype=torch.int32, device=dev),
            "kv_starts": torch.zeros(B, dtype=torch.int32, device=dev),
            "q_offset": torch.zeros(B, dtype=torch.int32, device=dev)}
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kernel_ms = cuda_ms(lambda: attention.flash_fwd(q, k, v, causal=True, **rows))
    plain_ms = cuda_ms(lambda: attention.attention_plain(q, k, v, causal=True, return_lse=True,
                                                         **rows))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                                enable_gqa=True))
    nbytes, flops = flash_work(q, k, rows["kv_lens"], rows["kv_starts"], rows["q_offset"], True)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    out = {"phase": "flash", "cases": results, "max_abs_err_o": err_o,
           "max_abs_err_lse": err_lse, "tolerance": {"o": O_TOL, "lse": LSE_TOL},
           "timed_shape": {"B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "D": D, "causal": True},
           "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "flops": flops}
    emit(out)
    return out


def phase_serving(attention) -> dict:
    from vla_rft_tpu_torch.eval.policy import build_policy_fn
    from vla_rft_tpu_torch.serving.action_server import ActionServer, get_action_from_server
    from vla_rft_tpu_torch.workers.predict import encode_context, predict_action

    t0 = time.perf_counter()
    policy_fn = build_policy_fn(preset="libero", device="cuda", seed=7)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    bundle = policy_fn.bundle
    n_layers = bundle.vla_cfg.llm.num_layers
    rng = np.random.default_rng(0)
    requests = [
        {"instruction": "put both the alphabet soup and the tomato sauce in the basket",
         "full_image": rng.integers(0, 256, (224, 224, 3), dtype=np.uint8),
         "proprio": rng.normal(size=8).astype(np.float32)}
        for _ in range(N_REQUESTS)
    ]
    server = ActionServer(policy_fn, host="127.0.0.1", port=0)
    server.start_background()
    latencies, per_request = [], []
    try:
        url = f"http://127.0.0.1:{server.port}/act"
        attention.launches = 0  # the main path starts here
        for req in requests:
            before = attention.launches
            t = time.perf_counter()
            action = get_action_from_server(req, url, timeout=600)
            latencies.append((time.perf_counter() - t) * 1e3)
            per_request.append(attention.launches - before)
            if action.shape != (8, 7) or not np.isfinite(action).all():
                raise AssertionError(f"bad action chunk: shape {action.shape}")
        main_path_launches = attention.launches  # read right after the main path
    finally:
        server.shutdown()
    if per_request != [n_layers] * N_REQUESTS:
        raise AssertionError(f"kernel launches per request {per_request}, expected {n_layers}")

    # kernel path vs plain path on one request, same weights and noise
    lm = bundle.vla.language_model
    batch = policy_fn.make_batch(requests[0], requests[0]["instruction"])
    noise = torch.randn(1, 8, 7, generator=torch.Generator(device="cuda").manual_seed(1),
                        device="cuda")
    with torch.no_grad():
        h_kernel = encode_context(bundle.vla, batch).float()
        a_kernel = predict_action(bundle.vla, bundle.expert, batch, noise=noise).float()
        lm.attn_impl = "plain"
        try:
            h_plain = encode_context(bundle.vla, batch).float()
            a_plain = predict_action(bundle.vla, bundle.expert, batch, noise=noise).float()
        finally:
            lm.attn_impl = "auto"
    h_err = ((h_kernel - h_plain).abs().max() / h_plain.abs().max()).item()
    a_err = (a_kernel - a_plain).abs().max().item()
    if not (h_err <= HIDDEN_TOL and a_err <= ACTION_TOL):
        raise AssertionError(f"kernel vs plain path: hidden rel err {h_err}, action err {a_err}")

    # where a request's device time goes (kernel path, CUDA events)
    vla = bundle.vla
    with torch.no_grad():
        vision_ms = cuda_ms(lambda: vla.projector(vla.vision_backbone(batch["pixels"])), 10, 2)
        encode_ms = cuda_ms(lambda: encode_context(vla, batch), 10, 2)
        predict_ms = cuda_ms(lambda: predict_action(vla, bundle.expert, batch, noise=noise), 5, 1)
    out = {"phase": "serving", "preset": "libero", "requests": N_REQUESTS,
           "seq_len": int(batch["input_ids"].shape[1]) + bundle.vla_cfg.total_patches,
           "build_policy_s": build_s, "first_request_ms": latencies[0],
           "steady_request_ms": float(np.median(latencies[1:])), "request_ms": latencies,
           "launches_per_request": per_request, "main_path_launches": main_path_launches,
           "kernel_vs_plain": {"hidden_rel_err": h_err, "action_max_abs_err": a_err,
                               "tolerance": {"hidden_rel": HIDDEN_TOL, "action": ACTION_TOL}},
           "device_ms": {"vision_and_projector": vision_ms, "encode_context": encode_ms,
                         "predict_action": predict_ms,
                         "flow_steps": predict_ms - encode_ms}}
    emit(out)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vla_rft_tpu_torch.ops import attention

    # float32 references stay float32 (the defaults, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build(attention)
    flash = phase_flash(attention)
    serving = phase_serving(attention)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "flash_fwd", "route": "cuda", "source": "vla_rft_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "vla_rft_tpu/ops/attention.py:108",
        "launches": serving["main_path_launches"], "max_abs_err": flash["max_abs_err_o"],
        "ms": flash["kernel_ms"], "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"], "library_ms": flash["library_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
