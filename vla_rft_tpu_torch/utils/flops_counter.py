"""FLOPs estimates for the throughput / MFU metrics (port of
vla_rft_tpu/utils/flops_counter.py, verl's FlopsCounter): dense-transformer
FLOPs per token from a config plus the attention term, and the other compute
bodies of a VLA-RFT step (ViT towers, the conv tokenizer decoder, the DiT
action expert, VGG16 LPIPS), so `perf/mfu` covers the whole step.  Pure
arithmetic on shapes; the peaks are data-sheet bf16 dense rates.
"""
from __future__ import annotations

from typing import Iterable, Sequence

# bf16 dense peak FLOP/s per device, by device name (NVIDIA data sheets)
PROMISED_FLOPS = {
    "h100": 989e12,
    "h200": 989e12,
}


def device_peak_flops(device_kind: str) -> float:
    """The peak of a device named like `torch.cuda.get_device_name()`, or 0
    for a device without a listed peak (then no MFU is reported)."""
    kind = device_kind.lower()
    for k, v in PROMISED_FLOPS.items():
        if k in kind:
            return v
    return 0.0


class FlopsCounter:
    """estimate_flops(token_sums, delta_time) -> (achieved, promised)."""

    def __init__(self, cfg, device_kind: str = "h100"):
        """cfg: TransformerConfig-like (hidden_size, intermediate_size,
        num_layers, num_heads, num_kv_heads, vocab_size, hd)."""
        self.cfg = cfg
        self.peak = device_peak_flops(device_kind)

    def flops_per_token(self, seqlen: int) -> float:
        c = self.cfg
        hd = c.hd
        qkvo = c.hidden_size * hd * (c.num_heads * 2 + c.num_kv_heads * 2)
        mlp = 3 * c.hidden_size * c.intermediate_size
        emb = c.hidden_size * c.vocab_size  # lm head
        attn = 2 * c.num_heads * hd * seqlen  # score + value matmuls
        per_layer = 2 * (qkvo + mlp + attn)
        return per_layer * c.num_layers + 2 * emb

    def estimate_flops(self, global_token_nums: Iterable[int], delta_time: float):
        total = sum(n * self.flops_per_token(n) for n in global_token_nums)
        achieved = total / max(delta_time, 1e-9)
        return achieved, self.peak


# --------------------------------------------------------------- other bodies
def transformer_flops(
    seqlen: int,
    hidden_size: int,
    num_layers: int,
    intermediate_size: float | None = None,
    num_heads: int | None = None,
    mlp_ratio: float = 4.0,
) -> float:
    """Forward FLOPs of one dense pre-LN transformer sequence (no lm head).
    2*(4h^2 + 2*mlp*h) matmul MACs per token + quadratic attention."""
    inter = intermediate_size if intermediate_size is not None else hidden_size * mlp_ratio
    per_token = 2 * (4 * hidden_size * hidden_size + 2 * hidden_size * inter)
    attn = 2 * 2 * hidden_size * seqlen  # scores + values, all heads together
    return (per_token + attn) * num_layers * seqlen


def vit_flops_per_image(
    image_size: int,
    patch_size: int,
    hidden_size: int,
    num_layers: int,
    mlp_ratio: float = 4.0,
    extra_tokens: int = 0,
) -> float:
    """SigLIP/DINOv2-style ViT forward FLOPs for one image (patch embed +
    transformer)."""
    n = (image_size // patch_size) ** 2 + extra_tokens
    patch_embed = 2 * n * (patch_size * patch_size * 3) * hidden_size
    return patch_embed + transformer_flops(n, hidden_size, num_layers, mlp_ratio=mlp_ratio)


def conv2d_flops(h: int, w: int, cin: int, cout: int, k: int = 3) -> float:
    return 2.0 * h * w * cin * cout * k * k


def conv_decoder_flops_per_frame(
    block_out_channels: Sequence[int] = (128, 256, 512, 512),
    layers_per_block: int = 2,
    out_res: int = 256,
    latent_channels: int = 4,
) -> float:
    """Diffusers-style VAE decoder pyramid (mid block + reversed up blocks,
    layers_per_block+1 resnets each, upsampler convs) — the detokenize body.
    Good to ~10%; used for MFU, not billing."""
    rev = list(reversed(block_out_channels))
    n_up = len(rev)
    res = out_res >> (n_up - 1)  # latent resolution
    total = conv2d_flops(res, res, latent_channels, rev[0])  # conv_in
    # mid block: 2 resnets + 1 attention at latent res
    total += 2 * 2 * conv2d_flops(res, res, rev[0], rev[0])
    total += 4 * 2 * res * res * rev[0] * rev[0]  # qkvo projections
    total += 2 * 2 * (res * res) ** 2 * rev[0]  # scores + values
    ci = rev[0]
    for i, co in enumerate(rev):
        for j in range(layers_per_block + 1):
            c_in = ci if j == 0 else co
            total += conv2d_flops(res, res, c_in, co) + conv2d_flops(res, res, co, co)
            if c_in != co:
                total += conv2d_flops(res, res, c_in, co, k=1)
        ci = co
        if i < n_up - 1:
            res *= 2
            total += conv2d_flops(res, res, co, co)  # upsampler conv
    total += conv2d_flops(res, res, rev[-1], 3)  # conv_out
    return total


VGG16_PLAN = [
    (3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256), (256, 256),
    (256, 512), (512, 512), (512, 512), (512, 512), (512, 512), (512, 512),
]
VGG16_POOL_BEFORE = {2, 4, 7, 10}  # plan indices where resolution halves


def vgg16_flops_per_image(image_size: int = 256) -> float:
    res = image_size
    total = 0.0
    for i, (cin, cout) in enumerate(VGG16_PLAN):
        if i in VGG16_POOL_BEFORE:
            res //= 2
        total += conv2d_flops(res, res, cin, cout)
    return total


def dit_flops(
    num_actions: int,
    s_ctx: int,
    in_channels: int,
    hidden_size: int = 512,
    depth: int = 8,
    mlp_ratio: float = 4.0,
    llm_dim: int = 896,
) -> float:
    """DiT_SingleTokenAction_OneCtx forward for one sample: x embed, adaLN
    blocks (self-attn over num_actions, cross-attn into s_ctx, mlp),
    context adapter."""
    n = num_actions
    h = hidden_size
    total = 2 * n * in_channels * h  # x_embedder
    total += 2 * s_ctx * llm_dim * h  # context adapter
    per_block = (
        2 * (4 * h * h + 2 * h * h * mlp_ratio + 6 * h * h) * n  # qkvo+mlp+adaLN
        + 2 * 2 * h * n * n  # self-attn scores+values
        + 2 * (2 * s_ctx * h * h + 2 * n * h * h)  # cross k/v + q/out
        + 2 * 2 * h * n * s_ctx  # cross scores+values
    )
    total += per_block * depth
    return total


def vla_rft_step_flops(
    num_sequences: int,
    num_uniques: int,
    wm_cfg,
    prompt_len: int,
    response_len: int,
    num_frames: int,
    num_flow_steps: int = 10,
    ppo_epochs: int = 1,
    use_gt_branch: bool = True,
    gt_branch_per_sample: bool = False,
    vlm_seq: int = 96,
) -> float:
    """Whole-step forward+backward FLOPs estimate for perf/mfu (same spirit
    as verl's estimate but covering every model family in the VLA step)."""
    fc = FlopsCounter(wm_cfg)
    # WM: prefill (uniques) + decode over response positions + gt branch
    # (one gt rollout per sample under gt_branch_per_sample, else per row)
    if not use_gt_branch:
        rows = num_sequences
    elif gt_branch_per_sample:
        rows = num_sequences + num_uniques
    else:
        rows = num_sequences * 2
    wm = num_uniques * fc.flops_per_token(prompt_len) * prompt_len
    # decode: each generated token attends to its prefix
    avg_len = prompt_len + response_len / 2
    wm += rows * response_len * fc.flops_per_token(int(avg_len))
    # frozen VLM encode, once per unique sample
    vlm = num_uniques * (
        vit_flops_per_image(224, 14, 1152, 27)  # SigLIP so400m
        + vit_flops_per_image(224, 14, 1024, 24, extra_tokens=5)  # DINOv2-L reg4
        + transformer_flops(vlm_seq + 256, 896, 24, intermediate_size=4864)
    )
    # action expert: rollout flow steps + logp replay + ppo update (fwd+bwd=3x)
    dit_one = dit_flops(num_frames, 56, 7 * 896)
    expert = num_sequences * num_flow_steps * dit_one  # rollout
    expert += num_sequences * num_flow_steps * dit_one  # old logp replay
    expert += 3 * ppo_epochs * num_sequences * num_flow_steps * dit_one  # update
    # tokenizer: encode uniques' frames once; detokenize both branches
    detok = conv_decoder_flops_per_frame()
    tok = num_uniques * (num_frames + 1) * detok  # encode ~ decode cost class
    tok += rows * num_frames * detok
    # LPIPS: VGG on real+pred per row-frame
    lpips = 2 * num_sequences * num_frames * vgg16_flops_per_image(256)
    return wm + vlm + expert + tok + lpips
