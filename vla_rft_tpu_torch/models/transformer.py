"""Decoder-only transformer (LLaMA / Qwen2 family) with a KV cache.

Port of vla_rft_tpu/models/transformer.py for the policy backbone
(Qwen2.5-0.5B: GQA 14/2 heads with qkv bias, tied embeddings, rope theta
1e6) and the world model (`wm_llama`: 24 layers, 16/16 heads of 64, untied
lm_head): RMSNorm, NeoX rope, GQA attention, SiLU MLP.  The reference's
`nn.scan` over stacked layers becomes a ModuleList.

The KV cache takes either of the reference's layouts (`kv_layout`): the
head-dense "hd" (L, B, S, Hkv*D) or the head-blocked "heads" (L, B, Hkv,
S, D), in the compute dtype or int8 with bf16 per-(position, head) scales
(L, B, Hkv, S) in both.  The two hold the same numbers: a "heads" write
transposes the chunk's k/v to (B, Hkv, S, D) and quantises per (position,
head) as "hd" does.  Unlike the reference, which returns a new cache, the
forward writes the cache tensors in place (one buffer per rollout instead
of a copy per call).  With a shared prefix cache (`shared_cache`,
`shared_len`, `prefix_map`) the own cache holds positions >= shared_len
and writes land at cache_index - shared_len.  Attention with a cache goes
  * Sq <= 8  -> ops.decode_attention_hd for "hd" (CUDA kernel #4 with a
    shared prefix, #5 without, on the card), ops.decode_attention for
    "heads" (#6 with a shared prefix, #7 without; the reference's Pallas
    #7 takes one token and leaves 2-8 token chunks to its XLA fallback,
    the same function);
  * Sq > 8   -> the dequantised layer slice (with the shared prefix
    gathered in front of it) through ops.attention (the flash kernel #1 on
    the card, which takes any Sq).  The reference sends 8 < Sq < 32 and a
    shared prefix with Sq > 8 to its XLA path; that is the same math.
The reference's TPU layout rules are not ported: the head-pair packing of
a "heads" cache (`pack_kv`), the fall back from "hd" to "heads" when
Hkv*D is not a multiple of 128 lanes (`kv_layout_eff`), `decode_block_b`
and the kernels' `row_chunk`.  The port runs the layout it is given.
On a CUDA tensor every branch launches a kernel or raises; the plain twins
run for CPU tensors and when `attn_impl="plain"` asks for them.
With `weights_int8` every product of the decoder is a `QuantLinear` (an
int8 (in, out) kernel and a bf16 per-output-channel scale, the reference's
QuantDenseGeneral), filled by `quantize_decoder_params` from a bf16
decoder's state dict; the WM rollout decodes with it.  `decode_step_fused`
is the rollout's decode call on that model: per layer kernel #8
(RMSNorm + q/k/v + rope + k/v quantisation, writing the cache), the decode
attention #4 / #5 and kernel #9 (o_proj + MLP) on the card.
`decode_step_fused` takes the "hd" layout only, as the reference's does.
Per-row cache offsets (a (B,) `cache_index`, the speculative rollout's
verify calls): each row's positions and causal mask start at its own
offset, and its S new k/v rows (int8 values and their scales, in either
layout, in the own cache of a split cache) are scattered to its own
positions, a start that would not fit clamped as the reference's
dynamic_update_slice clamps it; the decode kernels take the per-row
q_offset and kv_lens as they are.  `decode_step_fused` takes an int offset.
With `remat` (the reference's per-layer nn.remat) a training forward
recomputes each layer in the backward: on the card #1 then runs twice per
layer and step.
Sequence parallelism (`ulysses_axis`, a process group, as the reference's
mesh axis name): each rank passes its slice of the sequence with the
global `positions` and `kv_lens`; rope is applied at the global positions,
then `parallel/ulysses.py`'s all-to-all gives each rank the whole sequence
for H/sp heads, the attention runs there (kernel #1 forward, #2 / #3
backward on the card), and the inverse all-to-all returns the slice.
q / k / v take their head counts from the projections, so a decoder whose
products `parallel/tp.py` split runs its local heads; a cached forward
takes only whole heads and raises on such a decoder.
"""
from __future__ import annotations

import dataclasses
import numbers
from typing import Any, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from vla_rft_tpu_torch.models.layers import Dense, Embed
from vla_rft_tpu_torch.ops import decode_attention as dec_heads
from vla_rft_tpu_torch.ops import decode_attention_hd as dec_attn
from vla_rft_tpu_torch.ops import fused_decode_layer as fused
from vla_rft_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: Optional[int] = None
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    qkv_bias: bool = False
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 8192
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    param_dtype: torch.dtype = torch.bfloat16
    # 'bf16' (the compute dtype) | 'int8' (per-(position, head) scales)
    kv_cache_dtype: str = "bf16"
    # KV cache layout: 'hd' (L, B, S, Hkv*D) or 'heads' (L, B, Hkv, S, D)
    kv_layout: str = "hd"
    # int8 per-output-channel weights for every product (QuantLinear); the
    # state dict comes from quantize_decoder_params.  For a frozen rollout
    # model (the WM): training paths keep bf16.
    weights_int8: bool = False
    # the reference's nn.remat: each layer of an uncached forward under
    # autograd keeps only its input and recomputes the rest in the backward
    # (torch.utils.checkpoint), so the layer's forward runs twice a step
    remat: bool = False
    # sequence parallelism: the process group the sequence is split over
    # (the reference's mesh axis); None runs the whole sequence here
    ulysses_axis: Optional[Any] = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.kv_layout not in ("hd", "heads"):
            raise ValueError(f"kv_layout {self.kv_layout!r}: 'hd' or 'heads'")
        if self.kv_cache_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_cache_dtype {self.kv_cache_dtype!r}")

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @staticmethod
    def wm_llama(vocab_size: int = 9008, **kw) -> "TransformerConfig":
        """The world model: ivideogpt's llama.json with the run's vocab."""
        d = dict(
            vocab_size=vocab_size,
            hidden_size=1024,
            intermediate_size=4096,
            num_layers=24,
            num_heads=16,
            num_kv_heads=16,
            rope_theta=10000.0,
            rms_norm_eps=1e-6,
            qkv_bias=False,
            tie_word_embeddings=False,
        )
        d.update(kw)
        return TransformerConfig(**d)

    @staticmethod
    def qwen25_0_5b(**kw) -> "TransformerConfig":
        d = dict(
            vocab_size=151936,
            hidden_size=896,
            intermediate_size=4864,
            num_layers=24,
            num_heads=14,
            num_kv_heads=2,
            rope_theta=1_000_000.0,
            rms_norm_eps=1e-6,
            qkv_bias=True,
            tie_word_embeddings=True,
            max_position_embeddings=32768,
        )
        d.update(kw)
        return TransformerConfig(**d)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, param_dtype=torch.bfloat16):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim, dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        xf = xf * torch.rsqrt(var + self.eps)
        return (xf * self.weight.float()).to(x.dtype)


class QuantLinear(nn.Module):
    """The reference's QuantDenseGeneral: an int8 (in, out) `kernel` and a
    bf16 (out,) `scale` (buffers: they are frozen), optional bf16 bias.
    y = bf16(x @ bf16(kernel)) (f32 accumulation), then times the scale in
    the compute dtype, in that rounding order."""

    def __init__(self, in_features: int, out_features: int, *, bias: bool = False,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("kernel", torch.zeros(in_features, out_features, dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features, dtype=torch.bfloat16))
        self.register_buffer("bias", torch.zeros(out_features, dtype=torch.bfloat16)
                             if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = (x.to(dt) @ self.kernel.to(dt)) * self.scale.to(dt)
        return y if self.bias is None else y + self.bias.to(dt)


def make_dense(cfg: TransformerConfig, in_features: int, out_features: int, bias: bool):
    """The decoder's product: QuantLinear with `weights_int8`, else Dense."""
    if cfg.weights_int8:
        return QuantLinear(in_features, out_features, bias=bias, dtype=cfg.dtype)
    return Dense(in_features, out_features, bias=bias, dtype=cfg.dtype,
                 param_dtype=cfg.param_dtype)


_QUANTIZED = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj",
              "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")


@torch.no_grad()
def quantize_decoder_params(state_dict, cfg: TransformerConfig):
    """A bf16 `Decoder` state dict -> the state dict of its `weights_int8`
    twin (reference transformer.py:213): every product's (out, in) weight
    becomes an (in, out) int8 kernel, per output channel s = max(amax / 127,
    1e-10) in f32, q = clip(round(w / s), -127, 127) (round half to even),
    and the scale is stored as bf16; embedding, norms and biases stay (a
    bias becomes bf16).  Runs on the tensors' own device."""

    def quant(w):
        w2 = w.float().t()  # (in, out)
        s = torch.clamp(w2.abs().amax(dim=0) / 127.0, min=1e-10)
        q = torch.clamp(torch.round(w2 / s), -127, 127).to(torch.int8)
        return q.contiguous(), s.to(torch.bfloat16)

    out = {}
    for name, t in state_dict.items():
        mod, _, leaf = name.rpartition(".")
        is_prod = mod == "lm_head" or any(mod.endswith(p) for p in _QUANTIZED)
        if is_prod and leaf == "weight":
            out[f"{mod}.kernel"], out[f"{mod}.scale"] = quant(t)
        elif is_prod and leaf == "bias":
            out[name] = t.to(torch.bfloat16)
        else:
            out[name] = t
    return out


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """NeoX-style rotary embedding. x: (B, S, H, D), positions: (B, S)."""
    d = x.shape[-1]
    exponent = torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    freqs = 1.0 / (theta ** exponent)
    angles = positions[..., None].float() * freqs  # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, H, D) -> int8 values (B, S, H, D) and bf16 scales (B, S, H):
    scale = max|x| / 127 per (position, head), floored at 1e-8; values are
    rounded half to even with the f32 scale and clipped to +-127, and only
    then is the scale stored as bf16 (reference transformer.py:405-416)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def _rows(x, B: int, dev) -> torch.Tensor:
    """A per-row int32 (B,) tensor from an int (filled on the device) or a
    scalar / (B,) tensor."""
    if isinstance(x, numbers.Integral):
        return torch.full((B,), int(x), dtype=torch.int32, device=dev)
    return torch.as_tensor(x, device=dev).to(torch.int32).reshape(-1).expand(B).contiguous()


@dataclasses.dataclass
class CacheArgs:
    """What one forward with a KV cache passes to every layer; the per-row
    values are (B,) int32 tensors on the model's device."""
    cache: Tuple[torch.Tensor, ...]
    cache_index: Union[int, torch.Tensor]  # an int, or (B,) per-row offsets
    kv_lens_eff: torch.Tensor  # min(kv_lens, cache_index + S)
    q_offset: torch.Tensor  # cache_index, per row
    kv_starts: torch.Tensor  # absolute start of the valid keys
    shared_cache: Optional[Tuple[torch.Tensor, ...]]
    shared_len: int
    prefix_map: Optional[torch.Tensor]
    shared_starts: torch.Tensor


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        H, hd, nh, nkv = cfg.hidden_size, cfg.hd, cfg.num_heads, cfg.num_kv_heads
        self.q_proj = make_dense(cfg, H, nh * hd, cfg.qkv_bias)
        self.k_proj = make_dense(cfg, H, nkv * hd, cfg.qkv_bias)
        self.v_proj = make_dense(cfg, H, nkv * hd, cfg.qkv_bias)
        self.o_proj = make_dense(cfg, nh * hd, H, False)

    def forward(self, x, positions, kv_lens, causal: bool, attn_impl: str, li: int = 0,
                c: Optional[CacheArgs] = None, kv_starts=None):
        cfg = self.cfg
        B, S, _ = x.shape
        # the local head counts: all of them, or this rank's under TP
        q = self.q_proj(x).view(B, S, -1, cfg.hd)
        k = self.k_proj(x).view(B, S, -1, cfg.hd)
        v = self.v_proj(x).view(B, S, -1, cfg.hd)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if c is not None:
            if q.shape[2] != cfg.num_heads or k.shape[2] != cfg.num_kv_heads:
                raise ValueError(
                    f"a cached forward takes all {cfg.num_heads}/{cfg.num_kv_heads} heads; this "
                    f"decoder is tensor-parallel ({q.shape[2]}/{k.shape[2]} local heads)")
            out = self._cached(q, k, v, li, c, attn_impl)
        elif cfg.ulysses_axis is not None:
            from vla_rft_tpu_torch.parallel.ulysses import ulysses_attention

            out = ulysses_attention(q, k, v, cfg.ulysses_axis, causal=causal, kv_lens=kv_lens,
                                    kv_starts=kv_starts, impl=attn_impl)
        else:
            out = attention(q, k, v, causal=causal, kv_lens=kv_lens, kv_starts=kv_starts,
                            impl=attn_impl)
        return self.o_proj(out.reshape(B, S, -1))

    def _cached(self, q, k, v, li: int, c: CacheArgs, attn_impl: str):
        cfg = self.cfg
        B, S, nkv, hd = k.shape
        w0 = c.cache_index - (c.shared_len if c.shared_cache is not None else 0)
        heads = cfg.kv_layout == "heads"
        ops = dec_heads if heads else dec_attn
        if isinstance(w0, torch.Tensor):
            # per-row offsets: row b's S positions start at w0[b], clamped
            # into the cache as the reference's dynamic_update_slice clamps
            Sc = c.cache[0].shape[3 if heads else 2]
            pos = (w0.long().clamp(0, Sc - S)[:, None]
                   + torch.arange(S, device=k.device)[None])  # (B, S)
            rows = torch.arange(B, device=k.device)[:, None]

        def put(cache, x, seq_axis: int):
            """x (B, S, ...) position-major into layer li of `cache`, whose
            sequence axis (after the layer) is 1 ("hd" values) or 2 ("heads"
            values, and the (B, Hkv, S) scales of both layouts)."""
            c = cache[li]
            if not isinstance(w0, torch.Tensor):
                if seq_axis == 1:
                    c[:, w0:w0 + S] = x
                else:
                    c[:, :, w0:w0 + S] = x.transpose(1, 2)
            elif seq_axis == 1:
                c[rows, pos] = x
            else:  # the advanced indices around the slice put (B, S) first
                c[rows, :, pos] = x

        def write(cache, x):  # (B, S, Hkv, D) into layer li at w0, in the layout
            if heads:
                put(cache, x, 2)
            else:
                put(cache, x.reshape(B, S, nkv * hd), 1)

        int8 = cfg.kv_cache_dtype == "int8"
        if int8:
            ck, cv, sk, sv = c.cache
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
            write(ck, kq)
            write(cv, vq)
            put(sk, ks, 2)
            put(sv, vs, 2)
            scales = (sk[li], sv[li])
        else:
            ck, cv = c.cache
            write(ck, k.to(ck.dtype))
            write(cv, v.to(cv.dtype))
            scales = None
        if c.shared_cache is not None:
            if int8:
                sck, scv, ssk, ssv = c.shared_cache
                shared_scales = (ssk[li], ssv[li])
            else:
                (sck, scv), shared_scales = c.shared_cache, None
            if S <= ops.MAX_SQ:  # kernel #4 ("hd") / #6 ("heads")
                attend = (dec_heads.decode_attention_shared if heads
                          else dec_attn.decode_attention_shared_hd)
                return attend(
                    q, ck[li], cv[li], sck[li], scv[li], c.prefix_map, shared_len=c.shared_len,
                    kv_lens=c.kv_lens_eff, q_offset=c.q_offset, shared_starts=c.shared_starts,
                    scales=scales, shared_scales=shared_scales, impl=attn_impl,
                )
            k_all, v_all = ops.shared_kv(ck[li], cv[li], sck[li], scv[li], c.prefix_map,
                                         c.shared_len, hd, q.dtype, scales, shared_scales)
            starts = c.shared_starts
        elif S <= ops.MAX_SQ:  # kernel #5 ("hd") / #7 ("heads")
            attend = dec_heads.decode_attention if heads else dec_attn.decode_attention_hd
            return attend(
                q, ck[li], cv[li], kv_lens=c.kv_lens_eff, q_offset=c.q_offset,
                kv_starts=c.kv_starts, scales=scales, impl=attn_impl,
            )
        else:
            k_all = ops.dequantize(ck[li], scales[0] if int8 else None, hd, q.dtype)
            v_all = ops.dequantize(cv[li], scales[1] if int8 else None, hd, q.dtype)
            starts = c.kv_starts
        # longer chunks (prefill, or any S > 8): attend over the cache as
        # stored (int8 dequantised, the prefix gathered) through kernel #1
        return attention(q, k_all, v_all, causal=True, kv_lens=c.kv_lens_eff,
                         q_offset=c.q_offset, kv_starts=starts, impl=attn_impl)


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        H, I = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = make_dense(cfg, H, I, False)
        self.up_proj = make_dense(cfg, H, I, False)
        self.down_proj = make_dense(cfg, I, H, False)

    def forward(self, x):
        g, u = self.gate_proj(x), self.up_proj(x)
        # silu as the reference rounds it: the sigmoid (computed in f32 and
        # rounded to the compute dtype), then two products
        return self.down_proj(g * torch.sigmoid(g) * u)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.param_dtype)
        self.self_attn = Attention(cfg)
        self.post_attention_layernorm = RMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, cfg.param_dtype
        )
        self.mlp = MLP(cfg)

    def forward(self, x, positions, kv_lens, causal, attn_impl, li=0, c=None, kv_starts=None):
        x = x + self.self_attn(self.input_layernorm(x), positions, kv_lens, causal, attn_impl,
                               li, c, kv_starts)
        return x + self.mlp(self.post_attention_layernorm(x))


class Decoder(nn.Module):
    """LLaMA/Qwen2-style causal decoder with an optional KV cache.

    Call conventions (as the reference's):
      * full forward: input_ids | inputs_embeds [, kv_lens];
      * prefill: a fresh `init_cache` and cache_index=0;
      * decode: the same cache and cache_index = tokens so far.
    The cache tuple is written in place.  `attn_impl` is "auto" (the CUDA
    kernels for CUDA tensors, the plain twins for CPU tensors) or "plain"
    (the twins everywhere, the reference the kernel path is checked
    against on the card)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.attn_impl = "auto"
        self.embed_tokens = Embed(
            cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype, param_dtype=cfg.param_dtype
        )
        self.layers = nn.ModuleList(DecoderLayer(cfg) for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.param_dtype)
        self.lm_head = (
            None if cfg.tie_word_embeddings
            else make_dense(cfg, cfg.hidden_size, cfg.vocab_size, False)
        )

    def forward(
        self,
        input_ids: Optional[torch.Tensor] = None,
        inputs_embeds: Optional[torch.Tensor] = None,
        kv_lens=None,
        causal: bool = True,
        compute_logits: bool = True,
        embed_only: bool = False,
        cache: Optional[Tuple[torch.Tensor, ...]] = None,
        cache_index: Union[int, torch.Tensor] = 0,
        logits_last_only: bool = False,
        kv_starts=None,
        shared_cache: Optional[Tuple[torch.Tensor, ...]] = None,
        shared_len: int = 0,
        prefix_map=None,
        shared_starts=None,
        positions=None,
    ):
        """embed_only -> token embeddings (B, S, H); otherwise
        (logits (B, S or 1, V) f32 or None, hidden (B, S, H) after the final
        norm).  With `cache`, positions start at `cache_index` and kv_lens
        defaults to cache_index + S.  `cache_index` is an int, or a (B,)
        tensor of per-row offsets (the speculative rollout's verify calls,
        where rows advance at different rates): row b's positions, cache
        writes and causal mask then start at cache_index[b].  `positions`
        (B, S), when given, are the rope positions instead (left-padded text
        rows count from their first real token, not from the cache offset);
        the causal mask and cache writes still follow `cache_index`.
        `kv_starts` (B,) masks each row's keys before it, with or without a
        cache; a query with no valid key (a left-pad position) gives 0."""
        cfg = self.cfg
        if embed_only:
            return self.embed_tokens(input_ids)
        if inputs_embeds is None:
            inputs_embeds = self.embed_tokens(input_ids)
        B, S, _ = inputs_embeds.shape
        dev = inputs_embeds.device
        rows = lambda x: _rows(x, B, dev)
        off = cache_index if cache is not None else 0
        if isinstance(off, torch.Tensor):  # per-row offsets (speculative verify calls)
            off = rows(off)
        if positions is not None:
            positions = torch.as_tensor(positions, device=dev).to(torch.int32).expand(B, S)
        elif isinstance(off, torch.Tensor):
            positions = torch.arange(S, dtype=torch.int32, device=dev)[None] + off[:, None]
        else:
            positions = (torch.arange(S, dtype=torch.int32, device=dev) + off)[None].expand(B, S)

        kv_lens = rows(off + S if kv_lens is None else kv_lens)
        c = None
        if cache is not None:
            if not causal:
                raise ValueError("a forward with a KV cache is causal")
            c = CacheArgs(
                cache=cache, cache_index=off,
                kv_lens_eff=torch.minimum(kv_lens, rows(off + S)),
                q_offset=rows(off), kv_starts=rows(0 if kv_starts is None else kv_starts),
                shared_cache=shared_cache, shared_len=shared_len,
                prefix_map=None if prefix_map is None else rows(prefix_map),
                shared_starts=rows(0 if shared_starts is None else shared_starts),
            )
        starts = None if c is not None or kv_starts is None else rows(kv_starts)
        remat = cfg.remat and c is None and torch.is_grad_enabled()
        x = inputs_embeds
        for li, layer in enumerate(self.layers):
            args = (x, positions, kv_lens, causal, self.attn_impl, li, c, starts)
            x = checkpoint(layer, *args, use_reentrant=False) if remat else layer(*args)
        x = self.norm(x)
        logits = None
        if compute_logits:
            logits = self.logits(x[:, -1:] if logits_last_only else x)
        return logits, x

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits of final-norm hidden states (the tied embedding's
        `attend`, or `lm_head`)."""
        if self.cfg.tie_word_embeddings:
            return self.embed_tokens.attend(x.to(self.cfg.dtype)).float()
        return self.lm_head(x).float()

    def init_cache(self, batch_size: int, max_len: int) -> Tuple[torch.Tensor, ...]:
        """A zeroed cache on the model's device: K and V in the layout,
        (L, B, S, Hkv*D) for "hd" or (L, B, Hkv, S, D) for "heads", S
        rounded up to 128 for int8 and to 8 otherwise, plus (L, B, Hkv, S)
        bf16 scales set to 1 for int8."""
        cfg = self.cfg
        align = 128 if cfg.kv_cache_dtype == "int8" else 8
        S = (max_len + align - 1) // align * align
        dev = self.embed_tokens.weight.device
        L, nkv = cfg.num_layers, cfg.num_kv_heads
        shape = ((L, batch_size, nkv, S, cfg.hd) if cfg.kv_layout == "heads"
                 else (L, batch_size, S, nkv * cfg.hd))
        if cfg.kv_cache_dtype == "int8":
            sshape = (L, batch_size, nkv, S)
            return (
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.ones(sshape, dtype=torch.bfloat16, device=dev),
                torch.ones(sshape, dtype=torch.bfloat16, device=dev),
            )
        return (torch.zeros(shape, dtype=cfg.dtype, device=dev),
                torch.zeros(shape, dtype=cfg.dtype, device=dev))

    def cache_seq_axes(self) -> Tuple[int, ...]:
        """The sequence axis of each array of `init_cache`'s tuple."""
        kv_ax = 3 if self.cfg.kv_layout == "heads" else 2
        return (kv_ax, kv_ax, 3, 3) if self.cfg.kv_cache_dtype == "int8" else (kv_ax, kv_ax)


@torch.no_grad()
def decode_step_fused(wm: Decoder, input_ids: torch.Tensor, cache: Tuple[torch.Tensor, ...],
                      cache_index: int, kv_lens=None,
                      shared_cache: Optional[Tuple[torch.Tensor, ...]] = None,
                      shared_len: int = 0, prefix_map=None, shared_starts=None,
                      logits_last_only: bool = False, impl: Optional[str] = None):
    """One decode call of the int8-weight WM through the fused layer kernels
    (reference transformer.py:797-913): per layer kernel #8 (RMSNorm, q/k/v,
    rope, k/v quantisation), then decode attention over the split cache (#4
    with a shared prefix, #5 without), then kernel #9 (o_proj, residual,
    RMSNorm, MLP, residual); rope tables are built once per call.  Same
    contract as `Decoder.forward` on the decode path: input_ids (B, Sq <= 8),
    the int8 KV cache written in place (k/v and their scales go straight
    from kernel #8 into the cache at cache_index, or cache_index -
    shared_len with a shared prefix), returns (logits f32, hidden after the
    final norm).  `impl` is "auto" (kernels for CUDA tensors, twins for CPU
    tensors) or "plain"; it defaults to the model's `attn_impl`."""
    cfg = wm.cfg
    if not (cfg.weights_int8 and cfg.kv_cache_dtype == "int8" and cfg.kv_layout == "hd"
            and not cfg.qkv_bias):
        raise ValueError("decode_step_fused needs int8 weights, an int8 'hd' KV cache and no "
                         "qkv bias")
    B, S = input_ids.shape
    if not 1 <= S <= dec_attn.MAX_SQ:
        raise ValueError(f"decode_step_fused takes 1..{dec_attn.MAX_SQ} tokens, got {S}")
    impl = impl or wm.attn_impl
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    dev = input_ids.device

    rows = lambda v: _rows(v, B, dev)
    x = wm.embed_tokens(input_ids).contiguous()
    positions = (torch.arange(S, dtype=torch.int32, device=dev) + cache_index)[None].expand(B, S)
    kv_lens_eff = torch.clamp(rows(cache_index + S if kv_lens is None else kv_lens),
                              max=cache_index + S)
    q_offset = rows(cache_index)
    w0 = cache_index - shared_len if shared_cache is not None else cache_index
    rope_cos, rope_sins = fused.rope_tables(positions, cfg.rope_theta, nh, hd)
    ck, cv, sk, sv = cache
    if shared_cache is not None:
        sck, scv, ssk, ssv = shared_cache
        pm = rows(prefix_map)
        starts = rows(0 if shared_starts is None else shared_starts)
    else:
        starts = rows(0)
    for li, layer in enumerate(wm.layers):
        at, mlp = layer.self_attn, layer.mlp
        q, *_ = fused.fused_rmsnorm_qkv(
            x, rope_cos, rope_sins, layer.input_layernorm.weight,
            at.q_proj.kernel, at.q_proj.scale, at.k_proj.kernel, at.k_proj.scale,
            at.v_proj.kernel, at.v_proj.scale, num_heads=nh, num_kv_heads=nkv, head_dim=hd,
            eps=cfg.rms_norm_eps, impl=impl,
            out=(ck[li, :, w0:w0 + S], cv[li, :, w0:w0 + S], sk[li, :, :, w0:w0 + S],
                 sv[li, :, :, w0:w0 + S]),
        )
        q = q.view(B, S, nh, hd)
        if shared_cache is not None:
            attn = dec_attn.decode_attention_shared_hd(
                q, ck[li], cv[li], sck[li], scv[li], pm, shared_len=shared_len,
                kv_lens=kv_lens_eff, q_offset=q_offset, shared_starts=starts,
                scales=(sk[li], sv[li]), shared_scales=(ssk[li], ssv[li]), impl=impl)
        else:
            attn = dec_attn.decode_attention_hd(
                q, ck[li], cv[li], kv_lens=kv_lens_eff, q_offset=q_offset, kv_starts=starts,
                scales=(sk[li], sv[li]), impl=impl)
        x = fused.fused_o_mlp(
            attn.reshape(B, S, nh * hd), x, at.o_proj.kernel, at.o_proj.scale,
            layer.post_attention_layernorm.weight, mlp.gate_proj.kernel, mlp.gate_proj.scale,
            mlp.up_proj.kernel, mlp.up_proj.scale, mlp.down_proj.kernel, mlp.down_proj.scale,
            eps=cfg.rms_norm_eps, impl=impl)
    xn = wm.norm(x)
    xl = xn[:, -1:] if logits_last_only else xn
    if cfg.tie_word_embeddings:
        logits = wm.embed_tokens.attend(xl)
    else:
        logits = wm.lm_head(xl)
    return logits.float(), xn
