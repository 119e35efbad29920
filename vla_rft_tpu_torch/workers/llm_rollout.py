"""Autoregressive LLM generation for the text-RL path (port of
vla_rft_tpu/workers/llm_rollout.py).

Left-padded prompts (the vLLM convention the trainer code assumes),
per-row `kv_starts` masking of the pad keys, rope positions counted from
each row's first real token, EOS handled by masking after generation
(`get_response_mask`).  The reference's `lax.scan` over the response
becomes a Python loop of one-token decode calls.  On the card:

* the prefill of the P prompt tokens into a P + R cache runs kernel #1
  (`Decoder`'s Sq > 8 branch) with kv_starts = the pad counts, and each of
  the R decode calls runs kernel #5 per layer with per-row kv_starts;
* with `prefix_share_n` = n > 1 the rows are n rollouts of each of B / n
  unique prompts laid out contiguously: one prefill per unique prompt into
  a shared cache (#1), and each decode call attends [shared prefix | own
  response cache] through kernel #4 with shared_starts = kv_starts;
* `compute_log_probs` is one uncached forward with the sequences' positions
  and kv_starts (#1 per layer), the LM head on the response slice only.

Sampling draws from the caller's `torch.Generator` (ops/sampling.py), one
draw per step; temperature 0 or do_sample=False is greedy.  The reference's
TPU re-instancing of the decoder with a larger `decode_block_b` for shared
prefixes is not ported: the CUDA decode kernel plans its own row chunks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from vla_rft_tpu_torch.models.transformer import Decoder
from vla_rft_tpu_torch.ops.masked import (entropy_from_logits, get_response_mask,
                                          logprobs_from_logits)
from vla_rft_tpu_torch.ops.sampling import sample_token


@dataclasses.dataclass(frozen=True)
class LLMRolloutConfig:
    response_length: int = 128
    temperature: float = 1.0
    top_k: int = -1
    top_p: float = 1.0
    do_sample: bool = True
    eos_token_id: int = 2
    pad_token_id: int = 0
    # FIRE sampling (https://arxiv.org/abs/2410.21236): sample the FIRST
    # token at a hotter temperature to diversify rollouts, then continue at
    # `temperature`.
    use_fire_sampling: bool = False
    fire_temperature: float = 3.0


def _sample(gen: torch.Generator, logits: torch.Tensor, cfg: LLMRolloutConfig,
            i: int) -> torch.Tensor:
    if cfg.use_fire_sampling:
        temp = cfg.fire_temperature if i == 0 else cfg.temperature
        return sample_token(gen, logits.float() / temp, 1.0, cfg.top_k, cfg.top_p,
                            cfg.do_sample)
    return sample_token(gen, logits, cfg.temperature, cfg.top_k, cfg.top_p, cfg.do_sample)


@torch.no_grad()
def generate_sequences(
    llm: Decoder,
    gen: torch.Generator,
    prompt_ids: torch.Tensor,  # (B, P) LEFT-padded with pad_token_id
    cfg: LLMRolloutConfig,
    prefix_share_n: int = 1,
) -> Dict[str, torch.Tensor]:
    """Returns the prompts, responses, full sequences, attention_mask,
    position_ids and response_mask, int32 (B, ...) on the model's device:
    the tensor contract of vllm_rollout.generate_sequences.

    prefix_share_n > 1 prefills each unique prompt once into a read-only
    shared cache (rows are the n rollouts of B // n unique prompts, laid
    out contiguously); every decode call attends [shared prefix | own
    response cache]."""
    dev = llm.embed_tokens.weight.device
    prompt_ids = torch.as_tensor(prompt_ids, device=dev).to(torch.int32)
    B, P = prompt_ids.shape
    R = cfg.response_length
    # left padding: all pads are a prefix; the first real token at pad_counts
    kv_starts = (prompt_ids == cfg.pad_token_id).sum(dim=1).to(torch.int32)
    prompt_lens = P - kv_starts
    positions = (torch.arange(P, dtype=torch.int32, device=dev)[None]
                 - kv_starts[:, None]).clamp_min(0)
    n = prefix_share_n
    shared_kw = {}
    if n > 1:
        if B % n:
            raise ValueError(f"{B} rows are not whole groups of prefix_share_n = {n}")
        B_u = B // n
        shared_cache = llm.init_cache(B_u, P)
        logits, _ = llm(prompt_ids[::n], positions=positions[::n], cache=shared_cache,
                        cache_index=0, kv_starts=kv_starts[::n], kv_lens=P,
                        logits_last_only=True)
        last_logits = torch.repeat_interleave(logits[:, -1], n, dim=0)  # (B, V)
        cache = llm.init_cache(B, R)  # own cache: response positions only
        shared_kw = dict(
            shared_cache=shared_cache, shared_len=P,
            prefix_map=torch.repeat_interleave(
                torch.arange(B_u, dtype=torch.int32, device=dev), n),
            shared_starts=kv_starts,
        )
    else:
        cache = llm.init_cache(B, P + R)
        logits, _ = llm(prompt_ids, positions=positions, cache=cache, cache_index=0,
                        kv_starts=kv_starts, kv_lens=P, logits_last_only=True)
        last_logits = logits[:, -1]

    toks = []
    for i in range(R):
        tok = _sample(gen, last_logits, cfg, i)
        step_logits, _ = llm(tok[:, None], positions=(prompt_lens + i)[:, None], cache=cache,
                             cache_index=P + i, kv_starts=kv_starts, kv_lens=P + i + 1,
                             **shared_kw)
        last_logits = step_logits[:, 0]
        toks.append(tok)
    responses = torch.stack(toks, dim=1).to(torch.int32)  # (B, R)

    response_mask = get_response_mask(responses, cfg.eos_token_id)
    # post-EOS tokens -> pad (vLLM pads finished sequences)
    responses = torch.where(response_mask == 1, responses,
                            torch.full_like(responses, cfg.pad_token_id))
    input_ids = torch.cat([prompt_ids, responses], dim=1)
    prompt_mask = (torch.arange(P, device=dev)[None] >= kv_starts[:, None]).to(torch.int32)
    attention_mask = torch.cat([prompt_mask, response_mask], dim=1)
    resp_positions = prompt_lens[:, None] + torch.arange(R, dtype=torch.int32, device=dev)[None]
    position_ids = torch.cat([positions, resp_positions], dim=1)
    return {
        "prompts": prompt_ids,
        "responses": responses,
        "input_ids": input_ids,
        "attention_mask": attention_mask,
        "position_ids": position_ids,
        "response_mask": response_mask,
    }


@torch.no_grad()
def compute_log_probs(
    llm: Decoder,
    input_ids: torch.Tensor,  # (B, P + R) as returned by generate_sequences
    attention_mask: torch.Tensor,
    position_ids: torch.Tensor,
    response_length: int,
    temperature: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced token log-probs and entropy over the response region,
    f32 (B, R).  One forward of the whole sequences (pad keys masked by
    kv_starts, keys past the response mask by kv_lens); the LM head runs on
    the R positions that predict the response only."""
    B, S = input_ids.shape
    R = response_length
    P = S - R
    pad_counts = (1 - attention_mask[:, :P]).sum(dim=1).to(torch.int32)
    _, hidden = llm(input_ids, positions=position_ids, kv_starts=pad_counts,
                    kv_lens=attention_mask.sum(dim=1).to(torch.int32) + pad_counts,
                    compute_logits=False)
    pred_logits = llm.logits(hidden[:, -R - 1:-1]) / temperature
    resp = input_ids[:, -R:]
    return logprobs_from_logits(pred_logits, resp), entropy_from_logits(pred_logits)
