"""Batch generation CLI (port of vla_rft_tpu/trainer/main_generation.py,
verl's main_generation).

Loads Qwen2.5-0.5B from the HF checkpoint directory
actor_rollout_ref.model.ckpt_path (its `*.safetensors` and its tokenizer),
reads the prompts of data.train_files through `RLHFDataset` (left-padded to
data.max_prompt_length), generates actor_rollout_ref.rollout.n responses
per prompt, data.train_batch_size prompts at a time, and writes one
`response` column (each decoded up to its response mask) to the parquet
data.output_path.

Usage:
  python -m vla_rft_tpu_torch.trainer.main_generation \
      actor_rollout_ref.model.ckpt_path=<HF model dir> data.train_files=<parquet> \
      [data.output_path=generations.parquet] [actor_rollout_ref.rollout.temperature=0] \
      [--device=cpu]

The device defaults to the card (kernels #1 and #5 per layer); `--device=cpu`
runs the plain PyTorch path.
"""
from __future__ import annotations

import sys
from typing import List, Optional

import torch

from vla_rft_tpu_torch import resolve_device
from vla_rft_tpu_torch.config import vla_rft_default_config
from vla_rft_tpu_torch.convert import flax_to_torch
from vla_rft_tpu_torch.convert_weights import convert_hf_decoder
from vla_rft_tpu_torch.data.rlhf_dataset import RLHFDataset
from vla_rft_tpu_torch.models.transformer import Decoder, TransformerConfig
from vla_rft_tpu_torch.utils.weight_files import load_dir
from vla_rft_tpu_torch.workers.llm_rollout import LLMRolloutConfig, generate_sequences


def load_decoder(model_path: str, cfg: TransformerConfig, device) -> Decoder:
    """A `Decoder` of `cfg` on `device` with the weights of the HF
    checkpoint directory's `*.safetensors` (convert_hf_decoder, then
    flax_to_torch: the one HF-to-torch map)."""
    sd = load_dir(model_path)
    if not sd:
        raise FileNotFoundError(f"no *.safetensors under {model_path}")
    state = flax_to_torch(convert_hf_decoder(sd, cfg), "decoder")
    del sd
    llm = Decoder(cfg)
    llm.load_state_dict(state)
    return llm.to(device).eval()


def run(argv: Optional[List[str]] = None) -> None:
    """Parse `--device=` and the dotted overrides, generate, write the
    parquet."""
    import pandas as pd

    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    for a in list(argv):
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
            argv.remove(a)
    config = vla_rft_default_config().apply_overrides([a for a in argv if "=" in a])
    dev = resolve_device(device)

    model_path = config.actor_rollout_ref.model.ckpt_path
    if not model_path:
        raise SystemExit("actor_rollout_ref.model.ckpt_path is required")
    from transformers import AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(model_path)
    llm = load_decoder(model_path, TransformerConfig.qwen25_0_5b(), dev)

    pad = tokenizer.pad_token_id or 0
    ds = RLHFDataset(
        config.data.get("train_files"), tokenizer,
        max_prompt_length=config.data.get("max_prompt_length", 256), pad_token_id=pad,
    )
    rollout = config.actor_rollout_ref.rollout
    roll = LLMRolloutConfig(response_length=rollout.response_length,
                            temperature=rollout.temperature,
                            eos_token_id=tokenizer.eos_token_id, pad_token_id=pad)
    n = rollout.n
    gen = torch.Generator(device=dev).manual_seed(0)
    bs = config.data.train_batch_size
    responses = []
    for start in range(0, len(ds), bs):
        batch = ds.sample_batch(min(bs, len(ds) - start))
        prompts = torch.repeat_interleave(
            torch.as_tensor(batch["input_ids"], device=dev), n, dim=0)
        out = generate_sequences(llm, gen, prompts, roll)
        resp = out["responses"].cpu().numpy()
        lens = out["response_mask"].sum(dim=1).cpu().numpy()
        for ids, k in zip(resp, lens):
            responses.append(tokenizer.decode(ids[:int(k)].tolist()))
    out_path = config.data.get("output_path", "generations.parquet")
    pd.DataFrame({"response": responses}).to_parquet(out_path)
    print(f"wrote {len(responses)} generations to {out_path}")


if __name__ == "__main__":
    run()
