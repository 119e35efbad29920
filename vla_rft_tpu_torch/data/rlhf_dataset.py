"""RLHF prompt dataset for the text-RL path (port of
vla_rft_tpu/data/rlhf_dataset.py, verl's RLHFDataset).

Parquet files with a chat-format or string prompt column, tokenized and
LEFT-padded to max_prompt_length, overlong prompts filtered; the data source
and ground truth ride along.  `sample_batch` draws rows with
`np.random.default_rng(seed).integers`, as the reference does, so both
packages draw the same rows.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np


def chat_template_ids(tokenizer, messages) -> List[int]:
    """Token ids of `messages` rendered by the tokenizer's chat template with
    the generation prompt.  transformers 4.x returns the ids as a list;
    a version that returns a BatchEncoding (a mapping with "input_ids")
    gives its ids here too, not its keys."""
    out = tokenizer.apply_chat_template(list(messages), add_generation_prompt=True)
    if hasattr(out, "keys") and "input_ids" in out:
        out = out["input_ids"]
    if hasattr(out, "tolist"):
        out = out.tolist()
    out = list(out)
    if out and isinstance(out[0], (list, tuple)):  # a batch of one conversation
        out = list(out[0])
    return [int(t) for t in out]


class RLHFDataset:
    def __init__(
        self,
        parquet_files,
        tokenizer,
        prompt_key: str = "prompt",
        reward_fn_key: str = "data_source",
        max_prompt_length: int = 256,
        pad_token_id: int = 0,
        filter_overlong_prompts: bool = True,
        seed: int = 0,
    ):
        import pandas as pd

        if isinstance(parquet_files, str):
            parquet_files = [parquet_files]
        frames = [pd.read_parquet(f) for f in parquet_files]
        self.df = frames[0] if len(frames) == 1 else pd.concat(frames, ignore_index=True)
        self.tokenizer = tokenizer
        self.prompt_key = prompt_key
        self.reward_fn_key = reward_fn_key
        self.max_prompt_length = max_prompt_length
        self.pad_token_id = pad_token_id
        self._rng = np.random.default_rng(seed)

        self._rows = []
        for _, row in self.df.iterrows():
            ids = self._tokenize_prompt(row[self.prompt_key])
            if filter_overlong_prompts and len(ids) > max_prompt_length:
                continue
            self._rows.append((ids, row))

    def _tokenize_prompt(self, prompt) -> List[int]:
        if isinstance(prompt, (list, np.ndarray)):  # chat format
            if hasattr(self.tokenizer, "apply_chat_template"):
                return chat_template_ids(self.tokenizer, prompt)
            text = "\n".join(m["content"] for m in prompt)
        else:
            text = str(prompt)
        return list(self.tokenizer.encode(text))

    def __len__(self):
        return len(self._rows)

    def sample_batch(self, batch_size: int) -> Dict[str, Any]:
        """input_ids (batch_size, max_prompt_length) int32, left-padded, and
        each row's data source and ground truth."""
        idx = self._rng.integers(0, len(self._rows), batch_size)
        P = self.max_prompt_length
        input_ids = np.full((batch_size, P), self.pad_token_id, np.int32)
        for j, i in enumerate(idx):
            ids, _ = self._rows[i]
            n = min(len(ids), P)
            input_ids[j, P - n:] = ids[:n]  # LEFT padding
        rows = [self._rows[i][1] for i in idx]
        gts = []
        for r in rows:
            rm = r.get("reward_model", None)
            gts.append(rm["ground_truth"] if isinstance(rm, dict) else r.get("ground_truth", ""))
        return {
            "input_ids": input_ids,
            "data_sources": [r.get(self.reward_fn_key, "gsm8k") for r in rows],
            "ground_truths": gts,
        }
