"""Prismatic pretraining caption / chat datasets (LLaVA chat-JSON format).

Port of vla_rft_tpu/data/caption.py (numpy only at import; PIL is imported
inside `load_image`), which ports the reference's map-style pretraining
data (prismatic/preprocessing/datasets/datasets.py:30-204 AlignDataset /
FinetuneDataset and materialize.py:24-42 get_dataset_and_collator) to a
numpy batch iterator feeding `PrismaticAlignTrainer`:

- align stage: the human prompt is dropped; the model predicts
  "{caption}{eos}" from the image, with the BOS label ignored because the
  vision patches go in right after BOS (`OpenVLA.lm_forward`).
- finetune stage: multi-turn conversations through `QwenPromptBuilder`;
  human turns get IGNORE labels, gpt turns are supervised, EOS goes on the
  last gpt turn.
- a unimodal finetune row (no "image" key) gets zero pixels and
  `is_multimodal` 0.

Images are decoded to [0, 1] RGB at the policy resolution and stacked to 6
channels (both towers see the same RGB; each tower normalises in-model).

Tokenizers are duck-typed: an HF tokenizer (callable, returning an object
with .input_ids, plus .eos_token) or any object with `encode(text) ->
list[int]` (then `bos_token_id`, where set, is prepended for special
tokens).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from vla_rft_tpu_torch.data.prompting import QwenPromptBuilder, pad_collate

IGNORE_INDEX = -100


def _encode(tokenizer, text: str, add_special_tokens: bool) -> List[int]:
    try:
        out = tokenizer(text, add_special_tokens=add_special_tokens)
        return list(out.input_ids if hasattr(out, "input_ids") else out["input_ids"])
    except TypeError:
        ids = list(tokenizer.encode(text))
        if add_special_tokens and getattr(tokenizer, "bos_token_id", None) is not None:
            ids = [tokenizer.bos_token_id] + ids
        return ids


def _eos_text(tokenizer) -> str:
    return getattr(tokenizer, "eos_token", None) or ""


def load_image(path: str, size: int) -> np.ndarray:
    """Decode to (size, size, 6) float32 in [0, 1]: the RGB stacked for the
    two towers (DINOv2 channels 0:3, SigLIP 3:6)."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((size, size), Image.BILINEAR)
    rgb = np.asarray(img, np.float32) / 255.0
    return np.concatenate([rgb, rgb], axis=-1)


class _ChatJsonDataset:
    """Epoch-shuffled batch iterator over a LLaVA-style chat JSON."""

    def __init__(
        self,
        json_path: str,
        image_dir: str,
        tokenizer,
        image_size: int,
        batch_size: int,
        seq_len: int,
        pad_token_id: int = 0,
        seed: int = 0,
    ) -> None:
        with open(json_path) as f:
            self.examples = json.load(f)
        if not self.examples:
            raise ValueError(f"{json_path} holds no examples")
        self.image_dir = image_dir
        self.tokenizer = tokenizer
        self.image_size = image_size
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.pad_token_id = pad_token_id
        self._rng = np.random.default_rng(seed)
        self._order: List[int] = []

    def __len__(self) -> int:
        return len(self.examples)

    # subclasses: example -> dict(input_ids, labels, image path or None)
    def _tokenize(self, example) -> Dict:
        raise NotImplementedError

    def get_modality_lengths(self) -> List:
        """(is_multimodal, word count) per example: the length-grouped
        sampler's key (datasets.py:92-99)."""
        out = []
        for ex in self.examples:
            n = sum(
                len(t["value"].replace("<image>", "").split())
                for t in ex["conversations"]
            )
            out.append(("image" in ex, n))
        return out

    def next_batch(self) -> Dict[str, np.ndarray]:
        rows, pixels, multi = [], [], []
        for _ in range(self.batch_size):
            if not self._order:
                self._order = list(self._rng.permutation(len(self.examples)))
            ex = self.examples[self._order.pop()]
            t = self._tokenize(ex)
            rows.append({"input_ids": np.asarray(t["input_ids"]), "labels": np.asarray(t["labels"])})
            if t["image"] is not None:
                pixels.append(load_image(os.path.join(self.image_dir, t["image"]), self.image_size))
                multi.append(1)
            else:
                pixels.append(np.zeros((self.image_size, self.image_size, 6), np.float32))
                multi.append(0)
        batch = pad_collate(rows, self.pad_token_id, max_length=self.seq_len)
        batch["pixel_values"] = np.stack(pixels)
        batch["is_multimodal"] = np.asarray(multi, np.int32)
        return batch


class AlignCaptionDataset(_ChatJsonDataset):
    """AlignDataset (datasets.py:30-105): predict the caption (the last gpt
    turn) from the image; the human prompt is dropped."""

    def _tokenize(self, ex) -> Dict:
        conv = ex["conversations"]
        if len(conv) != 2 or "<image>" in conv[-1]["value"]:
            raise ValueError(f"an align row holds one human and one gpt turn: {conv}")
        caption = conv[-1]["value"].strip() + _eos_text(self.tokenizer)
        ids = _encode(self.tokenizer, caption, add_special_tokens=True)[: self.seq_len]
        labels = list(ids)
        labels[0] = IGNORE_INDEX  # BOS: the patches go in right after it
        return {"input_ids": ids, "labels": labels, "image": ex.get("image")}


class FinetuneChatDataset(_ChatJsonDataset):
    """FinetuneDataset (datasets.py:108-204): a multi-turn dialog through
    the prompt builder; human turns IGNORE, gpt turns supervised, EOS on the
    last gpt turn; language-only rows carry is_multimodal 0."""

    def _tokenize(self, ex) -> Dict:
        conv = ex["conversations"]
        pb = QwenPromptBuilder()
        ids: List[int] = []
        labels: List[int] = []
        prev = ""  # turn 0's delta carries the system preamble (ignored)
        for i, turn in enumerate(conv):
            # each turn's delta of the rendered chat template (the reference's
            # add_turn returns the wrapped message; this builder renders whole
            # prompts, so successive renders are diffed: the same text)
            pb.add_turn(turn["from"], turn["value"])
            cur = pb.get_prompt()
            msg, prev = cur[len(prev):], cur
            if turn["from"] == "gpt" and i == len(conv) - 1:
                msg += _eos_text(self.tokenizer)
            turn_ids = _encode(self.tokenizer, msg, add_special_tokens=(i == 0))
            ids.extend(turn_ids)
            labels.extend([IGNORE_INDEX] * len(turn_ids) if i % 2 == 0 else turn_ids)
        ids, labels = ids[: self.seq_len], labels[: self.seq_len]
        if "image" in ex and labels:
            labels[0] = IGNORE_INDEX
        return {"input_ids": ids, "labels": labels, "image": ex.get("image")}


_STAGE_REGISTRY = {
    "align": AlignCaptionDataset,
    "finetune": FinetuneChatDataset,
    "full-finetune": FinetuneChatDataset,
}


def get_caption_dataset(stage: str, **kwargs):
    """get_dataset_and_collator (materialize.py:24-42): the stage's dataset;
    collation is part of `next_batch` (padded ids / labels / mask and
    stacked pixels)."""
    if stage not in _STAGE_REGISTRY:
        raise ValueError(f"unknown pretraining stage {stage!r} (align | finetune | full-finetune)")
    return _STAGE_REGISTRY[stage](**kwargs)
