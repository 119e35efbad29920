"""The push task's policy inputs: its prompt row and its image resize.

Port of the part of vla_rft_tpu/data/push_data.py that the push policy
runs (numpy only; PIL is imported inside `resize_uint8`):

* `resize_uint8`: the Lanczos resize of a rendered view to the policy's
  64 px input (tools/rft_evidence.py's evaluation protocol);
* `build_push_prompt`: the fixed prompt row with its action-query span,
  as the push preset's policy was trained on.

The segment collection, the segment dataset and the segment files are
ported with the push trainer that reads them.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from vla_rft_tpu_torch.models.action_masks import ACTION_TOKEN_BEGIN_IDX


def resize_uint8(img: np.ndarray, size: int) -> np.ndarray:
    """Lanczos resize (PIL), uint8 in/out — same resampler as the eval glue's
    resize_image_for_policy."""
    from PIL import Image

    if img.shape[0] == size and img.shape[1] == size:
        return np.asarray(img, np.uint8)
    pil = Image.fromarray(np.asarray(img, np.uint8)).resize(
        (size, size), Image.LANCZOS
    )
    return np.asarray(pil, np.uint8)


def build_push_prompt(
    seq_len: int, num_tokens: int, task: str = "push the red cube into the green target zone"
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fixed prompt row: [BOS, task-derived pseudo tokens, num_tokens action
    tokens, EOS, pad].  The task is constant across the suite, so the text
    token VALUES only need to be deterministic — the policy conditions on the
    image; labels mark the action-query span exactly like the RLDS transform
    (RLDSBatchTransform_V1, datasets.py:300-433)."""
    text = np.frombuffer(task.encode(), np.uint8).astype(np.int64) + 1000
    text_len = seq_len - num_tokens - 2
    text = text[:text_len]
    input_ids = np.zeros(seq_len, np.int64)
    labels = np.full(seq_len, -100, np.int64)
    attn = np.zeros(seq_len, np.int64)
    input_ids[0] = 1  # BOS
    input_ids[1 : 1 + len(text)] = text
    start = 1 + len(text)
    action_ids = ACTION_TOKEN_BEGIN_IDX + 1 + (np.arange(num_tokens) % 100)
    input_ids[start : start + num_tokens] = action_ids
    labels[start : start + num_tokens] = action_ids
    input_ids[start + num_tokens] = 2  # EOS
    attn[: start + num_tokens + 1] = 1
    return input_ids.astype(np.int32), attn.astype(np.int32), labels.astype(np.int32)
