"""HF tokenizer / processor creation with pad-token fixing (port of
vla_rft_tpu/utils/tokenizer.py; transformers is imported inside the
functions that need it).

Models that ship without a pad token (Qwen2, LLaMA) break left-padded
batching: pad is set to eos.  gemma-2 models keep their real <pad> and end
a message with <end_of_turn> (eos-as-pad would cut generations there).
"""
from __future__ import annotations

import warnings


def set_pad_token_id(tokenizer) -> None:
    if tokenizer.pad_token_id is None:
        tokenizer.pad_token_id = tokenizer.eos_token_id
        warnings.warn(f"tokenizer.pad_token_id was None; set to {tokenizer.eos_token_id}")
    if tokenizer.pad_token is None:
        tokenizer.pad_token = tokenizer.eos_token
        warnings.warn(f"tokenizer.pad_token was None; set to {tokenizer.eos_token}")


def hf_tokenizer(name_or_path, correct_pad_token: bool = True, correct_gemma2: bool = True,
                 **kwargs):
    from transformers import AutoTokenizer

    if correct_gemma2 and isinstance(name_or_path, str) and "gemma-2-2b-it" in name_or_path:
        # gemma-2 ends messages with <end_of_turn>, not eos
        kwargs["eos_token"] = "<end_of_turn>"
        kwargs["eos_token_id"] = 107
    tokenizer = AutoTokenizer.from_pretrained(name_or_path, **kwargs)
    if correct_pad_token:
        set_pad_token_id(tokenizer)
    return tokenizer


def hf_processor(name_or_path, **kwargs):
    """Multimodal processor, None for text-only models (None on any load
    failure, so that text pipelines keep working)."""
    from transformers import AutoProcessor

    try:
        return AutoProcessor.from_pretrained(name_or_path, **kwargs)
    except Exception:
        return None
