"""Data that the text and align SFT stages read, written without a download:
a prompt / response parquet, a LLaVA chat JSON with PNGs, and a word-level
HF tokenizer directory that AutoTokenizer reads offline.

chip_smoke.py's `sft_text` and `sft_align` phases and the CPU tests of the
port's SFT stages (test_torch_sft.py, test_torch_sft_stages.py,
test_torch_caption.py) write their files with these functions.
"""
import json
import os

import numpy as np

WORD_SPECIALS = ("[PAD]", "[UNK]", "[BOS]", "[EOS]")  # ids 0..3


def write_word_tokenizer(path: str, texts) -> int:
    """An HF tokenizer over the words of `texts`, written into `path` by
    PreTrainedTokenizerFast.save_pretrained (AutoTokenizer.from_pretrained
    reads it offline): word-level, split on whitespace and punctuation, BOS
    prepended where special tokens are added, [PAD] 0, [EOS] 3.  Returns the
    vocabulary size."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors
    from transformers import PreTrainedTokenizerFast

    pre = pre_tokenizers.Whitespace()
    vocab = {t: i for i, t in enumerate(WORD_SPECIALS)}
    for text in texts:
        for word, _ in pre.pre_tokenize_str(text):
            vocab.setdefault(word, len(vocab))
    tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre
    tok.post_processor = processors.TemplateProcessing(
        single="[BOS] $A", pair="[BOS] $A $B", special_tokens=[("[BOS]", 2)])
    PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="[PAD]", unk_token="[UNK]",
                            bos_token="[BOS]", eos_token="[EOS]").save_pretrained(path)
    return len(vocab)


def write_sft_parquet(path: str, n_rows: int, lengths: tuple, n_words: int, seed: int) -> list:
    """A prompt / response parquet of `n_rows` rows of words w0..w{n_words-1}
    whose word counts spread over [lengths[0], lengths[1]) (a prompt share of
    30-70 %); returns the words for the tokenizer."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(n_words)]
    rows = {"prompt": [], "response": []}
    for n in np.linspace(*lengths, n_rows, endpoint=False).astype(int)[rng.permutation(n_rows)]:
        text = rng.choice(words, n)
        cut = int(n * rng.uniform(0.3, 0.7))
        rows["prompt"].append(" ".join(text[:cut]))
        rows["response"].append(" ".join(text[cut:]))
    pd.DataFrame(rows).to_parquet(path)
    return words


CAPTION_WORDS = ("a red green blue cube bowl plate cup on the table next to under behind of "
                 "robot gripper holds left right side white black drawer open closed").split()


def write_chat_data(root: str, size: int, n_images: int = 8, n_align: int = 6,
                    seed: int = 0) -> dict:
    """`n_images` PNGs and two LLaVA chat JSONs under `root`: `align.json`
    (`n_align` image-caption rows, the human turn first) and
    `finetune.json` (those rows and two 4-turn dialogs, the second without
    an image).  Returns the paths and every text (for the tokenizer)."""
    from PIL import Image

    from vla_rft_tpu_torch.data.prompting import QwenPromptBuilder

    rng = np.random.default_rng(seed)
    for i in range(n_images):
        px = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        Image.fromarray(px).save(os.path.join(root, f"img{i}.png"))
    sentence = lambda lo, hi: " ".join(rng.choice(CAPTION_WORDS, rng.integers(lo, hi)))
    align = [{"image": f"img{i}.png",
              "conversations": [{"from": "human", "value": "<image>\nDescribe the image."},
                                {"from": "gpt", "value": sentence(4, 40)}]}
             for i in range(n_align)]
    dialog = lambda: [{"from": "human", "value": "<image>\nWhat is on the table?"},
                      {"from": "gpt", "value": sentence(5, 20)},
                      {"from": "human", "value": "And " + sentence(2, 6) + "?"},
                      {"from": "gpt", "value": sentence(5, 20)}]
    finetune = align + [{"image": f"img{n_images - 1}.png", "conversations": dialog()},
                        {"conversations": dialog()}]
    finetune[-1]["conversations"][0]["value"] = "Say what a robot gripper holds."
    paths = {"image_dir": root, "align": os.path.join(root, "align.json"),
             "finetune": os.path.join(root, "finetune.json")}
    for key, rows in (("align", align), ("finetune", finetune)):
        with open(paths[key], "w") as f:
            json.dump(rows, f)
    pb = QwenPromptBuilder()
    pb.add_turn("human", "x")
    pb.add_turn("gpt", "y")
    paths["texts"] = [pb.get_prompt()] + [t["value"] for row in finetune
                                          for t in row["conversations"]]
    return paths


CHAT_WORDS = ("system", "user", "assistant", ":")  # ids 4..7 of write_chat_tokenizer
CHAT_TEMPLATE = ("{% for m in messages %}{{ m['role'] }} : {{ m['content'] }} {% endfor %}"
                 "{% if add_generation_prompt %}assistant :{% endif %}")


def write_chat_tokenizer(path: str, vocab_size: int) -> int:
    """A word-level HF tokenizer of exactly `vocab_size` ids with a minimal
    chat template, written into `path` (AutoTokenizer reads it offline):
    [PAD] 0, [UNK] 1, [BOS] 2, [EOS] 3, the chat words (role names and ":")
    4..7, then w0, w1, ... up to the last id, so that every id a model of
    that vocabulary emits decodes to a word.  No BOS is added.  Returns the
    vocabulary size."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {t: i for i, t in enumerate(WORD_SPECIALS + CHAT_WORDS)}
    for i in range(vocab_size - len(vocab)):
        vocab[f"w{i}"] = len(vocab)
    tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="[PAD]", unk_token="[UNK]",
                                   bos_token="[BOS]", eos_token="[EOS]")
    fast.chat_template = CHAT_TEMPLATE
    fast.save_pretrained(path)
    return len(vocab)


def write_rlhf_parquet(path: str, lengths, n_words: int, seed: int, chat: bool = True,
                       data_source: str = "openai/gsm8k") -> list:
    """A gsm8k-style prompt parquet: one row per entry of `lengths`, a user
    message (or a plain string with `chat=False`) of that many words drawn
    from w0..w{n_words-1}, `data_source`, `reward_model.ground_truth` (a
    number) and `extra_info.index`.  Returns the ground truths."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    rows = {"data_source": [], "prompt": [], "reward_model": [], "extra_info": []}
    gts = []
    for i, n in enumerate(lengths):
        text = " ".join(f"w{j}" for j in rng.integers(0, n_words, int(n)))
        gts.append(str(int(rng.integers(0, 1000))))
        rows["data_source"].append(data_source)
        rows["prompt"].append([{"role": "user", "content": text}] if chat else text)
        rows["reward_model"].append({"style": "rule", "ground_truth": gts[-1]})
        rows["extra_info"].append({"index": i})
    pd.DataFrame(rows).to_parquet(path)
    return gts
