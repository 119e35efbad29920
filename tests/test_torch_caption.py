"""The port's caption / chat datasets (vla_rft_tpu_torch/data/caption.py)
against the JAX package's, on the CPU.

A LLaVA chat JSON and PNGs of odd sizes in tmp_path (written by
tests/sft_data.py's writer, as the card's sft_align phase writes them, plus
two smaller files); both packages' datasets read them with the same
tokenizer and every field of 3 batches must be bit-equal (the batches run
past the end of an epoch).  Two tokenizers: a duck-typed one with `encode`
only (the `TypeError` route, BOS prepended by hand) and an HF tokenizer
built offline with `tokenizers` (BOS from its post-processor), read back
as the PreTrainedTokenizerFast that AutoTokenizer gives for its directory
(transformers' auto classes take some 9 s to import on the CPU).  Also:
`load_image`, `get_modality_lengths`, the registry's `ValueError`.
"""
import json
import pathlib
import zlib

import numpy as np
import pytest

import sft_data
from vla_rft_tpu.data import caption as j_cap
from vla_rft_tpu_torch.data import caption as t_cap


class EncodeOnlyTokenizer:
    """No __call__, so `_encode` takes its TypeError route to encode()."""

    eos_token = "<eos>"
    bos_token_id = 1

    def encode(self, text):
        return [zlib.crc32(w.encode()) % 997 + 3 for w in text.split()]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("caption")
    paths = sft_data.write_chat_data(str(d), size=20, n_images=4, n_align=3, seed=1)
    from PIL import Image

    rng = np.random.default_rng(2)
    for name, shape in (("wide.png", (13, 31, 3)), ("gray.png", (25, 18))):
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(d / name)
    odd = [{"image": "wide.png", "conversations": [
               {"from": "human", "value": "Caption this.\n<image>"},
               {"from": "gpt", "value": "  a blue cup under the drawer  "}]},
           {"image": "gray.png", "conversations": [
               {"from": "human", "value": "<image>"}, {"from": "gpt", "value": "white plate"}]}]
    (d / "odd.json").write_text(json.dumps(odd))
    paths["odd"] = str(d / "odd.json")
    return paths


@pytest.fixture(scope="module")
def hf(data):
    """The word-level HF tokenizer over every text of `data`."""
    from transformers import PreTrainedTokenizerFast

    tok_dir = str(pathlib.Path(data["image_dir"]) / "tokenizer")
    sft_data.write_word_tokenizer(tok_dir, data["texts"] + ["a blue cup under the drawer",
                                                            "white plate"])
    return PreTrainedTokenizerFast.from_pretrained(tok_dir)


def _both(data, stage, json_key, tok, **kw):
    args = dict(json_path=data[json_key], image_dir=data["image_dir"], tokenizer=tok,
                image_size=28, batch_size=2, seq_len=24, pad_token_id=0, seed=5)
    args.update(kw)
    return t_cap.get_caption_dataset(stage, **args), j_cap.get_caption_dataset(stage, **args)


@pytest.mark.parametrize("tok", ["encode_only", "hf"])
@pytest.mark.parametrize("stage,json_key", [("align", "align"), ("align", "odd"),
                                            ("finetune", "finetune"),
                                            ("full-finetune", "finetune")])
def test_batches_equal_the_reference_bit_for_bit(data, stage, json_key, tok, request):
    tokenizer = request.getfixturevalue("hf") if tok == "hf" else EncodeOnlyTokenizer()
    port, ref = _both(data, stage, json_key, tokenizer)
    seen_unimodal = False
    for _ in range(3):
        a, b = port.next_batch(), ref.next_batch()
        assert a.keys() == b.keys() == {"input_ids", "labels", "attention_mask",
                                        "pixel_values", "is_multimodal"}
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["pixel_values"].shape == (2, 28, 28, 6)
        for i in np.where(a["is_multimodal"] == 0)[0]:
            seen_unimodal = True
            assert not a["pixel_values"][i].any()
        for i in np.where(a["is_multimodal"] == 1)[0]:
            assert a["labels"][i, 0] == t_cap.IGNORE_INDEX  # BOS / the patches' slot
    assert port._order == ref._order  # the same place in the same epoch
    assert seen_unimodal == (json_key == "finetune")  # 6 rows cover the 5-row epoch


def test_align_rows_drop_the_prompt_and_end_in_eos(data, hf):
    tok = hf
    port, _ = _both(data, "align", "align", tok, batch_size=1, seq_len=64)
    b = port.next_batch()
    n = int(b["attention_mask"].sum())
    ids = b["input_ids"][0, :n].tolist()
    assert ids[0] == tok.bos_token_id and ids[-1] == tok.eos_token_id
    assert "Describe" not in tok.decode(ids)
    assert b["labels"][0, 0] == t_cap.IGNORE_INDEX and (b["labels"][0, 1:n] == ids[1:]).all()


def test_finetune_rows_supervise_only_gpt_turns(data, hf):
    tok = hf
    port, _ = _both(data, "finetune", "finetune", tok, batch_size=8, seq_len=200)
    ex = [e for e in port.examples if "image" not in e][0]  # the unimodal dialog
    t = port._tokenize(ex)
    sup = [i for i, l in zip(t["input_ids"], t["labels"]) if l != t_cap.IGNORE_INDEX]
    gpt = [turn["value"] for turn in ex["conversations"] if turn["from"] == "gpt"]
    assert tok.decode(sup).split() == " ".join(
        f"<|im_start|> assistant {g} <|im_end|>".replace("<|", "<| ").replace("|>", " |>")
        for g in gpt).split() + ["[EOS]"]
    assert t["labels"][0] == t_cap.IGNORE_INDEX and t["input_ids"][0] == tok.bos_token_id


def test_load_image_equals_the_reference(data):
    for name in ("img0.png", "wide.png", "gray.png"):
        path = str(pathlib.Path(data["image_dir"]) / name)
        got, ref = t_cap.load_image(path, 28), j_cap.load_image(path, 28)
        assert got.dtype == np.float32 and got.shape == (28, 28, 6)
        np.testing.assert_array_equal(got, ref)


def test_modality_lengths_and_registry(data):
    for key in ("align", "finetune", "odd"):
        port, ref = _both(data, "finetune", key, EncodeOnlyTokenizer())
        assert port.get_modality_lengths() == ref.get_modality_lengths()
        assert len(port) == len(ref)
    lengths = _both(data, "finetune", "finetune", EncodeOnlyTokenizer())[0].get_modality_lengths()
    assert [m for m, _ in lengths] == [True] * 4 + [False]
    for mod in (t_cap, j_cap):
        with pytest.raises(ValueError, match="unknown pretraining stage 'pretrain'"):
            mod.get_caption_dataset("pretrain")


def test_bad_rows_and_empty_files_raise(data, tmp_path):
    port, _ = _both(data, "align", "finetune", EncodeOnlyTokenizer())
    dialog = [e for e in port.examples if len(e["conversations"]) == 4][0]
    with pytest.raises(ValueError, match="one human and one gpt turn"):
        port._tokenize(dialog)
    (tmp_path / "empty.json").write_text("[]")
    with pytest.raises(ValueError, match="holds no examples"):
        t_cap.AlignCaptionDataset(str(tmp_path / "empty.json"), ".", EncodeOnlyTokenizer(),
                                  28, 1, 8)
