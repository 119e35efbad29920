"""The port's text generation slice on the CPU, held against the JAX package.

A tiny f32 Qwen-shaped decoder (2 layers, GQA 4/2 heads of 64, qkv bias,
tied embeddings, rope theta 1e6) is built by the reference from a fixed key
and converted by `flax_to_torch`; prompts come from numpy seeds.

* the decoder's explicit `positions` and uncached `kv_starts`: left-padded
  logits at the valid positions within atol 2e-5 / rtol 1e-4 (f32
  round-off of the same arithmetic);
* `generate_sequences`, greedy: every output bit-equal to the reference on
  left-padded rows with an EOS inside the response; padding invariance;
  prefix sharing (greedy bit-equal to the reference's shared route,
  sampled equal to the port's own plain route under one generator); FIRE's
  first-step temperature;
* `compute_log_probs`: log-probs and entropy within atol 2e-5 / rtol 1e-4;
* `RLHFDataset` batches bit-equal (chat and string prompts, overlong rows
  filtered), `set_pad_token_id`, `chat_template_ids`;
* `Batch`'s surface against the reference's, on numpy arrays and (for the
  port) torch tensors;
* `main_generation.run` against the reference's `run` at temperature 0 on a
  tokenizer and checkpoint written here: equal parquets.
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke as cs
import sft_data
from vla_rft_tpu import protocol as j_protocol
from vla_rft_tpu.data import rlhf_dataset as j_rlhf
from vla_rft_tpu.models import transformer as j_tf
from vla_rft_tpu.utils import tokenizer as j_tok
from vla_rft_tpu.workers import llm_rollout as j_roll
from vla_rft_tpu_torch import protocol as t_protocol
from vla_rft_tpu_torch.convert import flax_to_torch
from vla_rft_tpu_torch.data import rlhf_dataset as t_rlhf
from vla_rft_tpu_torch.models import transformer as t_tf
from vla_rft_tpu_torch.utils import tokenizer as t_tok
from vla_rft_tpu_torch.workers import llm_rollout as t_roll

VOCAB = 96
CFG = dict(vocab_size=VOCAB, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=4,
           num_kv_heads=2, head_dim=64, rope_theta=1_000_000.0, qkv_bias=True,
           tie_word_embeddings=True)
LOGIT_TOL = dict(atol=2e-5, rtol=1e-4)  # f32 round-off of the same arithmetic
PAD, R = 0, 10


@pytest.fixture(scope="module")
def models():
    jcfg = j_tf.TransformerConfig(dtype=jnp.float32, param_dtype=jnp.float32, attn_impl="xla",
                                  **CFG)
    jllm = j_tf.Decoder(jcfg)
    params = jllm.init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32))
    tllm = t_tf.Decoder(t_tf.TransformerConfig(dtype=torch.float32, param_dtype=torch.float32,
                                               **CFG))
    tllm.load_state_dict(flax_to_torch(jax.tree_util.tree_map(np.asarray, params), "decoder"),
                         strict=True)
    return jllm, params, tllm.eval()


def _prompts(seed, B=4, P=12, pads=(0, 3, 7, 11)):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, VOCAB, (B, P)).astype(np.int32)
    for b, n in enumerate(pads[:B]):
        ids[b, :n] = PAD
    return ids


def _greedy(eos=2, **kw):
    return dict(response_length=R, eos_token_id=eos, pad_token_id=PAD, do_sample=False, **kw)


def _j_gen(models, ids, cfg, n=1, seed=1):
    jllm, params, _ = models
    out = jax.jit(lambda p, r, x: j_roll.generate_sequences(jllm, p, r, x, cfg, n))(
        params, jax.random.key(seed), jnp.asarray(ids))
    return {k: np.asarray(v) for k, v in out.items()}


def _t_gen(models, ids, cfg, n=1, seed=1):
    gen = torch.Generator().manual_seed(seed)
    out = t_roll.generate_sequences(models[2], gen, torch.from_numpy(ids), cfg, n)
    return {k: v.numpy() for k, v in out.items()}


# ------------------------------------------------------------ decoder repair
def test_left_padded_uncached_forward_matches_jax(models):
    """positions and kv_starts on the uncached path: a left-padded batch's
    logits at the valid positions equal the reference's; the pad queries
    (no valid key) are finite."""
    jllm, params, tllm = models
    ids = _prompts(0, P=16, pads=(0, 5, 9, 15))
    pads = (ids == PAD).sum(1).astype(np.int32)
    pos = np.clip(np.arange(16)[None] - pads[:, None], 0, None).astype(np.int32)
    ref = np.asarray(jllm.apply(params, jnp.asarray(ids), positions=jnp.asarray(pos),
                                kv_starts=jnp.asarray(pads))[0])
    with torch.no_grad():
        got = tllm(torch.from_numpy(ids), positions=torch.from_numpy(pos),
                   kv_starts=torch.from_numpy(pads))[0].numpy()
    assert np.isfinite(got).all()
    valid = np.arange(16)[None] >= pads[:, None]
    np.testing.assert_allclose(got[valid], ref[valid], **LOGIT_TOL)


# -------------------------------------------------------- generate_sequences
@pytest.fixture(scope="module")
def greedy_ref(models):
    """The reference's greedy outputs on left-padded rows, with the EOS id
    chosen as the token row 1 emits at step 3, so that rows end inside R."""
    ids = _prompts(1)
    first = _j_gen(models, ids, j_roll.LLMRolloutConfig(**_greedy()))
    eos = int(first["responses"][1, 3])
    return ids, eos, _j_gen(models, ids, j_roll.LLMRolloutConfig(**_greedy(eos)))


def test_greedy_generation_is_bit_equal_to_jax_with_eos_inside(models, greedy_ref):
    ids, eos, ref = greedy_ref
    got = _t_gen(models, ids, t_roll.LLMRolloutConfig(**_greedy(eos)))
    assert ref["response_mask"][1].sum() <= 4 and ref["response_mask"].sum() < ids.shape[0] * R
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == np.int32, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_padding_invariance(models):
    """A left-padded row generates what its unpadded prompt generates (the
    reference's tests/test_ppo_text.py check), and the unpadded row follows
    a manual argmax rollout of full forwards."""
    _, _, tllm = models
    cfg = t_roll.LLMRolloutConfig(**_greedy())
    prompts = np.asarray([[0, 0, 5, 6, 7, 8], [3, 4, 5, 6, 7, 8]], np.int32)
    out = _t_gen(models, prompts, cfg)
    seq = [3, 4, 5, 6, 7, 8]
    with torch.no_grad():
        for _ in range(R):
            logits = tllm(torch.tensor([seq]))[0]
            seq.append(int(logits[0, -1].argmax()))
    mask = out["response_mask"][1].astype(bool)
    np.testing.assert_array_equal(out["responses"][1][mask], np.asarray(seq[6:])[:mask.sum()])
    alone = _t_gen(models, np.asarray([[5, 6, 7, 8]], np.int32), cfg)
    np.testing.assert_array_equal(out["responses"][0], alone["responses"][0])


def test_prefix_sharing_greedy_matches_jax_and_sampled_matches_the_plain_route(models):
    uniq = _prompts(2, B=2, pads=(4, 0))
    ids = np.repeat(uniq, 3, axis=0)
    ref = _j_gen(models, ids, j_roll.LLMRolloutConfig(**_greedy()), n=3)
    got = _t_gen(models, ids, t_roll.LLMRolloutConfig(**_greedy()), n=3)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    sampled = t_roll.LLMRolloutConfig(response_length=R, eos_token_id=2, pad_token_id=PAD,
                                      temperature=1.0, top_p=0.9)
    shared, plain = _t_gen(models, ids, sampled, n=3, seed=7), _t_gen(models, ids, sampled, seed=7)
    for k in plain:
        np.testing.assert_array_equal(shared[k], plain[k], err_msg=k)
    assert len({tuple(r) for r in shared["responses"]}) > 2  # the draws differ across rows


def test_fire_sampling_takes_its_temperature_on_the_first_step_only(models):
    """With a cold first step (fire_temperature 1e-3) and a hot rest
    (temperature 50), the first token is the greedy one on both packages
    and later tokens are not; without FIRE the hot first token is not."""
    ids = np.repeat(_prompts(3), 4, axis=0)
    greedy = _t_gen(models, ids, t_roll.LLMRolloutConfig(**_greedy(eos=-1)))["responses"]
    kw = dict(response_length=R, eos_token_id=-1, pad_token_id=PAD, temperature=50.0)
    fire = _t_gen(models, ids, t_roll.LLMRolloutConfig(use_fire_sampling=True,
                                                       fire_temperature=1e-3, **kw))["responses"]
    j_fire = _j_gen(models, ids, j_roll.LLMRolloutConfig(use_fire_sampling=True,
                                                         fire_temperature=1e-3, **kw))
    hot = _t_gen(models, ids, t_roll.LLMRolloutConfig(**kw))["responses"]
    np.testing.assert_array_equal(fire[:, 0], greedy[:, 0])
    np.testing.assert_array_equal(j_fire["responses"][:, 0], greedy[:, 0])
    assert (fire[:, 1:] != greedy[:, 1:]).any() and (hot[:, 0] != greedy[:, 0]).any()


def test_compute_log_probs_matches_jax(models, greedy_ref):
    """Teacher-forced log-probs and entropy of left-padded sequences whose
    rows end at an EOS inside R (keys past it masked by kv_lens)."""
    jllm, params, tllm = models
    out = greedy_ref[2]
    args = [out[k] for k in ("input_ids", "attention_mask", "position_ids")]
    j_lp, j_ent = jax.jit(lambda p, *a: j_roll.compute_log_probs(jllm, p, *a, R,
                                                                 temperature=0.7))(
        params, *map(jnp.asarray, args))
    lp, ent = t_roll.compute_log_probs(tllm, *map(torch.from_numpy, args), R, temperature=0.7)
    np.testing.assert_allclose(lp.numpy(), np.asarray(j_lp), **LOGIT_TOL)
    np.testing.assert_allclose(ent.numpy(), np.asarray(j_ent), **LOGIT_TOL)


# ------------------------------------------------------------ data and tokenizer
@pytest.fixture(scope="module")
def chat_tokenizer(tmp_path_factory):
    from transformers import PreTrainedTokenizerFast

    path = str(tmp_path_factory.mktemp("tok"))
    sft_data.write_chat_tokenizer(path, VOCAB)
    return path, PreTrainedTokenizerFast.from_pretrained(path)


class _EncodeOnly:
    def encode(self, text):
        return [4 + int(w[1:]) % (VOCAB - 8) for w in text.split()]


@pytest.mark.parametrize("chat,hf", [(True, True), (False, True), (True, False)],
                         ids=["chat_hf", "string_hf", "chat_encode_only"])
def test_rlhf_dataset_batches_are_bit_equal(chat, hf, chat_tokenizer, tmp_path):
    path = str(tmp_path / "prompts.parquet")
    gts = sft_data.write_rlhf_parquet(path, [3, 9, 40, 17, 5, 60], 80, seed=0, chat=chat)
    tok = chat_tokenizer[1] if hf else _EncodeOnly()
    kw = dict(max_prompt_length=32, pad_token_id=0, seed=3)
    ref, port = j_rlhf.RLHFDataset(path, tok, **kw), t_rlhf.RLHFDataset(path, tok, **kw)
    assert len(port) == len(ref) == 4  # the rows of 40 and 60 words (and more tokens) filtered
    assert [ids for ids, _ in port._rows] == [ids for ids, _ in ref._rows]
    for bs in (3, 5):
        a, b = ref.sample_batch(bs), port.sample_batch(bs)
        assert a.keys() == b.keys()
        assert b["input_ids"].dtype == np.int32
        np.testing.assert_array_equal(b["input_ids"], a["input_ids"])
        assert b["data_sources"] == a["data_sources"] and b["ground_truths"] == a["ground_truths"]
        assert set(b["ground_truths"]) <= set(gts)


def test_chat_template_ids_take_ids_from_a_mapping(chat_tokenizer):
    tok = chat_tokenizer[1]
    msgs = [{"role": "user", "content": "w1 w2 w3"}]
    ids = t_rlhf.chat_template_ids(tok, msgs)
    assert ids == tok.encode("user : w1 w2 w3 assistant :", add_special_tokens=False)

    class Mapping:  # a tokenizer whose template returns a BatchEncoding-like mapping
        def apply_chat_template(self, messages, add_generation_prompt):
            return {"input_ids": [ids], "attention_mask": [[1] * len(ids)]}

    assert t_rlhf.chat_template_ids(Mapping(), msgs) == ids


@pytest.mark.parametrize("pad", [None, 0])
def test_set_pad_token_id_matches_the_reference(pad):
    class Tok:
        def __init__(self):
            self.pad_token_id, self.pad_token = pad, None if pad is None else "[PAD]"
            self.eos_token_id, self.eos_token = 3, "[EOS]"

    a, b = Tok(), Tok()
    with warnings.catch_warnings(record=True) as wa:
        warnings.simplefilter("always")
        j_tok.set_pad_token_id(a)
    with warnings.catch_warnings(record=True) as wb:
        warnings.simplefilter("always")
        t_tok.set_pad_token_id(b)
    assert vars(a) == vars(b)
    assert [str(w.message) for w in wa] == [str(w.message) for w in wb]


def test_hf_tokenizer_gemma2_branch_and_processor(monkeypatch):
    import transformers

    seen = []

    class Auto:
        @staticmethod
        def from_pretrained(path, **kw):
            seen.append((path, kw))

            class T:
                pad_token_id, pad_token, eos_token_id, eos_token = None, None, 107, "<e>"
            return T()

    class Fails:
        @staticmethod
        def from_pretrained(path, **kw):
            raise OSError("no processor")

    monkeypatch.setitem(transformers.__dict__, "AutoTokenizer", Auto)
    monkeypatch.setitem(transformers.__dict__, "AutoProcessor", Fails)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tok = t_tok.hf_tokenizer("google/gemma-2-2b-it")
        j_tok.hf_tokenizer("google/gemma-2-2b-it")
        t_tok.hf_tokenizer("qwen", correct_pad_token=False)
    assert seen[0] == seen[1] == ("google/gemma-2-2b-it",
                                  {"eos_token": "<end_of_turn>", "eos_token_id": 107})
    assert seen[2] == ("qwen", {})
    assert tok.pad_token_id == 107 and tok.pad_token == "<e>"
    assert t_tok.hf_processor("x") is None and j_tok.hf_processor("x") is None


# ------------------------------------------------------------------ Batch
def _batch(mod, kind, n=8):
    a = np.arange(n * 3).reshape(n, 3)
    b = np.ones((n, 2, 2)) * np.arange(n)[:, None, None]
    if kind == "torch":
        a, b = torch.from_numpy(a), torch.from_numpy(b)
    return mod.Batch.from_dict(tensors={"a": a, "b": b},
                               non_tensors={"uid": [f"u{i}" for i in range(n)]}, meta={"m": 1})


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(port, ref):
    """The port's Batch holds the reference's fields, values and meta."""
    assert set(port.data) == set(ref.data) and set(port.non_tensor) == set(ref.non_tensor)
    for k in ref.data:
        np.testing.assert_array_equal(_np(port.data[k]), _np(ref.data[k]), err_msg=k)
    for k in ref.non_tensor:
        assert list(port.non_tensor[k]) == list(ref.non_tensor[k]), k
    assert port.meta == ref.meta and len(port) == len(ref)


BATCH_OPS = {
    "getitem_int": lambda m, b: [b[1]],
    "getitem_slice": lambda m, b: [b[2:5]],
    "select": lambda m, b: [b.select(batch_keys=["a"]), b.select(non_tensor_keys=[],
                                                                  meta_keys=["m"])],
    "pop": lambda m, b: [b.pop(batch_keys=["a"], non_tensor_keys=["uid"]), b],
    "union": lambda m, b: [b.union(m.Batch.from_dict(tensors={"c": _np(b["a"])[:, :1] * 0},
                                                      meta={"k": 2}))],
    "chunk": lambda m, b: b.chunk(4),
    "split": lambda m, b: b.split(3),
    "concat": lambda m, b: [m.Batch.concat(b.chunk(2)[::-1])],
    "repeat_interleave": lambda m, b: [b.repeat(3, interleave=True)],
    "repeat_tile": lambda m, b: [b.repeat(2, interleave=False)],
    "reorder": lambda m, b: [b.reorder([7, 0, 3, 3, 1])],
    "rename": lambda m, b: [b.rename("a", "z").rename("uid", "id")],
    "iterator": lambda m, b: list(b.make_iterator(mini_batch_size=3, epochs=2, seed=0,
                                                  shuffle=True)),
    "iterator_ordered": lambda m, b: list(b.make_iterator(mini_batch_size=4)),
    "to_numpy": lambda m, b: [b.to_numpy()],
    "map": lambda m, b: [b.map(lambda v: v * 2)],
    "pad_to_divisor": lambda m, b: [m.pad_to_divisor(b[:5], 4)[0],
                                    m.unpad(*m.pad_to_divisor(b[:5], 4))],
    "pad_noop": lambda m, b: [m.pad_to_divisor(b, 4)[0], m.unpad(b, 0)],
    "setitem": lambda m, b: [_set(b)],
    "from_single_dict": lambda m, b: [m.Batch.from_single_dict(
        {"x": _np(b["a"]), "s": ["p"] * 8, "o": np.array([None] * 8, dtype=object)})],
}


def _set(b):
    b["s"] = ["x"] * len(b)
    b["t"] = np.zeros((len(b), 1))
    return b


@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("op", sorted(BATCH_OPS))
def test_batch_surface_matches_the_reference(op, kind):
    ref = BATCH_OPS[op](j_protocol, _batch(j_protocol, "numpy"))
    got = BATCH_OPS[op](t_protocol, _batch(t_protocol, kind))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        _same(g, r)
        if kind == "torch" and op not in ("to_numpy", "from_single_dict", "setitem"):
            assert all(isinstance(v, torch.Tensor) for k, v in g.data.items() if k != "c")


@pytest.mark.parametrize("mod", [j_protocol, t_protocol], ids=["reference", "port"])
def test_batch_refusals(mod):
    b = _batch(mod, "numpy")
    with pytest.raises(ValueError):
        b.chunk(3)
    with pytest.raises(ValueError):
        b.union(_batch(mod, "numpy", 6))
    with pytest.raises(ValueError):
        mod.Batch(data={"a": np.zeros(3)}, non_tensor={"u": np.zeros(4, dtype=object)})
    assert len(mod.Batch.concat([])) == 0 and len(mod.Batch()) == 0


# ------------------------------------------------------------ main_generation
@pytest.fixture
def auto_tokenizer(monkeypatch):
    """transformers.AutoTokenizer as the PreTrainedTokenizerFast it gives for
    a directory written by sft_data (the auto classes take seconds to
    import on the CPU)."""
    import transformers
    from transformers import PreTrainedTokenizerFast

    class AutoTokenizer:
        @staticmethod
        def from_pretrained(path, *args, **kwargs):
            return PreTrainedTokenizerFast.from_pretrained(path, *args, **kwargs)

    monkeypatch.setitem(transformers.__dict__, "AutoTokenizer", AutoTokenizer)


def test_main_generation_writes_the_reference_parquet(models, tmp_path, monkeypatch,
                                                      auto_tokenizer, capsys):
    """Both packages' `run` at temperature 0 on one checkpoint directory
    (the tiny decoder's weights under HF names as f32 .safetensors, and a
    chat tokenizer of its vocabulary), the Qwen2.5-0.5B config cut to the
    tiny one: equal parquets."""
    import pandas as pd

    from vla_rft_tpu.trainer import main_generation as j_main
    from vla_rft_tpu_torch.trainer import main_generation as t_main

    ckpt = tmp_path / "ckpt"
    sft_data.write_chat_tokenizer(str(ckpt), VOCAB)
    cs.write_safetensors(str(ckpt / "model.safetensors"),
                         cs.hf_decoder_names(models[2].state_dict()))
    prompts = str(tmp_path / "prompts.parquet")
    sft_data.write_rlhf_parquet(prompts, [5, 11, 2, 30, 7], VOCAB - 8, seed=1)
    jcfg = j_tf.TransformerConfig(dtype=jnp.float32, param_dtype=jnp.float32, attn_impl="xla",
                                  **CFG)
    tcfg = models[2].cfg
    monkeypatch.setattr(j_tf.TransformerConfig, "qwen25_0_5b", staticmethod(lambda: jcfg))
    monkeypatch.setattr(t_tf.TransformerConfig, "qwen25_0_5b", staticmethod(lambda: tcfg))
    argv = [f"actor_rollout_ref.model.ckpt_path={ckpt}", f"data.train_files={prompts}",
            "data.max_prompt_length=24", "actor_rollout_ref.rollout.response_length=6",
            "actor_rollout_ref.rollout.n=2", "data.train_batch_size=3",
            "actor_rollout_ref.rollout.temperature=0"]
    j_main.run(argv + [f"data.output_path={tmp_path / 'ref.parquet'}"])
    seen = []
    load, generate = t_main.load_decoder, t_main.generate_sequences

    def load_decoder(*args):
        llm = load(*args)
        seen.append(llm.cfg)
        return llm

    def generate_sequences(*args, **kwargs):
        out = generate(*args, **kwargs)
        seen.append(tuple(out["responses"].shape))
        return out

    monkeypatch.setattr(t_main, "load_decoder", load_decoder)
    monkeypatch.setattr(t_main, "generate_sequences", generate_sequences)
    t_main.run(argv + ["--device=cpu", f"data.output_path={tmp_path / 'port.parquet'}"])
    assert "wrote 8 generations" in capsys.readouterr().out
    assert seen == [tcfg, (6, 6), (2, 6)]  # 4 prompts left of 5: batches of 3 and 1, n = 2
    ref, got = pd.read_parquet(tmp_path / "ref.parquet"), pd.read_parquet(tmp_path / "port.parquet")
    pd.testing.assert_frame_equal(got, ref)
    assert len(got) == 8 and got["response"].nunique() > 1


def test_main_generation_refuses_to_run_without_cuda(monkeypatch):
    from vla_rft_tpu_torch.trainer import main_generation as t_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_main.run(["actor_rollout_ref.model.ckpt_path=/nonexistent"])
