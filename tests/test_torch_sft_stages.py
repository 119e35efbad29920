"""The rest of the port's supervised fine-tuning against the JAX package, on
the CPU: `OpenVLA.lm_forward`, `PrismaticAlignTrainer` (sft.mode=vla_align)
and `SFTParquetDataset` with the text trainer (sft.mode=text).

Weights are seeded numpy leaves in the shapes of the reference's tiny Flax
tree, carried across by `convert.flax_to_torch`; batches come from both
packages' datasets over the same files (a chat JSON and PNGs written by
tests/sft_data.py's writer, as the card's sft_align phase writes them; two
parquet files).  All f32.  Tolerances (as
tests/test_torch_sft.py states them):
* `lm_forward` logits rtol 1e-5 / atol 1e-5;
* loss at each step within 1e-5 (relative), the global gradient norm
  within 1e-5 (relative); every parameter after the steps within
  tests/test_torch_sft.py's `_assert_state_close` tolerances (TEXT_TOL at
  these learning rates, 1e-3 and more); frozen parameters bit-identical
  on both sides;
* the datasets' batches bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sft_data
from test_torch_sft import (CFG, LOSS_RTOL, NORM_RTOL, TEXT_TOL, _assert_state_close,
                            _jax_step, _random_tree)
from vla_rft_tpu.config import vla_rft_default_config
from vla_rft_tpu.data import caption as j_cap
from vla_rft_tpu.data import synthetic as j_synth
from vla_rft_tpu.models.action_masks import IGNORE_INDEX
from vla_rft_tpu.models.factory import build_models
from vla_rft_tpu.models.transformer import Decoder as JDecoder
from vla_rft_tpu.models.transformer import TransformerConfig as JTransformerConfig
from vla_rft_tpu.ops.attention import force_impl
from vla_rft_tpu.parallel.mesh import MeshConfig, make_mesh
from vla_rft_tpu.trainer import main_sft as j_main
from vla_rft_tpu.trainer import sft_trainer as j_sft
from vla_rft_tpu_torch.convert import flax_to_torch
from vla_rft_tpu_torch.models.factory import build_decoder, build_policy
from vla_rft_tpu_torch.models.transformer import TransformerConfig
from vla_rft_tpu_torch.trainer import main_sft as t_main
from vla_rft_tpu_torch.trainer import sft_trainer as t_sft
from vla_rft_tpu_torch.trainer.optim import global_norm


LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
# the trainer's default clip: every step's global norm here is above it (1.96-2.51)
# and the projector's own gradients' below it (0.57-0.80), so each update is
# clipped, and a port that clipped by the projector's norm alone would not clip
GRAD_CLIP = 1.0
STEPS = 3


class WordTokenizer:
    """A duck-typed tokenizer (encode only) over a fixed word list."""

    eos_token, bos_token_id = "<eos>", 1

    def __init__(self, words):
        self.ids = {w: i + 3 for i, w in enumerate(words)}

    def encode(self, text):
        return [self.ids.get(w, 2) for w in text.split()]


def _vla_shapes(bundle):
    """The reference VLA's parameter shapes: its init traced by eval_shape,
    on init_params' dummy batch (the other models' inits are not traced)."""
    S, img, n = bundle.policy_seq_len, bundle.policy_image_size, bundle.vla_cfg.num_images
    ids = jnp.zeros((1, S), jnp.int32)
    with force_impl("xla"):
        return jax.eval_shape(
            lambda key: bundle.vla.init(key, ids, jnp.zeros((1, img, img, 6 * n), jnp.float32),
                                        ids, jnp.ones((1, S), jnp.int32)),
            jax.random.key(0))


@pytest.fixture(scope="module")
def align_setup(tmp_path_factory):
    """The reference's tiny bundle and random VLA weights, and 3 caption
    batches (align, finetune with its unimodal row, synthetic)."""
    bundle = build_models(vla_rft_default_config(), preset="tiny")
    vp = _random_tree(_vla_shapes(bundle), 7)
    d = str(tmp_path_factory.mktemp("chat"))
    paths = sft_data.write_chat_data(d, size=40, n_images=4, n_align=3, seed=3)
    tok = WordTokenizer(sorted({w for t in paths["texts"] for w in t.split()}))
    kw = dict(image_dir=d, tokenizer=tok, image_size=bundle.policy_image_size, batch_size=2,
              seq_len=bundle.policy_seq_len, pad_token_id=0, seed=1)
    align = j_cap.get_caption_dataset("align", json_path=paths["align"], **kw)
    finetune = j_cap.get_caption_dataset("finetune", json_path=paths["finetune"], **kw)
    finetune.next_batch()
    finetune.next_batch()  # the third batch holds the unimodal row
    synth = j_synth.SyntheticVLADataset(j_synth.SyntheticVLAConfig(
        batch_size=2, seq_len=bundle.policy_seq_len, num_action_tokens=bundle.vla_cfg.num_tokens,
        policy_image_size=bundle.policy_image_size, seed=4))
    keys = ("input_ids", "pixel_values", "attention_mask", "labels")
    batches = [{k: align.next_batch()[k] for k in keys},
               {k: finetune.next_batch()[k] for k in keys},
               t_main.synthetic_caption_batch(synth.next_batch())]
    assert (batches[0]["attention_mask"] == 0).any()  # right-padded rows
    return dict(bundle=bundle, vp=vp, batches=batches)


def _port_vla(s):
    port = build_policy("tiny", device="cpu", trainable=True)
    port.vla.load_state_dict(flax_to_torch(s["vp"], "vla"), strict=True)
    return port.vla


def test_lm_forward_matches_jax(align_setup):
    s = align_setup
    vla, jvla = _port_vla(s), s["bundle"].vla
    V, S = vla.cfg.llm.vocab_size, s["bundle"].policy_seq_len
    lm = jax.jit(lambda p, b: jvla.apply(p, b["input_ids"], b["pixel_values"],
                                         b["attention_mask"], method=jvla.lm_forward))
    with torch.no_grad():
        for b in s["batches"]:
            ref = np.asarray(lm(s["vp"], {k: jnp.asarray(v) for k, v in b.items()}))
            got = vla.lm_forward(*(torch.from_numpy(np.asarray(b[k]))
                                   for k in ("input_ids", "pixel_values", "attention_mask")))
            assert got.dtype == torch.float32 and got.shape == (2, S, V) == ref.shape
            np.testing.assert_allclose(got.numpy(), ref, **LOGIT_TOL)


def test_synthetic_caption_batch_is_the_references(align_setup):
    # vla_rft_tpu/trainer/main_sft.py::_run_vla_align, the synthetic route
    b = align_setup["batches"][2]
    ids, am = b["input_ids"], b["attention_mask"]
    labels = np.where(am > 0, ids, IGNORE_INDEX)
    labels[:, :max(1, ids.shape[1] // 4)] = IGNORE_INDEX
    assert b["labels"].dtype == labels.dtype
    np.testing.assert_array_equal(b["labels"], labels)
    assert (b["labels"] != IGNORE_INDEX).any()


# the reference's jitted step over the whole tiny VLA compiles for 7-8 s on
# the CPU, past the fast tier's 6 s a test
@pytest.mark.slow
def test_prismatic_align_trainer_matches_jax(align_setup):
    s = align_setup
    trainer = j_sft.PrismaticAlignTrainer(s["bundle"].vla, s["vp"], lr=1e-3, grad_clip=GRAD_CLIP)
    step = _jax_step(trainer._loss, trainer.tx)
    vla = _port_vla(s)
    start = {k: v.clone() for k, v in vla.state_dict().items()}
    tr = t_sft.PrismaticAlignTrainer(vla, lr=1e-3, grad_clip=GRAD_CLIP)
    # the trained set is the reference's `projector` label
    marks = jax.tree_util.tree_map_with_path(
        lambda p, x: np.full(x.shape, "projector" in jax.tree_util.keystr(p), np.float32),
        s["vp"])
    ref_trained = {k for k, v in flax_to_torch(marks, "vla").items() if v.all()}
    assert ref_trained == {k for k, v in tr.labels.items() if v == "projector"}
    assert ref_trained and all(k.startswith("projector.") for k in ref_trained)
    params, opt_state = trainer.params, trainer.opt_state
    n_trained = len(ref_trained)
    for b in s["batches"]:
        params, opt_state, j_loss, j_norm = step(
            params, opt_state, {k: jnp.asarray(v) for k, v in b.items()})
        loss = tr.compute_loss(t_sft.to_device(b, "cpu"))
        grads = tr.backward(loss)
        norm = tr.update(grads)
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(norm), float(j_norm), rtol=NORM_RTOL)
        # clipped in every step, by a norm the frozen gradients are part of
        assert float(norm) > GRAD_CLIP > float(global_norm(grads[:n_trained]))
    _assert_state_close(vla, params, "vla", TEXT_TOL)
    j_after = flax_to_torch(jax.tree_util.tree_map(np.asarray, params), "vla")
    for k, v in vla.state_dict().items():
        if k in ref_trained:
            assert not torch.equal(v, start[k]), k
        else:
            assert torch.equal(v, start[k]) and torch.equal(j_after[k], start[k]), k


# ------------------------------------------------------------- text SFT
@pytest.fixture(scope="module")
def parquet_files(tmp_path_factory):
    """Two parquet files: prompt / response strings, plus an int and a float
    column the rows carry through iterrows."""
    import pandas as pd

    d = tmp_path_factory.mktemp("parquet")
    rng = np.random.default_rng(0)
    words = [f"t{i}" for i in range(40)]
    files = []
    for f, n in ((0, 9), (1, 7)):
        rows = {"prompt": [" ".join(rng.choice(words, rng.integers(1, 12))) for _ in range(n)],
                "response": [" ".join(rng.choice(words, rng.integers(1, 12))) for _ in range(n)],
                "uid": np.arange(n) + 100 * f, "score": rng.normal(size=n)}
        files.append(str(d / f"part{f}.parquet"))
        pd.DataFrame(rows).to_parquet(files[-1])
    return files, words


class TextTokenizer(WordTokenizer):
    def __init__(self, words, pad, eos):
        super().__init__(words)
        self.pad_token_id, self.eos_token_id = pad, eos


@pytest.mark.parametrize("pad,eos", [(None, 2), (0, None), (5, 0), (7, 9)])
def test_parquet_batches_equal_the_reference(parquet_files, pad, eos):
    files, words = parquet_files
    tok = TextTokenizer(words, pad, eos)
    kw = dict(max_length=16, batch_size=4, seed=3)
    port = t_main.SFTParquetDataset(files, tok, **kw)
    ref = j_main.SFTParquetDataset(files, tok, **kw)
    assert len(port.df) == 16
    for _ in range(3):
        a, b = port.next_batch(), ref.next_batch()
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the falsy-zero rules: pad `or 0`, eos `or pad`
    assert port.pad == (pad or 0)
    assert ((a["input_ids"] == (pad or 0)) | (a["attention_mask"] == 1)).all()


def test_numpy_draw_takes_df_sample_rows(parquet_files):
    files, words = parquet_files
    port = t_main.SFTParquetDataset(files, TextTokenizer(words, 0, 1), batch_size=5, seed=11)
    rng = np.random.default_rng(11)
    for _ in range(20):
        want = port.df.sample(5, random_state=int(rng.integers(1 << 31)))
        got = port.df.iloc[port.draw()]
        np.testing.assert_array_equal(got["uid"].to_numpy(), want["uid"].to_numpy())
    with pytest.raises(ValueError):  # more rows than the files hold, as df.sample
        t_main.SFTParquetDataset(files[1], TextTokenizer(words, 0, 1), batch_size=8).draw()


QWEN_TINY = dict(CFG, num_kv_heads=2, qkv_bias=True, tie_word_embeddings=True)


class RandomInitDecoder(JDecoder):
    """The reference's Decoder with `_random_tree` leaves for its init: its
    eager init compiles op by op for about 5 s on the CPU."""

    def init(self, rngs, *args, **kwargs):
        return _random_tree(jax.eval_shape(super().init, rngs, *args, **kwargs), 5)


def test_text_slice_matches_jax(parquet_files, monkeypatch):
    """sft.mode=text as a whole: each package's parquet batches (max_length
    24, right-padded) through its own SFTTrainer from the same weights, 3
    steps of a GQA / tied / qkv-bias decoder, as Qwen2.5's."""
    files, words = parquet_files
    tok = TextTokenizer(words[:40], 0, 3)
    jcfg = JTransformerConfig(dtype=jnp.float32, param_dtype=jnp.float32, attn_impl="xla",
                              **QWEN_TINY)
    mesh = make_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    with monkeypatch.context() as m:
        m.setattr(j_sft, "Decoder", RandomInitDecoder)
        jt = j_sft.SFTTrainer(jcfg, lr=2e-3, mesh=mesh, total_steps=STEPS)
    tcfg = TransformerConfig(dtype=torch.float32, param_dtype=torch.float32, **QWEN_TINY)
    llm = build_decoder(tcfg, device="cpu")
    llm.load_state_dict(flax_to_torch(jax.tree_util.tree_map(np.asarray, jt.params), "decoder"),
                        strict=True)
    tt = t_sft.SFTTrainer(tcfg, lr=2e-3, llm=llm)
    kw = dict(max_length=24, batch_size=4)
    port, ref = t_main.SFTParquetDataset(files, tok, **kw), j_main.SFTParquetDataset(files, tok, **kw)
    step = _jax_step(jt._loss, jt.tx)
    # on the default device, as the step's outputs are: one compile for the 3 steps
    params, opt_state = jax.device_put((jt.params, jt.opt_state), jax.devices()[0])
    for _ in range(STEPS):
        b = ref.next_batch()
        params, opt_state, j_loss, _ = step(params, opt_state,
                                            {k: jnp.asarray(v) for k, v in b.items()})
        loss = tt.training_step(port.next_batch())
        np.testing.assert_allclose(loss, float(j_loss), rtol=LOSS_RTOL)
    _assert_state_close(llm, params, "decoder", TEXT_TOL)
