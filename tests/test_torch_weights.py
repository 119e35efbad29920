"""Loading trained weights into the port, against the JAX package, on the CPU.

* The port's safetensors reader (`utils/weight_files.py`) against
  `safetensors` itself: every dtype the reader takes (BF16 bit for bit), a
  sharded directory, `__metadata__`, and a truncated file or a header that
  points past the end raising; chip_smoke.py's writer read back by
  `safetensors`.  The torch-file helpers against tools/convert_weights.py's.
* Each converter of `vla_rft_tpu_torch/convert_weights.py` against
  tools/convert_weights.py's on the same state dict: after
  `convert.flax_to_torch` the two are equal exactly (HF LLaMA and Qwen2
  decoders built by `transformers`, the timm towers and OpenVLA, the action
  expert's component files, the tokenizer, LPIPS in both name styles).
  The state dicts in the reference's names come from chip_smoke.py's own
  inverse of each layout, which the round trips below hold against the
  port's modules (and the expert's against the JAX tree and the projector
  files of tools/export_weights.py::export_action_expert).
* `_maybe_load_pretrained` on the tiny preset, all four checkpoint paths:
  the CLI loads, then steps, and every parameter equals `flax_to_torch` of
  the JAX trainer's params after the reference's `_maybe_load_pretrained`
  on the same files, exactly; the edges (no sigma_net file, no LPIPS
  heads, directories without weights) as the reference.
"""
import json
import os
import types

import numpy as np
import pytest
import torch

import jax

import chip_smoke as cs
from tools import convert_weights as tools_cw
from vla_rft_tpu.config import vla_rft_default_config as j_default_config
from vla_rft_tpu.models.factory import build_models as j_build_models
from vla_rft_tpu.models.factory import init_params
from vla_rft_tpu.trainer import main_vla_rft_grpo as j_main
from vla_rft_tpu_torch import convert_weights as cw
from vla_rft_tpu_torch.config import vla_rft_default_config
from vla_rft_tpu_torch.convert import flax_to_torch
from vla_rft_tpu_torch.models.factory import build_models
from vla_rft_tpu_torch.models.transformer import Decoder, TransformerConfig
from vla_rft_tpu_torch.trainer import main_vla_rft_grpo as t_main
from vla_rft_tpu_torch.trainer.grpo_trainer import VLARFTGRPOTrainer
from vla_rft_tpu_torch.utils import weight_files as wf

st_numpy = pytest.importorskip("safetensors.numpy")
st_torch = pytest.importorskip("safetensors.torch")

FAMILIES = ("vla", "expert", "wm", "tokenizer", "lpips")
TINY = ["data.train_batch_size=2", "data.video.segment_length=3",
        "actor_rollout_ref.rollout.n=2", "actor_rollout_ref.rollout.num_flow_steps=3",
        "actor_rollout_ref.actor.ppo_mini_batch_size=4",
        "actor_rollout_ref.actor.ppo_micro_batch_size_per_gpu=2",
        "actor_rollout_ref.rollout.log_prob_micro_batch_size_per_gpu=4",
        "processor.tokens_per_frame=4", "data.max_prompt_length=75",
        "data.max_response_length=22", "world_model_rollout.rollout.interact_max_tokens=4",
        "trainer.total_training_steps=1", "trainer.logger=[]"]


def _equal_sd(a, b, what=""):
    assert set(a) == set(b), (what, sorted(set(a) ^ set(b))[:8])
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), f"{what}: {k}"


# ------------------------------------------------------------------ reader
def _tensors(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        make = lambda *s: torch.rand(s, generator=g) > 0.5
    elif dtype.is_floating_point:
        make = lambda *s: (torch.randn(s, generator=g) * 3).to(dtype)
    else:
        info = torch.iinfo(dtype)
        make = lambda *s: torch.randint(max(info.min, -1000), min(info.max, 1000), s,
                                        generator=g).to(dtype)
    return {"a": make(3, 5), "b.c": make(7), "scalar": make(), "empty": make(0, 4),
            "d": make(2, 3, 4)}


@pytest.mark.parametrize("dtype", list(wf.DTYPES.values()), ids=list(wf.DTYPES))
def test_reader_matches_safetensors(tmp_path, dtype):
    path = str(tmp_path / "w.safetensors")
    st_torch.save_file(_tensors(dtype), path, metadata={"format": "pt"})
    got = wf.load_file(path)
    _equal_sd(got, st_torch.load_file(path), str(dtype))
    if dtype == torch.bfloat16:  # numpy has no bf16: compare the bits
        ref = st_torch.load_file(path)
        for k in got:
            assert torch.equal(got[k].view(torch.int16), ref[k].view(torch.int16)), k
    else:
        ref = st_numpy.load_file(path)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
            assert got[k].numpy().dtype == ref[k].dtype


def test_reader_merges_a_sharded_directory(tmp_path):
    st_torch.save_file(_tensors(torch.float32, 0), str(tmp_path / "model-00001.safetensors"))
    st_torch.save_file({"x" + k: v for k, v in _tensors(torch.bfloat16, 1).items()},
                       str(tmp_path / "model-00002.safetensors"))
    torch.save({"ignored": torch.ones(1)}, tmp_path / "other.pt")
    got = wf.load_dir(str(tmp_path))
    want = {**st_torch.load_file(str(tmp_path / "model-00001.safetensors")),
            **st_torch.load_file(str(tmp_path / "model-00002.safetensors"))}
    _equal_sd(got, want)
    (tmp_path / "empty").mkdir()
    assert wf.load_dir(str(tmp_path / "empty")) == {}
    assert wf.load_dir(str(tmp_path / "missing")) == {}


@pytest.mark.parametrize("damage", ["cut_data", "cut_header", "offsets_past_end", "short"])
def test_reader_refuses_a_damaged_file(tmp_path, damage):
    path = tmp_path / "w.safetensors"
    st_torch.save_file(_tensors(torch.float32), str(path))
    raw = path.read_bytes()
    n = int.from_bytes(raw[:8], "little")
    if damage == "cut_data":
        raw = raw[:-5]
    elif damage == "cut_header":
        raw = raw[: 8 + n // 2]
    elif damage == "short":
        raw = raw[:5]
    else:
        header = json.loads(raw[8: 8 + n])
        header["a"]["data_offsets"] = [10 ** 6, 10 ** 6 + 60]
        hb = json.dumps(header).encode()
        raw = len(hb).to_bytes(8, "little") + hb + raw[8 + n:]
    path.write_bytes(raw)
    with pytest.raises(ValueError):
        wf.load_file(str(path))


def test_script_writer_is_read_by_safetensors(tmp_path):
    """chip_smoke.py's writer (the card's machine has no safetensors)."""
    sd = {f"{k}.{name}": v for k in wf.DTYPES for name, v in
          _tensors(wf.DTYPES[k], len(k)).items()}
    path = str(tmp_path / "w.safetensors")
    assert cs.write_safetensors(path, sd) == os.path.getsize(path)
    _equal_sd(st_torch.load_file(path), sd)
    _equal_sd(wf.load_file(path), sd)


def test_torch_file_helpers_match_the_reference(tmp_path):
    torch.save({"state_dict": {"module.a": torch.ones(2), "b": torch.zeros(3)}},
               tmp_path / "action_head--1.pt")
    torch.save({"c": torch.arange(4)}, tmp_path / "x.pth")
    f = wf.find_checkpoint_file(str(tmp_path), "action_head")
    assert f == tools_cw.find_checkpoint_file(str(tmp_path), "action_head")
    _equal_sd(wf.load_torch_state_dict(f), tools_cw.load_torch_state_dict(f))
    assert set(wf.load_torch_state_dict(f)) == {"a", "b"}
    for missing in ("sigma_net", ".pt"):  # none, and more than one, raise
        torch.save({}, tmp_path / "two--1.pt")
        with pytest.raises(FileNotFoundError):
            wf.find_checkpoint_file(str(tmp_path), missing)
    _equal_sd(wf.load_state_dicts(str(tmp_path)), j_main._load_state_dicts(str(tmp_path)))
    with pytest.raises(FileNotFoundError):
        wf.load_state_dicts(str(tmp_path / "missing"))
    (tmp_path / "cfg").mkdir()
    (tmp_path / "cfg" / "config.json").write_text('{"layers_per_block": 1}')
    for p in (tmp_path / "cfg", tmp_path / "x.pth", tmp_path):
        assert wf.read_model_config(str(p)) == j_main._read_model_config(str(p))


# -------------------------------------------------------------- converters
@pytest.fixture(scope="module")
def j_side():
    """The reference's tiny bundle and one random tree per family: the JAX
    trainer's fields that its `_maybe_load_pretrained` reads and writes."""
    bundle = j_build_models(j_default_config().apply_overrides(TINY), preset="tiny")
    shapes = jax.eval_shape(lambda k: init_params(bundle, k), jax.random.key(0))
    rng = np.random.default_rng(11)
    tree = {m: jax.tree_util.tree_map(
        lambda s: rng.normal(scale=0.05, size=s.shape).astype(np.float32), shapes[m])
        for m in FAMILIES}
    return bundle, tree


def _both(fn_name, *args, **kw):
    """flax_to_torch-free trees of the port's and the tools' converter."""
    return getattr(cw, fn_name)(*args, **kw), getattr(tools_cw, fn_name)(*args, **kw)


def _trees_equal(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), (path, set(a) ^ set(b))
        for k in b:
            _trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)
        assert np.asarray(a).dtype == np.asarray(b).dtype, path


@pytest.fixture(scope="module")
def transformers():
    """transformers with its LLaMA and Qwen2 modules imported (seconds)."""
    t = pytest.importorskip("transformers")
    t.LlamaForCausalLM, t.Qwen2ForCausalLM  # noqa: B018 (lazy imports)
    return t


@pytest.mark.parametrize("arch", ["llama", "qwen2"])
def test_decoder_converter_matches_tools(transformers, arch):
    kw = dict(vocab_size=97, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=4, rms_norm_eps=1e-6, attn_implementation="eager")
    torch.manual_seed(0)
    if arch == "llama":
        hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
            num_key_value_heads=4, tie_word_embeddings=False, rope_theta=10000.0, **kw))
        cfg = TransformerConfig(vocab_size=97, hidden_size=32, intermediate_size=64,
                                num_layers=2, num_heads=4, num_kv_heads=4,
                                dtype=torch.float32, param_dtype=torch.float32)
    else:
        hf = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
            num_key_value_heads=2, tie_word_embeddings=True, rope_theta=1e6, **kw))
        cfg = TransformerConfig(vocab_size=97, hidden_size=32, intermediate_size=64,
                                num_layers=2, num_heads=4, num_kv_heads=2, qkv_bias=True,
                                tie_word_embeddings=True, rope_theta=1e6,
                                dtype=torch.float32, param_dtype=torch.float32)
    sd = hf.eval().state_dict()
    mine, ref = _both("convert_hf_decoder", sd, cfg)
    _trees_equal(mine, ref)
    dec = Decoder(cfg).eval()
    dec.load_state_dict(flax_to_torch(mine, "decoder"), strict=True)
    ids = torch.as_tensor(np.random.default_rng(0).integers(0, 97, (2, 9)))
    with torch.no_grad():
        np.testing.assert_allclose(dec(ids)[0].numpy(), hf(ids).logits.numpy(),
                                   atol=2e-4, rtol=1e-3)


@pytest.fixture(scope="module")
def tiny_second():
    """The port's tiny modules with seeded random weights (seed 7), every
    parameter perturbed as chip_smoke.py does (norms, biases and layer
    scales too, which the seeded init sets to 1 or 0 everywhere), as CPU
    state dicts: what the checkpoint files hold."""
    b = build_models(vla_rft_default_config().apply_overrides(TINY), "tiny", device="cpu",
                     seed=7)
    for i, m in enumerate(FAMILIES):
        cs.perturb_(getattr(b, m), 700 + i)
    return b, {m: {k: v.detach().clone() for k, v in getattr(b, m).state_dict().items()}
               for m in FAMILIES}


def test_second_seed_parameters_are_all_distinct(tiny_second):
    """No two parameters of one shape in the written modules are equal, so a
    loader that swaps two of them, or reads another layer's, shows up."""
    _, second = tiny_second
    for m in FAMILIES:
        seen = {}
        for k, v in second[m].items():
            key = (tuple(v.shape), v.numpy().tobytes())
            assert key not in seen, f"{m}: {k} equals {seen.get(key)}"
            seen[key] = k


def test_vit_and_openvla_converters_match_tools(tiny_second):
    b, second = tiny_second
    sd = cs.openvla_names(second["vla"])
    for tower, vcfg in (("featurizer", b.vla_cfg.dino), ("fused_featurizer", b.vla_cfg.siglip)):
        _trees_equal(*_both("convert_timm_vit", sd, vcfg, prefix=f"vision_backbone.{tower}."))
    mine, ref = _both("convert_openvla", sd, b.vla_cfg)
    _trees_equal(mine, ref)
    _equal_sd(flax_to_torch(mine, "vla"), second["vla"], "round trip")


@pytest.mark.parametrize("sigma", [True, False])
def test_expert_converter_matches_tools(tiny_second, j_side, sigma):
    from tools.export_weights import export_action_expert

    b, _ = tiny_second
    tree = j_side[1]["expert"]
    comps = cs.expert_components(flax_to_torch(tree, "expert"))
    # the projector files are what the reference's exporter writes
    exported = export_action_expert(tree)
    for comp in ("proprio_projector", "noisy_action_projector"):
        want = {k.replace(".kernel", ".weight"): torch.from_numpy(np.ascontiguousarray(v))
                for k, v in exported[comp].items()}
        _equal_sd(comps[comp], want, comp)
    args = (comps["action_head"], comps["sigma_net"] if sigma else None,
            comps["proprio_projector"], comps["noisy_action_projector"])
    mine, ref = _both("convert_action_expert", *args, b.expert_cfg)
    _trees_equal(mine, ref)
    want = {k: v for k, v in flax_to_torch(tree, "expert").items()
            if sigma or not k.startswith("sigma_net.")}
    _equal_sd(flax_to_torch(mine, "expert"), want, "round trip")


def test_tokenizer_converter_matches_tools(tiny_second):
    _, second = tiny_second
    sd = cs.tokenizer_names(second["tokenizer"])
    mine, ref = _both("convert_compressive_vq", sd, n_blocks=3, layers_per_block=1)
    _trees_equal(mine, ref)
    _equal_sd(flax_to_torch(mine, "tokenizer"), second["tokenizer"], "round trip")


@pytest.mark.parametrize("slices", [True, False])
def test_lpips_converter_matches_tools(tiny_second, slices):
    from test_cli_pretrained import _synth_vgg_sd

    sd = {k: torch.from_numpy(v) for k, v in
          _synth_vgg_sd(np.random.default_rng(1), slices=slices).items()}
    (vgg, lin), (j_vgg, j_lin) = t_main._split_lpips_sd(sd), j_main._split_lpips_sd(sd)
    assert list(vgg) == list(j_vgg) and list(lin) == list(j_lin) and len(vgg) == 26
    for heads in (lin, None):
        _trees_equal(*_both("convert_lpips", vgg, heads))
    # the script's writer gives taming's / torchvision's names for the port's LPIPS
    _, second = tiny_second
    names = cs.lpips_names(second["lpips"], slices)
    assert set(names) == set(sd)
    _equal_sd(flax_to_torch(cw.convert_lpips(*t_main._split_lpips_sd(names)), "lpips"),
              second["lpips"], "round trip")


# ------------------------------------------------------------------ loader
@pytest.fixture(scope="module")
def files(tiny_second, tmp_path_factory):
    """The tiny checkpoints in the reference's formats (f32 safetensors:
    the reference's safetensors.numpy reads no bf16)."""
    root = str(tmp_path_factory.mktemp("ckpts"))
    w = cs.write_reference_checkpoints(root, tiny_second[1], st_dtype=torch.float32)
    for d in ("empty", "empty_ckpt"):
        os.makedirs(os.path.join(root, d))
    return w["paths"], root


def _paths_argv(paths, ckpt="ckpt", wm="wm", tok="tokenizer", lpips="lpips"):
    return [f"actor_rollout_ref.model.ckpt_path={paths[ckpt]}",
            f"world_model_rollout.model.path={paths[wm]}",
            f"processor.tokenizer.path={paths[tok]}", f"processor.lpips_path={paths[lpips]}"]


def _j_load(j_side, argv):
    """flax_to_torch of the JAX params after the reference's
    `_maybe_load_pretrained` on the JAX trees."""
    bundle, tree = j_side
    jt = types.SimpleNamespace(bundle=bundle, params=dict(tree))
    j_main._maybe_load_pretrained(jt, j_default_config().apply_overrides(TINY + argv))
    return {m: flax_to_torch(jax.tree_util.tree_map(np.asarray, jt.params[m]), m)
            for m in FAMILIES}


def _load_both(j_side, argv):
    """`_j_load`, and the port's `_maybe_load_pretrained` on a tiny trainer
    that starts from the same trees; returns (port state dicts, the JAX
    side's, the port's report)."""
    ref = _j_load(j_side, argv)
    tree = j_side[1]
    cfg = vla_rft_default_config().apply_overrides(TINY + argv)
    tr = VLARFTGRPOTrainer(cfg, "tiny", device="cpu",
                           params={m: flax_to_torch(tree[m], m) for m in FAMILIES})
    report = t_main._maybe_load_pretrained(tr, cfg)
    port = {m: getattr(tr.bundle, m).state_dict() for m in FAMILIES}
    return port, ref, report


def test_cli_loads_every_checkpoint_like_the_reference(files, j_side, tiny_second, tmp_path):
    """`main_vla_rft_grpo.run` with the four paths on the tiny preset:
    loaded before on_start, one step taken; no parameter equals the files'
    value before the load, and every one equals the JAX trainer's after the
    reference's load, and the files' values."""
    paths, _ = files
    seen, before = {}, {}

    def check(tr):  # the trainer's own parameters, just before the load
        before["same"], _, before["n"] = cs.compare_written(tr, tiny_second[1],
                                                            {"vla": None, "wm": None})

    def on_start(tr):
        seen.update({m: {k: v.clone() for k, v in getattr(tr.bundle, m).state_dict().items()}
                     for m in FAMILIES})

    steps = []
    with cs.before_load(check):
        tr = t_main.run(["--preset=tiny", "--device=cpu", *TINY, *_paths_argv(paths),
                         f"trainer.default_local_dir={tmp_path}"], on_start=on_start,
                        on_step_end=lambda s, m: steps.append(m))
    assert before["n"] > 0 and before["same"] == [], before
    assert set(tr.pretrained) == set(FAMILIES)
    assert len(steps) == 1 and all(np.isfinite(v) for v in steps[0].values())
    ref = _j_load(j_side, _paths_argv(paths))
    for m in FAMILIES:
        _equal_sd(seen[m], ref[m], m)
        _equal_sd(seen[m], tiny_second[1][m], m)


@pytest.mark.parametrize("edge", ["no_sigma_net", "no_lpips_heads", "no_weights"])
def test_load_edges_match_the_reference(files, j_side, tiny_second, edge):
    paths, root = files
    before = {m: flax_to_torch(j_side[1][m], m) for m in FAMILIES}
    if edge == "no_sigma_net":
        port, ref, report = _load_both(j_side, _paths_argv(paths, ckpt="ckpt_nosigma"))
        kept = [k for k in before["expert"] if k.startswith("sigma_net.")]
        assert kept and all(torch.equal(port["expert"][k], before["expert"][k]) for k in kept)
        assert set(report) == set(FAMILIES)
    elif edge == "no_lpips_heads":
        lp = os.path.join(root, "lpips_nolin")
        os.makedirs(lp, exist_ok=True)
        vgg = {k: v for k, v in cs.lpips_names(tiny_second[1]["lpips"]).items()
               if not k.startswith("lin")}
        torch.save(vgg, os.path.join(lp, "vgg.pth"))
        port, ref, report = _load_both(j_side, [f"processor.lpips_path={lp}"])
        assert set(report) == {"lpips"}
        for k in before["lpips"]:
            want = before["lpips"][k] if k.startswith("lin") else tiny_second[1]["lpips"][k]
            assert torch.equal(port["lpips"][k], want), k
    else:  # directories without weight files load nothing, as the reference's glob
        empty = {"ckpt": os.path.join(root, "empty_ckpt"), "wm": os.path.join(root, "empty")}
        port, ref, report = _load_both(j_side, [f"actor_rollout_ref.model.ckpt_path={empty['ckpt']}",
                                                f"world_model_rollout.model.path={empty['wm']}"])
        assert report == {}
        for m in FAMILIES:
            _equal_sd(port[m], before[m], m)
    for m in FAMILIES:
        _equal_sd(port[m], ref[m], m)


@pytest.mark.parametrize("key", ["processor.tokenizer.path", "processor.lpips_path"])
def test_a_weightless_tokenizer_or_lpips_path_raises(files, j_side, key):
    _, root = files
    empty = os.path.join(root, "empty")
    with pytest.raises(FileNotFoundError):
        _j_load(j_side, [f"{key}={empty}"])
    cfg = vla_rft_default_config().apply_overrides(TINY + [f"{key}={empty}"])
    tr = VLARFTGRPOTrainer(cfg, "tiny", device="cpu")
    with pytest.raises(FileNotFoundError):
        t_main._maybe_load_pretrained(tr, cfg)


def test_port_imports_no_optional_package_at_import_time():
    """Every module of the port and chip_smoke.py import with none of JAX,
    the JAX package, tools/, safetensors, transformers, mujoco or PIL
    loaded (the card's machine has none of them; the loaders read the
    files themselves, and the push env imports mujoco and PIL inside the
    functions that need them)."""
    import subprocess
    import sys

    code = (
        "import importlib, pkgutil, sys\n"
        "import vla_rft_tpu_torch\n"
        "for m in pkgutil.walk_packages(vla_rft_tpu_torch.__path__, 'vla_rft_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = ('jax', 'vla_rft_tpu', 'tools', 'safetensors', 'transformers', 'mujoco', 'PIL')\n"
        "print(sorted({k.split('.')[0] for k in sys.modules} & set(bad)))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
