"""The port's RLDS data path against the JAX package, on the CPU: TFRecord
framing, the tf.train.Example codec, the native image ops, RLDSDataset, the
fixture chip_smoke.py's grpo_rlds phase reads, and the GRPO entry point on
records.

Records, frames and episodes come from numpy with fixed seeds.  Every
comparison is exact (bytes, uint8 pixels, int32 ids, float32 arrays at atol
0) except the GRPO step against the JAX trainer's, which takes
tests/test_torch_grpo.py's tolerances (see there).  The reference's image
ops must load their native library (`have_native()`): its route, bilinear
with half-pixel centres and no antialias, is the one the port reproduces;
its Pillow fallback antialiases when it shrinks.

Write the fixture anew (the tests check it against the JAX package):
    python tests/test_torch_rlds.py --write-fixture
"""
import dataclasses
import io
import json
import os
import pathlib
import struct
import subprocess
import sys

import numpy as np
import pytest
import tensorflow as tf
import torch
from PIL import Image

import jax

from vla_rft_tpu.data import image_ops as j_img
from vla_rft_tpu.data import rlds as j_rlds
from vla_rft_tpu.data import tfrecord as j_tf
from vla_rft_tpu_torch.data import example_proto as ep
from vla_rft_tpu_torch.data import image_ops as t_img
from vla_rft_tpu_torch.data import rlds as t_rlds
from vla_rft_tpu_torch.data import tfrecord as t_tf
from vla_rft_tpu_torch.eval.policy import _StubTokenizer

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the fixture's record writer and digests)

FIXTURE = ROOT / chip_smoke.RLDS_FIXTURE
NAME = "fake_ds"
TOK = _StubTokenizer()
SMALL = dict(dataset_name=NAME, window_frames=9, action_chunk=8, policy_image_size=28,
             wm_image_size=32)


def _jpeg(arr: np.ndarray, quality: int = 90, subsampling: int = 2, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(arr).save(b, "JPEG", quality=quality, subsampling=subsampling, **kw)
    return b.getvalue()


def _png(arr: np.ndarray) -> bytes:
    b = io.BytesIO()
    Image.fromarray(arr).save(b, "PNG")
    return b.getvalue()


def _scene(rng, h=32, w=32) -> np.ndarray:
    """A smooth background with a few blocks and some noise."""
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    img = (rng.uniform(40, 200, 3) + rng.uniform(-60, 60, 3) * (xx / w)[..., None]
           + rng.uniform(-60, 60, 3) * (yy / h)[..., None])
    for _ in range(3):
        y0, x0 = rng.integers(0, h - 4), rng.integers(0, w - 4)
        img[y0:y0 + rng.integers(3, h // 2), x0:x0 + rng.integers(3, w // 2)] = rng.uniform(0, 255, 3)
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


def _write_ds(tmp_path, episodes_per_shard, T=12, fmt="jpeg", seed=0, sizes=None):
    """Shards of episodes written by the reference's make_episode_example
    (TensorFlow's serialisation) and write_records."""
    rng = np.random.default_rng(seed)
    d = tmp_path / NAME
    d.mkdir(exist_ok=True)
    cfg = j_rlds.RLDSConfig()
    for s, n in enumerate(episodes_per_shard):
        payloads = []
        for e in range(n):
            hw = sizes[e % len(sizes)] if sizes else (32, 32)
            enc = _jpeg if fmt == "jpeg" else _png
            imgs = [enc(_scene(rng, *hw)) for _ in range(T)]
            payloads.append(j_rlds.make_episode_example(
                imgs, rng.uniform(-0.4, 0.4, (T, 7)), rng.normal(size=(T, 8)),
                f"put the bowl {s} {e} on the plate", cfg))
        j_tf.write_records(str(d / f"shard-{s}.tfrecord"), payloads)
    return str(tmp_path)


def _assert_batches_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _pair(data_dir, batch_size=3, stats=None, image_aug=False, **kw):
    fields = {**SMALL, "data_dir": data_dir, **kw}
    j = j_rlds.RLDSDataset(j_rlds.RLDSConfig(**fields), TOK, batch_size=batch_size,
                           stats=stats, image_aug=image_aug)
    t = t_rlds.RLDSDataset(t_rlds.RLDSConfig(**fields), TOK, batch_size=batch_size,
                           stats=stats, image_aug=image_aug)
    return t, j


# ---------------------------------------------------------- record framing
PAYLOADS = [b"hello", b"x" * 1000, b"", bytes(range(256)) * 3]


@pytest.mark.parametrize("plain", [False, True], ids=["native", "plain"])
def test_records_are_byte_equal_to_the_reference(tmp_path, plain):
    j_tf.write_records(str(tmp_path / "j"), PAYLOADS)
    t_tf.write_records(str(tmp_path / "t"), PAYLOADS, plain=plain)
    assert (tmp_path / "j").read_bytes() == (tmp_path / "t").read_bytes()
    path = str(tmp_path / "j")
    assert t_tf.scan_records(path, True, plain=plain) == j_tf.scan_records(path, True)
    assert list(t_tf.read_records(path, True, plain=plain)) == PAYLOADS


@pytest.mark.parametrize("plain", [False, True], ids=["native", "plain"])
@pytest.mark.parametrize("where", ["length", "length_crc", "payload", "payload_crc"])
def test_corrupt_records_raise(tmp_path, plain, where):
    path = tmp_path / "r"
    t_tf.write_records(str(path), [b"abcdef", b"ghij"], plain=plain)
    buf = bytearray(path.read_bytes())
    # the first record: length at 0, its crc at 8, the payload at 12, its crc at 18
    buf[{"length": 0, "length_crc": 9, "payload": 13, "payload_crc": 19}[where]] ^= 0x01
    path.write_bytes(bytes(buf))
    if where == "length":  # a longer record than the file holds: always an error
        with pytest.raises(ValueError, match="corrupt tfrecord"):
            list(t_tf.read_records(str(path), plain=plain))
    else:  # only the crc check sees it
        assert len(list(t_tf.read_records(str(path), plain=plain))) == 2
    with pytest.raises(ValueError, match="corrupt tfrecord"):
        t_tf.scan_records(str(path), verify_crc=True, plain=plain)


def test_native_and_plain_readers_agree(tmp_path):
    rng = np.random.default_rng(3)
    for i, n in enumerate((0, 1, 7, 40)):
        payloads = [rng.bytes(int(rng.integers(0, 3000))) for _ in range(n)]
        path = str(tmp_path / f"f{i}")
        t_tf.write_records(path, payloads)
        native = list(t_tf.read_records(path, verify_crc=True))
        assert native == list(t_tf.read_records(path, verify_crc=True, plain=True)) == payloads
        assert t_tf.scan_records(path, True) == t_tf.scan_records(path, True, plain=True)
    assert t_tf.crc32c(b"123456789") == 0xE3069283  # the crc32c check value


def test_tensorflow_reads_the_ports_records_and_the_port_reads_tensorflows(tmp_path):
    t_tf.write_records(str(tmp_path / "t"), PAYLOADS)
    assert [r.numpy() for r in tf.data.TFRecordDataset(str(tmp_path / "t"))] == PAYLOADS
    with tf.io.TFRecordWriter(str(tmp_path / "tf")) as w:
        for p in PAYLOADS:
            w.write(p)
    for plain in (False, True):
        assert list(t_tf.read_records(str(tmp_path / "tf"), True, plain=plain)) == PAYLOADS


# ----------------------------------------------------- tf.train.Example codec
def _tf_values(feature):
    kind = feature.WhichOneof("kind")
    if kind is None:
        return None, None
    return kind, list(getattr(feature, kind).value)


def _assert_parse_equals_tf(raw: bytes):
    got = ep.parse_example(raw).features
    ref = tf.train.Example.FromString(raw).features.feature
    assert sorted(got) == sorted(ref)
    for key, feature in ref.items():
        kind, values = _tf_values(feature)
        g_kind, g_values = got[key]
        assert g_kind == kind, key
        if kind == "bytes_list":
            assert g_values == values, key
        elif kind == "float_list":
            assert g_values.dtype == np.float32
            np.testing.assert_array_equal(g_values, np.asarray(values, np.float32))
        elif kind == "int64_list":
            assert g_values.dtype == np.int64
            np.testing.assert_array_equal(g_values, np.asarray(values, np.int64))


def test_parser_reads_reference_episodes_as_decode_example_does(tmp_path):
    rng = np.random.default_rng(4)
    cfg = j_rlds.RLDSConfig()
    imgs = [_jpeg(_scene(rng)) for _ in range(6)]
    raw = j_rlds.make_episode_example(imgs, rng.uniform(-1, 1, (6, 7)), rng.normal(size=(6, 8)),
                                      "open the top drawer", cfg)
    _assert_parse_equals_tf(raw)
    ex = ep.parse_example(raw)
    assert ex.bytes_list(cfg.image_key) == imgs
    ref = j_rlds._decode_example(raw, cfg)
    got = t_rlds._decode_example(raw, t_rlds.RLDSConfig())
    assert got["lang"] == ref["lang"] == "open the top drawer"
    for k in ("images", "actions", "states"):
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])


def test_tensorflow_parses_the_ports_writer():
    rng = np.random.default_rng(5)
    feats = {"frames": (ep.BYTES, [b"a", b"", bytes(300)]),
             "act": (ep.FLOAT, rng.normal(size=40).astype(np.float32)),
             "ids": (ep.INT64, [0, 1, -1, 2 ** 62, -(2 ** 63), 2 ** 63 - 1]),
             "none_f": (ep.FLOAT, []), "none_b": (ep.BYTES, []), "none_i": (ep.INT64, [])}
    raw = ep.serialize_example(feats)
    ref = tf.train.Example.FromString(raw).features.feature
    for key, (kind, values) in feats.items():
        assert ref[key].WhichOneof("kind") == kind
        got = list(getattr(ref[key], kind).value)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(values))
    _assert_parse_equals_tf(raw)
    # the port's episode writer as the reference's decode reads it
    cfg = t_rlds.RLDSConfig()
    imgs = [_jpeg(_scene(rng)) for _ in range(4)]
    acts, states = rng.uniform(-1, 1, (4, 7)), rng.normal(size=(4, 8))
    ours = j_rlds._decode_example(t_rlds.make_episode_example(imgs, acts, states, "x", cfg),
                                  j_rlds.RLDSConfig())
    theirs = j_rlds._decode_example(j_rlds.make_episode_example(imgs, acts, states, "x", cfg),
                                    j_rlds.RLDSConfig())
    for k in ("images", "actions", "states"):
        np.testing.assert_array_equal(ours[k], theirs[k])


def _tag(field, wire):
    return ep._enc_varint(field << 3 | wire)


def _entry(key: str, feature: bytes) -> bytes:
    return ep._delimited(1, ep._delimited(1, key.encode()) + ep._delimited(2, feature))


def _unpacked_floats(values) -> bytes:  # FloatList, one fixed32 field a value
    return b"".join(_tag(1, 5) + struct.pack("<f", v) for v in values)


def _unpacked_ints(values) -> bytes:  # Int64List, one varint field a value
    return b"".join(_tag(1, 0) + ep._enc_varint(v) for v in values)


CASES = {
    "packed_floats": [_entry("f", ep._delimited(2, ep._delimited(1, struct.pack("<3f", 1.5, -2, 3e-8))))],
    "unpacked_floats": [_entry("f", ep._delimited(2, _unpacked_floats([1.5, -2.0, 7.25])))],
    "mixed_floats": [_entry("f", ep._delimited(2, _unpacked_floats([1.0])
                                               + ep._delimited(1, struct.pack("<2f", 2, 3))))],
    "packed_int64": [_entry("i", ep._delimited(3, ep._delimited(1, b"".join(
        ep._enc_varint(v) for v in (5, -7, 2 ** 40)))))],
    "unpacked_int64": [_entry("i", ep._delimited(3, _unpacked_ints([-1, 0, 300])))],
    "empty_lists": [_entry("f", ep._delimited(2, b"")), _entry("b", ep._delimited(1, b"")),
                    _entry("i", ep._delimited(3, b"")), _entry("none", b"")],
    "multi_frame_bytes": [_entry("frames", ep._delimited(1, b"".join(
        ep._delimited(1, bytes([k]) * k) for k in range(5))))],
    "repeated_key_last_wins": [_entry("k", ep._delimited(1, ep._delimited(1, b"old"))),
                               _entry("k", ep._delimited(2, _unpacked_floats([4.0])))],
    "unknown_fields_skipped": [_tag(9, 0) + ep._enc_varint(12) + _tag(10, 5) + b"abcd"
                               + _entry("b", ep._delimited(1, ep._delimited(1, b"v")))],
}
UNKNOWN = _tag(7, 2) + ep._delimited(0, b"")[1:] + _tag(6, 1) + bytes(8)  # Example-level


@pytest.mark.parametrize("case", sorted(CASES))
def test_parser_equals_tensorflow(case):
    raw = ep._delimited(1, b"".join(CASES[case]))
    if case == "unknown_fields_skipped":
        raw = UNKNOWN + raw
    _assert_parse_equals_tf(raw)
    ex = ep.parse_example(raw)
    # the accessors read a missing key, or a key of another kind, as empty
    assert ex.bytes_list("missing") == [] and ex.float_list("missing").size == 0
    assert ex.int64_list("missing").dtype == np.int64
    for key, (kind, _) in ex.features.items():
        if kind != ep.BYTES:
            assert ex.bytes_list(key) == []


def test_parser_rejects_truncated_examples():
    raw = ep.serialize_example({"f": (ep.FLOAT, [1.0, 2.0, 3.0]), "b": (ep.BYTES, [b"xyz"])})
    for cut in (3, len(raw) - 1):
        with pytest.raises(ValueError):
            ep.parse_example(raw[:cut])


# ---------------------------------------------------------------- image ops
def test_the_reference_compares_on_its_native_library():
    assert j_img.have_native(), "the reference's csrc/libimage_ops.so must load"


def _frames(seed, shapes, **kw):
    rng = np.random.default_rng(seed)
    return [_jpeg(_scene(rng, h, w), **kw) for h, w in shapes]


@pytest.mark.parametrize("threads", [1, 8])
@pytest.mark.parametrize("kind", ["420", "444", "progressive", "mixed_sizes"])
def test_jpeg_decode_is_bit_equal_to_the_reference(threads, kind):
    shapes = [(48, 40)] * 4 if kind != "mixed_sizes" else [(48, 40), (32, 64), (17, 23), (48, 64)]
    kw = {"444": dict(subsampling=0), "progressive": dict(progressive=True)}.get(kind, {})
    frames = _frames(6, shapes, **kw)
    h, w = max(s[0] for s in shapes), max(s[1] for s in shapes)
    ref = j_img.decode_jpeg_batch(frames, h, w)
    np.testing.assert_array_equal(t_img.decode_jpeg_batch(frames, h, w, threads=threads), ref)
    np.testing.assert_array_equal(t_img.decode_jpeg_plain(frames, h, w), ref)
    assert [t_img.jpeg_dims(b) for b in frames] == [j_img.jpeg_dims(b) for b in frames]


def test_mixed_size_episode_decodes_at_the_largest_dims():
    rng = np.random.default_rng(7)
    frames = _frames(7, [(40, 40), (56, 48), (40, 64)])
    raw = j_rlds.make_episode_example(frames, rng.normal(size=(3, 7)), rng.normal(size=(3, 8)),
                                      "x", j_rlds.RLDSConfig())
    ref = j_rlds._decode_example(raw, j_rlds.RLDSConfig())["images"]
    assert ref.shape == (3, 56, 64, 3)
    got = t_rlds._decode_example(raw, t_rlds.RLDSConfig())["images"]
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", [(256, 256, 224, 224), (224, 224, 256, 256), (37, 91, 64, 32),
                                   (5, 5, 100, 3), (300, 200, 224, 224)])
def test_resize_is_bit_equal_to_the_reference(shape):
    h, w, oh, ow = shape
    im = np.random.default_rng(8).integers(0, 256, (3, h, w, 3), np.uint8)
    ref = j_img.resize_bilinear_batch(im, oh, ow)
    np.testing.assert_array_equal(t_img.resize_bilinear_batch(im, oh, ow), ref)
    np.testing.assert_array_equal(np.stack([t_img.resize_bilinear_plain(x, oh, ow) for x in im]),
                                  ref)


def test_crop_resize_flip_is_bit_equal_to_the_reference():
    rng = np.random.default_rng(9)
    n = 8
    im = rng.integers(0, 256, (n, 64, 80, 3), np.uint8)
    # boxes inside, across and past the edges (the library clamps them)
    y0, x0 = rng.integers(-3, 70, n), rng.integers(-3, 90, n)
    ch, cw = rng.integers(-1, 90, n), rng.integers(0, 100, n)
    flip = rng.integers(0, 2, n).astype(np.uint8)
    ref = j_img.crop_resize_flip_batch(im, y0, x0, ch, cw, flip, 50, 61)
    np.testing.assert_array_equal(t_img.crop_resize_flip_batch(im, y0, x0, ch, cw, flip, 50, 61),
                                  ref)
    np.testing.assert_array_equal(t_img.crop_resize_flip_plain(im, y0, x0, ch, cw, flip, 50, 61),
                                  ref)


def test_the_native_resize_is_not_the_antialiased_pillow_fallback():
    """256 -> 224: the reference's native route (which the port takes) and
    its Pillow fallback (antialiased) give different pixels."""
    im = np.random.default_rng(10).integers(0, 256, (1, 256, 256, 3), np.uint8)
    native = t_img.resize_bilinear_batch(im, 224, 224)[0]
    pil = np.asarray(Image.fromarray(im[0]).resize((224, 224), Image.BILINEAR))
    assert np.abs(native.astype(int) - pil).mean() > 1.0


@pytest.mark.parametrize("bad", ["header_only", "truncated", "png"])
def test_a_corrupt_jpeg_raises(bad):
    good = _frames(11, [(32, 32)])[0]
    frame = {"header_only": b"\xff\xd8\xff\xe0" + b"\x00" * 64,
             "truncated": good[: len(good) // 3],
             "png": _png(np.zeros((32, 32, 3), np.uint8))}[bad]
    with pytest.raises((ValueError, OSError)):
        t_img.decode_jpeg_batch([good, frame], 32, 32)


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA"])
def test_non_jpeg_frames_decode_as_tensorflow_does(mode):
    rng = np.random.default_rng(12)
    arr = rng.integers(0, 256, (20, 24, {"RGB": 3, "L": 1, "RGBA": 4}[mode]), np.uint8)
    png = _png(arr[..., 0] if mode == "L" else arr)
    ref = np.asarray(tf.io.decode_image(png, expand_animations=False))
    got = t_rlds._decode_image(png)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_non_jpeg_frames_without_pillow_name_the_format(monkeypatch):
    png = _png(np.zeros((4, 4, 3), np.uint8))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PNG frame needs Pillow"):
        t_rlds._decode_image(png)


# ------------------------------------------------------------- RLDSDataset
@pytest.mark.parametrize("image_aug", [False, True], ids=["aug_off", "aug_on"])
@pytest.mark.parametrize("shards", [1, 3], ids=["every_nth_episode", "whole_shards"])
def test_batches_equal_the_reference(tmp_path, image_aug, shards):
    """Both splits of both holdout modes, four batches each, through a
    16-window reservoir (so draws replace slots across episodes and
    epochs): every field exact."""
    data_dir = _write_ds(tmp_path, [4] if shards == 1 else [2, 2, 1], seed=shards)
    stats = None
    for split in ("train", "val"):
        t, j = _pair(data_dir, stats=stats, image_aug=image_aug and split == "train",
                     shuffle_buffer_size=16, val_fraction=0.34, split=split)
        assert t.files == j.files
        assert [s.files for s in t._streams] == [s.files for s in j._streams]
        stats = j.stats
        for _ in range(4):
            _assert_batches_equal(t.next_batch(), j.next_batch())
        assert t.state_dict() == j.state_dict()


def test_png_episodes_and_a_full_reservoir_equal_the_reference(tmp_path):
    data_dir = _write_ds(tmp_path, [2, 1], fmt="png", seed=13)
    t, j = _pair(data_dir, batch_size=4, image_aug=True)  # 10k reservoir: one data cycle
    for _ in range(3):
        _assert_batches_equal(t.next_batch(), j.next_batch())
    assert len(t._buffer) == len(j._buffer)


def test_stats_and_save_dataset_statistics_equal_the_reference(tmp_path):
    data_dir = _write_ds(tmp_path, [1, 1, 1, 1, 1], seed=14)  # stats read the first 4 shards
    t, j = _pair(data_dir, val_fraction=0.4)
    assert t.stats == j.stats
    t.save_dataset_statistics(str(tmp_path / "t.json"))
    j.save_dataset_statistics(str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    rng = np.random.default_rng(14)
    a = rng.normal(size=(300, 7))
    assert t_rlds.compute_dataset_statistics(a, a[:, :3]) == j_rlds.compute_dataset_statistics(
        a, a[:, :3])
    np.testing.assert_array_equal(t_rlds.normalize_bounds_q99(a, t.stats["action"]),
                                  j_rlds.normalize_bounds_q99(a, j.stats["action"]))


def test_resume_equals_the_reference(tmp_path):
    """tests/test_rlds.py::test_stream_resume_deterministic on both
    packages: the state after three batches, restored into fresh datasets
    (also through the trainer checkpoint's int round trip), gives the same
    next batch in the port as in the reference."""
    data_dir = _write_ds(tmp_path, [2, 2], seed=15)
    t, j = _pair(data_dir, batch_size=4, shuffle_buffer_size=16, image_aug=True)
    for _ in range(3):
        _assert_batches_equal(t.next_batch(), j.next_batch())
    st = t.state_dict()
    assert st == j.state_dict() and st["step"] == 3
    rt = {k: int(np.asarray(v)) for k, v in st.items()}
    t2, j2 = _pair(data_dir, batch_size=4, shuffle_buffer_size=16, image_aug=True)
    t2.load_state_dict(rt)
    j2.load_state_dict(st)
    for _ in range(2):
        _assert_batches_equal(t2.next_batch(), j2.next_batch())
    assert t2.state_dict() == j2.state_dict()


def test_two_processes_read_the_reference_files_per_rank(tmp_path, monkeypatch):
    import torch.distributed as dist

    data_dir = _write_ds(tmp_path, [1, 1, 1, 1, 1], T=10, seed=16)
    for rank in (0, 1):
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_world_size", lambda: 2)
        monkeypatch.setattr(dist, "get_rank", lambda r=rank: r)
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        t, j = _pair(data_dir, batch_size=2, val_fraction=0.2)
        assert t.files == j.files and len(t.files) == 2
        assert t._pi == j._pi == rank
        _assert_batches_equal(t.next_batch(), j.next_batch())


# ------------------------------------------------------------------ fixture
def _fixture_frames():
    """8 baseline 4:2:0 JPEGs of 256 x 256 seeded table-top scenes."""
    out = []
    for i in range(8):
        rng = np.random.default_rng((16, 100 + i))
        out.append(_jpeg(_scene(rng, 256, 256), quality=90, subsampling=2))
    return out


def _fixture_digests(tmp_path, frames):
    """The reference RLDSDataset's first two train batches on the records
    chip_smoke.py writes, with its config (val_fraction 0.5, libero sizes,
    image_aug on, the crc32 stub tokenizer)."""
    from vla_rft_tpu_torch.trainer.main_vla_rft_grpo import rlds_config

    data_dir = str(tmp_path / "rlds")
    chip_smoke.write_rlds_records(data_dir, frames)
    config = chip_smoke.rlds_config_tree(data_dir)
    fields = dataclasses.asdict(rlds_config(config, "libero", split="train"))
    ds = j_rlds.RLDSDataset(j_rlds.RLDSConfig(**fields), TOK,
                            batch_size=config.data.train_batch_size,
                            image_aug=bool(config.data.image_aug))
    fields.pop("data_dir")  # a temporary directory
    return {"batches": [chip_smoke.batch_digest(ds.next_batch()) for _ in range(2)],
            "config": fields}


def write_fixture(out: pathlib.Path, tmp_path: pathlib.Path) -> None:
    out.mkdir(parents=True, exist_ok=True)
    frames = _fixture_frames()
    for i, b in enumerate(frames):
        (out / f"frame_{i}.jpg").write_bytes(b)
    np.savez_compressed(out / "pixels.npz", pixels=j_img.decode_jpeg_batch(frames, 256, 256))
    (out / "digests.json").write_text(json.dumps(_fixture_digests(tmp_path, frames)) + "\n")


def test_the_fixture_is_what_the_reference_gives(tmp_path):
    frames, pixels, digests = chip_smoke.rlds_fixture(str(ROOT))
    assert frames == _fixture_frames()
    assert all(Image.open(io.BytesIO(b)).size == (256, 256) for b in frames)
    np.testing.assert_array_equal(pixels, j_img.decode_jpeg_batch(frames, 256, 256))
    assert json.loads(json.dumps(_fixture_digests(tmp_path, frames))) == digests
    size = sum(f.stat().st_size for f in FIXTURE.iterdir())
    assert size < 2 * 2 ** 20, size


def test_the_ports_batches_match_the_fixture_digests(tmp_path):
    """What chip_smoke.py's grpo_rlds phase checks on the card, here through
    the entry point's dataset build at the libero preset."""
    from vla_rft_tpu_torch.trainer.main_vla_rft_grpo import build_rlds_datasets

    frames, pixels, digests = chip_smoke.rlds_fixture(str(ROOT))
    np.testing.assert_array_equal(t_img.decode_jpeg_batch(frames, 256, 256), pixels)
    data_dir = str(tmp_path / "rlds")
    paths = chip_smoke.write_rlds_records(data_dir, frames)
    for p in paths:
        assert list(t_tf.read_records(p, True)) == list(t_tf.read_records(p, plain=True))
    ds, val = build_rlds_datasets(chip_smoke.rlds_config_tree(data_dir), "libero", TOK)
    assert val is not None and val.stats is ds.stats and set(val.files).isdisjoint(ds.files)
    for ref in digests["batches"]:
        chip_smoke.compare_digests(chip_smoke.batch_digest(ds.next_batch()), ref)


@pytest.mark.parametrize("field", ["pixel_values", "proprio", "input_ids"])
def test_a_batch_digest_catches_one_changed_value(field):
    """One float32 ulp or one token id in one field fails the comparison."""
    rng = np.random.default_rng(18)
    batch = {"pixel_values": rng.random((2, 8, 8, 6), dtype=np.float32),
             "proprio": rng.normal(size=(2, 8)).astype(np.float32),
             "input_ids": rng.integers(0, 1000, (2, 12)).astype(np.int32)}
    ref = chip_smoke.batch_digest(batch)
    chip_smoke.compare_digests(chip_smoke.batch_digest(dict(batch)), ref)
    changed = {k: v.copy() for k, v in batch.items()}
    flat = changed[field].reshape(-1)
    flat[5] = (np.nextafter(flat[5], np.float32(np.inf)) if flat.dtype.kind == "f"
               else flat[5] + 1)
    with pytest.raises(AssertionError, match=field):
        chip_smoke.compare_digests(chip_smoke.batch_digest(changed), ref)


def test_the_port_imports_no_tensorflow_protobuf_or_jax():
    mods = ["vla_rft_tpu_torch.data." + m for m in
            ("rlds", "tfrecord", "example_proto", "image_ops", "oxe", "prefetch")]
    code = ("import sys; " + "; ".join(f"import {m}" for m in mods)
            + "; import vla_rft_tpu_torch.utils.fs, vla_rft_tpu_torch.utils.tracking"
            + "; import vla_rft_tpu_torch.trainer.main_vla_rft_grpo"
            + "; print(sorted(m for m in sys.modules if m.split('.')[0] in "
              "('tensorflow', 'jax', 'vla_rft_tpu', 'PIL', 'transformers') "
              "or m.startswith('google.protobuf')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout.strip()
    assert out == "[]", out


# ------------------------------------------------------ the GRPO entry point
def _tiny_records(tmp_path, T=8):
    """2 shards x 2 episodes of T steps of 32 px JPEG frames, written with
    the port's writers."""
    rng = np.random.default_rng(17)
    cfg = t_rlds.RLDSConfig()
    d = tmp_path / "rlds" / cfg.dataset_name
    d.mkdir(parents=True)
    for s in range(2):
        eps = [t_rlds.make_episode_example(
            [_jpeg(_scene(rng)) for _ in range(T)], rng.uniform(-1, 1, (T, 7)),
            rng.normal(size=(T, 8)), f"put the bowl {s}{e} on the plate", cfg) for e in range(2)]
        t_tf.write_records(str(d / f"shard-{s}.tfrecord"), eps)
    return str(tmp_path / "rlds")


def _tiny_argv(tmp_path, data_dir, out, extra=()):
    from test_torch_grpo import _tiny_overrides

    return ["--preset=tiny", "--device=cpu", *_tiny_overrides(tmp_path / out),
            f"data.video.dataset_path={data_dir}", "data.val_fraction=0.5", *extra]


def _recording(draws):
    """An on_start hook that records every batch the trainer draws and its
    dataset's state right after."""
    def on_start(trainer):
        inner = trainer.dataset.next_batch

        def next_batch():
            b = inner()
            draws.append((b, trainer.dataset.state_dict()))
            return b

        trainer.dataset.next_batch = next_batch
    return on_start


def _reference_dataset(config, preset="tiny", state=None):
    from vla_rft_tpu_torch.trainer.main_vla_rft_grpo import rlds_config

    fields = dataclasses.asdict(rlds_config(config, preset, split="train"))
    ds = j_rlds.RLDSDataset(j_rlds.RLDSConfig(**fields), TOK,
                            batch_size=config.data.train_batch_size,
                            image_aug=bool(config.data.image_aug))
    if state is not None:
        ds.load_state_dict(state)
    return ds


def test_cli_takes_two_steps_from_records(tmp_path):
    """main_vla_rft_grpo.run at the tiny preset on records it wrote: two
    steps and validation (val_before_train) on the val shard; its first
    batch equals the reference RLDSDataset's on the same records (the
    preset's sizes, image_aug on by default, the same stub tokenizer)."""
    from vla_rft_tpu_torch.trainer import main_vla_rft_grpo

    data_dir = _tiny_records(tmp_path)
    draws, steps = [], []
    tr = main_vla_rft_grpo.run(
        _tiny_argv(tmp_path, data_dir, "out", ["trainer.val_before_train=true",
                                               "trainer.val_iters=1"]),
        _recording(draws), on_step_end=lambda s, m: steps.append((s, m)), tokenizer=TOK)
    assert [s for s, _ in steps] == [1, 2]
    assert all(np.isfinite(v) for _, m in steps for v in m.values())
    assert len(draws) == 2 and tr.val_dataset._step == 1
    assert [os.path.basename(f) for f in tr.dataset.files] == ["shard-1.tfrecord"]
    assert [os.path.basename(f) for f in tr.val_dataset.files] == ["shard-0.tfrecord"]
    assert tr.val_dataset.stats is tr.dataset.stats and not tr._val_on_train_stream
    ref = _reference_dataset(tr.config)
    for batch, state in draws:
        _assert_batches_equal(batch, ref.next_batch())
        assert state == ref.state_dict()
    b, bundle = draws[0][0], tr.bundle  # the tiny preset's sizes, segment_length 3
    assert b["pixel_values"].shape == (2, bundle.policy_image_size, bundle.policy_image_size, 6)
    assert b["raw_pixel_values"].shape == (2, 3, bundle.image_size, bundle.image_size, 3)


def test_cli_kill_and_resume(tmp_path):
    """Killed after step 1's checkpoint, then restarted: the checkpoint holds
    the dataloader's state after step 1's batch, before the prefetch of step
    2's (the trainer's _dl_ckpt_state rule), equal to the uninterrupted run's
    state there, and the restarted run's step-2 batch equals the reference
    RLDSDataset's restored from that state.  It is not the uninterrupted
    run's step-2 batch: on a restore the reservoir refills from the stream
    position instead of replaying what it held (the reference's
    load_state_dict, vla_rft_tpu/data/rlds.py:319-325)."""
    from vla_rft_tpu_torch.trainer import main_vla_rft_grpo

    data_dir = _tiny_records(tmp_path)
    whole = []
    main_vla_rft_grpo.run(_tiny_argv(tmp_path, data_dir, "whole"), _recording(whole),
                          tokenizer=TOK)

    class Killed(Exception):
        pass

    def kill(step):
        if step == 2:
            raise Killed

    argv = _tiny_argv(tmp_path, data_dir, "ckpt", ["trainer.save_freq=1"])
    with pytest.raises(Killed):
        main_vla_rft_grpo.run(argv, on_step_start=kill, tokenizer=TOK)
    resumed, steps = [], []
    tr = main_vla_rft_grpo.run(argv, _recording(resumed),
                               on_step_end=lambda s, m: steps.append(s), tokenizer=TOK)
    assert steps == [2]
    saved = tr.ckpt.restore(1)["dataloader"]
    assert {k: int(v) for k, v in saved.items()} == whole[0][1]
    ref = _reference_dataset(tr.config, state=whole[0][1])
    _assert_batches_equal(resumed[0][0], ref.next_batch())
    assert resumed[0][1] == ref.state_dict()


def test_cli_needs_a_tokenizer_for_records(tmp_path, monkeypatch):
    from vla_rft_tpu_torch.trainer import main_vla_rft_grpo

    data_dir = _tiny_records(tmp_path)
    with pytest.raises(ValueError, match="ckpt_path"):
        main_vla_rft_grpo.run(_tiny_argv(tmp_path, data_dir, "a"))
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="run\\(tokenizer=...\\)"):
        main_vla_rft_grpo.run(_tiny_argv(tmp_path, data_dir, "b",
                                         [f"actor_rollout_ref.model.ckpt_path={tmp_path}"]))
    with pytest.raises(FileNotFoundError, match="no tfrecords"):
        main_vla_rft_grpo.run(_tiny_argv(tmp_path, str(tmp_path / "nowhere"), "c"),
                              tokenizer=TOK)


@pytest.mark.slow  # its JAX trainer compiles the reference stages (about a minute on the CPU)
def test_tiny_grpo_step_from_records_matches_jax(tmp_path):
    """One tiny training step of each trainer on its own package's
    RLDSDataset over the same records (the batches equal), from the same
    weights, with the sampling pinned as in
    tests/test_torch_grpo.py::test_tiny_training_step_matches_jax (greedy WM
    decode, the reference's flow draws and rollout) and held to that test's
    tolerances: metrics within 1e-3 relative + 1e-5, the expert's update
    within 1e-5 of JAX's on >= 99.5 % of the elements."""
    import jax.numpy as jnp

    from test_torch_grpo import COMPARED, MODULES, _jax_flow_eps, _random_tree, _tiny_overrides
    from vla_rft_tpu.config import vla_rft_default_config as j_default_config
    from vla_rft_tpu.models.factory import build_models as j_build_models, init_params
    from vla_rft_tpu.parallel.mesh import MeshConfig, make_mesh
    from vla_rft_tpu.trainer.grpo_trainer import VLARFTGRPOTrainer as JTrainer
    from vla_rft_tpu_torch.config import vla_rft_default_config
    from vla_rft_tpu_torch.convert import flax_to_torch
    from vla_rft_tpu_torch.trainer.grpo_trainer import VLARFTGRPOTrainer as TTrainer
    from vla_rft_tpu_torch.trainer.main_vla_rft_grpo import build_rlds_datasets
    from vla_rft_tpu_torch.workers import flow_actor as t_fa

    data_dir = _tiny_records(tmp_path)
    argv = _tiny_overrides(tmp_path / "j") + [f"data.video.dataset_path={data_dir}",
                                              "data.val_fraction=0.5"]
    t_cfg = vla_rft_default_config().apply_overrides(argv)
    t_ds, _ = build_rlds_datasets(t_cfg, "tiny", TOK)
    j_ds = _reference_dataset(t_cfg)
    batch = t_ds.next_batch()
    _assert_batches_equal(batch, j_ds.next_batch())

    cfg = j_default_config().apply_overrides(argv)
    cfg.mesh = {"dp": 1, "fsdp": 1, "tp": 1, "sp": 1}
    bundle = j_build_models(cfg, preset="tiny")
    shapes = jax.eval_shape(lambda key: init_params(bundle, key), jax.random.key(0))
    params = {m: _random_tree(shapes[m], i, 0.1 if m in ("wm", "tokenizer", "lpips") else 0.05)
              for i, m in enumerate(MODULES)}
    lins = params["lpips"]["params"]
    for name in [k for k in lins if k.startswith("lin")]:
        lins[name]["kernel"] = np.abs(lins[name]["kernel"])
    jt = JTrainer(cfg, preset="tiny", mesh=make_mesh(MeshConfig(dp=1), devices=jax.devices()[:1]),
                  params=params, dataset=j_ds)
    key = jax.random.key(11)
    r_noise, r_roll, _, _, _ = jax.random.split(key, 5)
    n = cfg.actor_rollout_ref.rollout.n
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    hidden = jnp.repeat(jt._encode(jt.params["vla"], {
        "input_ids": jb["input_ids"], "attention_mask": jb["attention_mask"],
        "labels": jb["labels"], "pixels": jb["pixel_values"]}), n, axis=0)
    gt_rep = jnp.repeat(jb["actions"], n, axis=0)
    noise = jt._sample_noisy(r_noise, gt_rep)
    rollout = jt._rollout(jt.params["expert"], r_roll, hidden, noise["noise"],
                          jnp.repeat(jb["proprio"], n, axis=0))
    j_metrics = jt.training_step(batch, key)
    eps = _jax_flow_eps(r_roll, jt.bundle.expert_cfg.num_flow_steps, gt_rep.shape)

    tr = TTrainer(t_cfg, preset="tiny", device="cpu", dataset=t_ds,
                  params={m: flax_to_torch(params[m], m) for m in MODULES})
    before = {k: v.clone() for k, v in tr.bundle.expert.state_dict().items()}
    bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    pinned = {"noise": {k: bf(v) for k, v in noise.items()}, "flow_eps": torch.from_numpy(eps),
              "rollout": {k: bf(v) for k, v in rollout.items()}}
    metrics = tr.training_step(batch, step=1, pinned=pinned)
    for k in COMPARED:
        got, ref = metrics[k], float(j_metrics[k])
        assert abs(got - ref) <= 1e-3 * abs(ref) + 1e-5, (k, got, ref)
    ref = flax_to_torch(jax.tree_util.tree_map(np.asarray, jt.params["expert"]), "expert")
    far, total = 0, 0
    for k, v in tr.bundle.expert.state_dict().items():
        d = np.abs((v - before[k]).numpy() - (ref[k].numpy() - before[k].numpy()))
        assert d.max() <= 2 * (2e-4 if k.startswith("sigma_net.") else 1e-4) + 1e-5, k
        far += int((d > 1e-5).sum())
        total += d.size
    assert far / total <= 5e-3, far / total


if __name__ == "__main__" and "--write-fixture" in sys.argv:
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        write_fixture(FIXTURE, pathlib.Path(tmp))
    print(f"wrote {FIXTURE}")
