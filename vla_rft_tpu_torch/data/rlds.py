"""RLDS (LIBERO) dataset pipeline (port of vla_rft_tpu/data/rlds.py).

Episodes are tf.train.Example records in TFRecord shards (the TFDS RLDS
layout of modified_libero_rlds; every feature key is configurable).  Record
framing is `data/tfrecord.py` (native scanner), the Example is parsed by
`data/example_proto.py` (no TensorFlow, no protobuf), JPEG frames are decoded
by `data/image_ops.py` (Pillow's libjpeg-turbo, threaded) and other image formats by
Pillow; windows, shuffling and the batch transform are numpy.  For the same
records, seed, process and step a batch equals the reference's bit for bit
(tests/test_torch_rlds.py).

Sampling mirrors the reference's dlimp interleave + shuffle (prismatic's
datasets.py:128-219):

* `_EpisodeStream`: an infinite, position-tracked episode iterator over a
  subset of the shards (a per-epoch shuffle of the file order, resumable
  from (epoch, file, episode) counters without decoding the skipped
  episodes);
* K streams over disjoint shard subsets are drained round-robin into a
  reservoir of `shuffle_buffer_size` windows, never filled past one cycle
  of the data; each draw replaces its slot with the next window.  Windows
  are numpy views into their episode's arrays;
* a held-out validation split (`split="val"`): whole shards when there are
  several, every Nth episode of a single shard;
* statistics from the first 4 shards, before the split, on every process.

All randomness derives from (seed, process index, counter) tuples, so the
stream resumes exactly and every process draws its own data.  The process
index and count are torch.distributed's rank and world size when it is
initialised, else (0, 1).
"""
from __future__ import annotations

import dataclasses
import glob
import io
import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from vla_rft_tpu_torch.data.example_proto import BYTES, FLOAT, parse_example, serialize_example
from vla_rft_tpu_torch.data.image_ops import (decode_jpeg_batch, is_jpeg, jpeg_dims,
                                              resize_bilinear_batch)
from vla_rft_tpu_torch.data.prompting import build_vla_sample, pad_collate
from vla_rft_tpu_torch.data.tfrecord import read_records


@dataclasses.dataclass
class RLDSConfig:
    data_dir: str = ""
    dataset_name: str = "libero_spatial_no_noops"
    image_key: str = "steps/observation/image"
    state_key: str = "steps/observation/state"
    action_key: str = "steps/action"
    language_key: str = "steps/language_instruction"
    action_dim: int = 7
    proprio_dim: int = 8
    window_frames: int = 9  # current + 8 future obs (segment_length)
    action_chunk: int = 8  # current + 7 future actions
    policy_image_size: int = 224
    wm_image_size: int = 256
    shuffle_buffer_size: int = 10_000
    interleave_streams: int = 4
    # validation holdout: fraction of shards (episodes when single-shard)
    val_fraction: float = 0.0
    split: str = "train"  # "train" | "val"
    seed: int = 0


def _process_count_index():
    """(world size, rank) of torch.distributed when it is initialised, else
    (1, 0): the reference's jax.process_count() / process_index()."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _decode_image(b: bytes) -> np.ndarray:
    """A non-JPEG frame (PNG, GIF, BMP) as tf.io.decode_image gives it:
    (H, W, C) uint8 with the file's channels, a palette expanded."""
    try:
        from PIL import Image
    except ImportError as e:
        kind = {b"\x89PNG": "PNG", b"GIF8": "GIF"}.get(b[:4], "BMP" if b[:2] == b"BM" else
                                                         f"unknown ({b[:4]!r})")
        raise ImportError(f"decoding a {kind} frame needs Pillow, which is not installed"
                          ) from e
    with Image.open(io.BytesIO(b)) as img:
        if img.mode == "P":
            img = img.convert("RGBA" if "transparency" in img.info else "RGB")
        a = np.asarray(img)
    if a.dtype != np.uint8:
        raise ValueError(f"frame of dtype {a.dtype}: only 8-bit images are supported")
    return a[..., None] if a.ndim == 2 else a


def _decode_example(raw: bytes, cfg: RLDSConfig) -> Dict[str, Any]:
    """Parse one serialized episode tf.train.Example into numpy arrays."""
    ex = parse_example(raw)
    img_bytes = ex.bytes_list(cfg.image_key)
    dims = None
    if img_bytes and is_jpeg(img_bytes[0]):
        # every frame's SOF header (no decode): a mixed-size episode decodes
        # at the largest dims, so no frame loses information
        all_dims = [jpeg_dims(b) for b in img_bytes]
        if all(d is not None for d in all_dims):
            dims = (max(d[0] for d in all_dims), max(d[1] for d in all_dims))
    if dims is not None:
        images = list(decode_jpeg_batch(img_bytes, dims[0], dims[1]))
    else:
        images = [_decode_image(b) for b in img_bytes]
    actions = ex.float_list(cfg.action_key).reshape(-1, cfg.action_dim)
    states = ex.float_list(cfg.state_key)
    states = states.reshape(-1, cfg.proprio_dim) if states.size else None
    langs = ex.bytes_list(cfg.language_key)
    lang = langs[0].decode() if langs else ""
    return {"images": np.stack(images), "actions": actions, "states": states, "lang": lang}


def compute_dataset_statistics(actions: np.ndarray, proprio: Optional[np.ndarray]) -> Dict:
    """q01 / q99 / min / max / mean / std per dim (bounds_q99 normalisation
    reads them, and predict-time unnormalisation)."""

    def stats(x):
        return {
            "mean": x.mean(0).tolist(),
            "std": x.std(0).tolist(),
            "min": x.min(0).tolist(),
            "max": x.max(0).tolist(),
            "q01": np.quantile(x, 0.01, axis=0).tolist(),
            "q99": np.quantile(x, 0.99, axis=0).tolist(),
        }

    out = {"action": stats(actions)}
    if proprio is not None:
        out["proprio"] = stats(proprio)
    return out


def normalize_bounds_q99(x: np.ndarray, stats: Dict) -> np.ndarray:
    """BOUNDS_Q99: [q01, q99] -> [-1, 1], clipped."""
    low = np.asarray(stats["q01"])
    high = np.asarray(stats["q99"])
    x = np.clip(2 * (x - low) / (high - low + 1e-8) - 1, -1, 1)
    return x.astype(np.float32)


def augment_image(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Policy-image augmentation (image_aug): a random resized crop (scale
    0.9-1.0) back to the image's size, then brightness / contrast jitter."""
    h, w = img.shape[:2]
    scale = rng.uniform(0.9, 1.0)
    ch, cw = int(h * scale), int(w * scale)
    y0 = rng.integers(0, h - ch + 1)
    x0 = rng.integers(0, w - cw + 1)
    img = img[y0 : y0 + ch, x0 : x0 + cw]
    img = _resize(img, h)
    x = img.astype(np.float32)
    x = x * rng.uniform(0.9, 1.1) + rng.uniform(-0.1, 0.1) * 255.0
    return np.clip(x, 0, 255).astype(img.dtype)


def _resize(img: np.ndarray, size: int) -> np.ndarray:
    """Bilinear square resize (image_ops.resize_bilinear_batch)."""
    if img.shape[:2] == (size, size):
        return img
    return resize_bilinear_batch(img[None], size, size)[0]


def _resize_frames(frames: np.ndarray, size: int) -> np.ndarray:
    if frames.shape[1:3] == (size, size):
        return frames
    return resize_bilinear_batch(frames, size, size)


class _EpisodeStream:
    """Infinite episode iterator over `files`, shuffling the file order each
    epoch with a generator seeded (*seed, epoch).  Its position (epoch,
    file_i, ep_i) resumes by skipping ep_i records of the current file
    without decoding them."""

    def __init__(self, files: List[str], cfg: RLDSConfig, seed: tuple,
                 ep_filter: Optional[Callable[[int], bool]] = None):
        self.files = files
        self.cfg = cfg
        self.seed = seed
        self.ep_filter = ep_filter
        self.epoch = 0
        self.file_i = 0
        self.ep_i = 0
        self._rec_iter = None
        # a per-dataset standardisation (data/oxe.py's mixture components set
        # it), identity otherwise
        self.episode_transform: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None

    def _file_order(self) -> np.ndarray:
        order = np.arange(len(self.files))
        np.random.default_rng((*self.seed, self.epoch)).shuffle(order)
        return order

    def next_episode(self) -> Dict[str, Any]:
        while True:
            if self._rec_iter is None:
                path = self.files[self._file_order()[self.file_i]]
                self._rec_iter = read_records(path)
                for _ in range(self.ep_i):  # fast-forward after a resume
                    next(self._rec_iter, None)
            raw = next(self._rec_iter, None)
            if raw is None:
                self._rec_iter = None
                self.ep_i = 0
                self.file_i += 1
                if self.file_i >= len(self.files):
                    self.file_i = 0
                    self.epoch += 1
                continue
            idx = self.ep_i
            self.ep_i += 1
            if self.ep_filter is not None and not self.ep_filter(idx):
                continue
            ep = _decode_example(raw, self.cfg)
            if self.episode_transform is not None:
                ep = self.episode_transform(ep)
            return ep

    def state_dict(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "file_i": self.file_i, "ep_i": self.ep_i}

    def load_state_dict(self, state) -> None:
        self.epoch = int(state["epoch"])
        self.file_i = int(state["file_i"])
        self.ep_i = int(state["ep_i"])
        self._rec_iter = None


class RLDSDataset:
    """Interleaved, reservoir-shuffled windows of episodes -> batches with
    the RFT trainer's fields: pixel_values (B, 224, 224, 6), proprio,
    input_ids / attention_mask / labels, actions (the normalised chunk),
    raw_pixel_values (B, 9, 256, 256, 3) (sizes from the config)."""

    def __init__(self, cfg: RLDSConfig, tokenizer, batch_size: int, max_seq_len: int = 96,
                 pad_token_id: int = 151643, stats: Optional[Dict] = None,
                 image_aug: bool = False):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.max_seq_len = max_seq_len
        self.pad_token_id = pad_token_id
        self.image_aug = image_aug
        self._step = 0

        pattern = os.path.join(cfg.data_dir, cfg.dataset_name, "*.tfrecord*")
        all_files = sorted(glob.glob(pattern))
        if not all_files:
            raise FileNotFoundError(f"no tfrecords match {pattern}")
        # statistics from the same files on every process and for both
        # splits, before any split or stripe, so normalisation agrees
        self.stats = stats or self._compute_stats(all_files)

        ep_filter = None
        files = all_files
        if cfg.val_fraction > 0:
            if len(all_files) > 1:
                n_val = max(1, round(len(all_files) * cfg.val_fraction))
                n_val = min(n_val, len(all_files) - 1)
                stride = len(all_files) / n_val
                val_idx = {int(i * stride) for i in range(n_val)}
                pick = ((lambda i: i in val_idx) if cfg.split == "val"
                        else (lambda i: i not in val_idx))
                files = [f for i, f in enumerate(all_files) if pick(i)]
            else:
                # one shard: hold out every Nth episode
                mod = max(2, round(1 / cfg.val_fraction))
                if cfg.split == "val":
                    ep_filter = lambda i: i % mod == mod - 1
                else:
                    ep_filter = lambda i: i % mod != mod - 1
        elif cfg.split == "val":
            raise ValueError("split='val' requires val_fraction > 0")
        self.files = files

        # several processes: each reads its stripe of the shards; with fewer
        # shards than processes each keeps all of them and draws with its
        # own seed
        pc, self._pi = _process_count_index()
        if pc > 1 and len(self.files) >= pc:
            self.files = self.files[self._pi :: pc]

        # interleave streams over disjoint shard subsets
        k = max(1, min(cfg.interleave_streams, len(self.files)))
        self._streams = [
            _EpisodeStream(self.files[i::k], cfg, (cfg.seed, self._pi, i), ep_filter)
            for i in range(k)
        ]
        self._stream_rr = 0  # the next stream to draw an episode from
        self._window_queue: List[Dict[str, Any]] = []  # the current episode's windows
        self._buffer: List[Dict[str, Any]] = []  # the reservoir

    # ------------------------------------------------------------------ state
    def state_dict(self):
        state = {"step": self._step, "stream_rr": self._stream_rr}
        for i, s in enumerate(self._streams):
            for k, v in s.state_dict().items():
                state[f"s{i}_{k}"] = v
        return state

    def load_state_dict(self, state):
        """Restore the stream positions and the step counter.  The reservoir
        and the current episode's windows refill from the restored position
        (the stream goes on through the data rather than replaying what the
        reservoir held)."""
        self._step = int(state["step"])
        self._stream_rr = int(state.get("stream_rr", 0))
        for i, s in enumerate(self._streams):
            if f"s{i}_epoch" in state:
                s.load_state_dict({k: state[f"s{i}_{k}"] for k in ("epoch", "file_i", "ep_i")})
        self._window_queue = []
        self._buffer = []

    # ------------------------------------------------------------------ stats
    def _compute_stats(self, files: List[str]) -> Dict:
        acts, props = [], []
        for f in files[:4]:  # a few shards, in the global pre-split order
            for raw in read_records(f):
                ep = _decode_example(raw, self.cfg)
                acts.append(ep["actions"])
                if ep["states"] is not None:
                    props.append(ep["states"])
        actions = np.concatenate(acts, 0)
        proprio = np.concatenate(props, 0) if props else None
        return compute_dataset_statistics(actions, proprio)

    def save_dataset_statistics(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.stats, f)

    # ---------------------------------------------------------------- windows
    def _episode_windows(self, ep: Dict[str, Any]) -> List[Dict[str, Any]]:
        F = self.cfg.window_frames
        C = self.cfg.action_chunk
        T = len(ep["images"])
        out = []
        for t in range(T - F + 1):
            out.append({  # views into the episode's arrays
                "frames": ep["images"][t : t + F],
                "actions": ep["actions"][t : t + C],
                "proprio": (ep["states"][t] if ep["states"] is not None
                            else np.zeros(self.cfg.proprio_dim, np.float32)),
                "lang": ep["lang"],
            })
        return out

    def _next_window(self) -> Dict[str, Any]:
        """The next window of the round-robin episode interleave."""
        while not self._window_queue:
            s = self._streams[self._stream_rr % len(self._streams)]
            self._stream_rr += 1
            self._window_queue = self._episode_windows(s.next_episode())
        return self._window_queue.pop(0)

    def _fill_buffer(self) -> None:
        """Fill the reservoir up to shuffle_buffer_size windows, but not past
        one cycle of the data: once every stream has finished an epoch the
        buffer holds the whole dataset, and more would be duplicates."""
        target = max(1, self.cfg.shuffle_buffer_size)
        while len(self._buffer) < target:
            self._buffer.append(self._next_window())
            if all(s.epoch >= 1 for s in self._streams):
                break

    # ----------------------------------------------------------------- batches
    def draw_windows(self, n: int, rng: np.random.Generator) -> List[Dict[str, Any]]:
        """n reservoir-shuffled windows, each tagged with this dataset's
        normalisation statistics (a mixture's components normalise each
        with its own)."""
        self._fill_buffer()
        out = []
        for _ in range(n):
            idx = int(rng.integers(len(self._buffer)))
            w = self._buffer[idx]
            self._buffer[idx] = self._next_window()
            out.append({**w, "stats": self.stats})
        return out

    def next_batch(self) -> Dict[str, np.ndarray]:
        self._step += 1
        cfg = self.cfg
        # the batch's randomness (draws, augmentation) from (seed, process,
        # step): resumable, and distinct per process
        rng = np.random.default_rng((cfg.seed, self._pi, self._step))
        windows = self.draw_windows(self.batch_size, rng)
        return assemble_vla_batch(
            windows, self.tokenizer, cfg, rng,
            pad_token_id=self.pad_token_id, max_seq_len=self.max_seq_len,
            image_aug=self.image_aug,
        )


def assemble_vla_batch(windows: List[Dict[str, Any]], tokenizer, cfg: RLDSConfig,
                       rng: np.random.Generator, pad_token_id: int = 151643,
                       max_seq_len: int = 96, image_aug: bool = False) -> Dict[str, np.ndarray]:
    """Windows (each with its normalisation statistics) -> a trainer batch;
    the single-dataset and the weighted-mixture paths share it."""
    samples, metas = [], []
    for w in windows:
        actions = normalize_bounds_q99(w["actions"], w["stats"]["action"])
        samples.append(build_vla_sample(tokenizer, w["lang"], actions))
        metas.append((w, actions))
    coll = pad_collate(samples, pad_token_id, max_seq_len)

    pix, raw, prop, acts = [], [], [], []
    for w, actions in metas:
        frame0 = w["frames"][0]
        if image_aug:
            frame0 = augment_image(frame0, rng)
        img = _resize(frame0, cfg.policy_image_size).astype(np.float32) / 255.0
        pix.append(np.concatenate([img, img], axis=-1))  # the dino | siglip stack
        raw.append(_resize_frames(w["frames"], cfg.wm_image_size))
        prop.append(normalize_bounds_q99(w["proprio"], w["stats"]["proprio"])
                    if "proprio" in w["stats"] else w["proprio"])
        acts.append(actions)
    return {
        "pixel_values": np.stack(pix).astype(np.float32),
        "raw_pixel_values": np.stack(raw).astype(np.uint8),
        "proprio": np.stack(prop).astype(np.float32),
        "actions": np.stack(acts).astype(np.float32),
        **coll,
        "input_ids": coll["input_ids"].astype(np.int32),
        "attention_mask": coll["attention_mask"].astype(np.int32),
        "labels": coll["labels"].astype(np.int32),
    }


def make_episode_example(images: Sequence[bytes], actions: np.ndarray, states: np.ndarray,
                         lang: str, cfg: RLDSConfig) -> bytes:
    """Serialize one episode in the layout _decode_example reads (tests and
    dataset conversion write with it)."""
    return serialize_example({
        cfg.image_key: (BYTES, list(images)),
        cfg.action_key: (FLOAT, np.asarray(actions, np.float32).reshape(-1)),
        cfg.state_key: (FLOAT, np.asarray(states, np.float32).reshape(-1)),
        cfg.language_key: (BYTES, [lang.encode()]),
    })
