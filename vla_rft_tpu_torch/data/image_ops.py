"""Image ops of the RLDS data path (port of vla_rft_tpu/data/image_ops.py):
JPEG decode, bilinear resize, crop / resize / flip.

JPEG frames decode through Pillow's bundled libjpeg-turbo with its defaults
(the islow IDCT, fancy upsampling), which gives the reference's libjpeg
pixels bit for bit (tests/test_torch_rlds.py; on the card's machine, which
has Pillow and no libjpeg headers, too: PERF.md §6).  The pixel work is
native, as in the reference: `csrc/image_ops.cc` (the root csrc's resize and
crop, copied: bilinear with half-pixel centres and no antialias, threaded)
built at first use by `ops/cuda_build.py` does every resize.  A frame that
does not decode raises.  The numpy resize below is the twin of the
library's for the tests; nothing falls back to it.
"""
from __future__ import annotations

import ctypes
import io
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np

from vla_rft_tpu_torch.ops import cuda_build

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int)
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = cuda_build.load("image_ops")
        lib.crop_resize_flip_batch.restype = None
        lib.crop_resize_flip_batch.argtypes = [
            _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _i32p, _i32p, _i32p, _i32p,
            _u8p, _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        _lib = lib
    return _lib


def is_jpeg(b: bytes) -> bool:
    return b[:3] == b"\xff\xd8\xff"


def jpeg_dims(b: bytes) -> Optional[tuple]:
    """(h, w) from the JPEG SOF header, no decode."""
    i = 2
    n = len(b)
    while i + 9 < n:
        if b[i] != 0xFF:
            i += 1
            continue
        marker = b[i + 1]
        if marker in (0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
            return (b[i + 5] << 8 | b[i + 6], b[i + 7] << 8 | b[i + 8])
        if marker == 0xD8 or marker == 0x01 or 0xD0 <= marker <= 0xD7:
            i += 2
            continue
        i += 2 + (b[i + 2] << 8 | b[i + 3])
    return None


def _decode_frames(encoded: Sequence[bytes], out_h: int, out_w: int, threads: int,
                   resize: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
    from PIL import Image

    def one(b: bytes) -> np.ndarray:
        with Image.open(io.BytesIO(b)) as img:
            if img.format != "JPEG":
                raise ValueError(f"not a JPEG frame ({img.format})")
            a = np.asarray(img.convert("RGB"), np.uint8)
        return a if a.shape[:2] == (out_h, out_w) else resize(a)

    out = np.zeros((len(encoded), out_h, out_w, 3), np.uint8)
    if not encoded:
        return out
    with ThreadPoolExecutor(max(1, min(threads, len(encoded)))) as pool:
        for i, a in enumerate(pool.map(one, encoded)):  # raises a frame's error
            out[i] = a
    return out


def decode_jpeg_batch(encoded: Sequence[bytes], out_h: int, out_w: int,
                      threads: int = 8) -> np.ndarray:
    """JPEG bytes -> (n, out_h, out_w, 3) uint8, each frame resized
    (bilinear, the library's) when its size differs.  Raises if a frame
    does not decode."""
    return _decode_frames(encoded, out_h, out_w, threads,
                          lambda a: resize_bilinear_batch(a[None], out_h, out_w)[0])


def resize_bilinear_batch(images: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(n, h, w, 3) uint8 -> (n, out_h, out_w, 3) uint8, bilinear with
    half-pixel centres and no antialias (the whole image as the crop)."""
    images = np.ascontiguousarray(images, np.uint8)
    n, h, w, _ = images.shape
    if (h, w) == (out_h, out_w):
        return images
    zeros = np.zeros(n, np.int32)
    return crop_resize_flip_batch(
        images, zeros, zeros, np.full(n, h, np.int32), np.full(n, w, np.int32),
        np.zeros(n, np.uint8), out_h, out_w,
    )


def crop_resize_flip_batch(images: np.ndarray, y0: np.ndarray, x0: np.ndarray,
                           ch: np.ndarray, cw: np.ndarray, flip: np.ndarray,
                           out_h: int, out_w: int, threads: int = 8) -> np.ndarray:
    """Crop box i (y0, x0, ch, cw) of image i, resize it to (out_h, out_w),
    flip it left-right where flip[i]: the caller draws the boxes, so the
    randomness stays in numpy."""
    images = np.ascontiguousarray(images, np.uint8)
    n, h, w, c = images.shape
    if c != 3:
        raise ValueError(f"crop_resize_flip_batch takes RGB images, got {c} channels")
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    ints = [np.ascontiguousarray(a, np.int32) for a in (y0, x0, ch, cw)]
    if any(a.shape != (n,) for a in ints) or np.shape(flip) != (n,):
        raise ValueError("crop_resize_flip_batch: one box and one flip flag per image")
    flipc = np.ascontiguousarray(flip, np.uint8)
    _load().crop_resize_flip_batch(
        images.ctypes.data_as(_u8p), n, h, w, *(a.ctypes.data_as(_i32p) for a in ints),
        flipc.ctypes.data_as(_u8p), out.ctypes.data_as(_u8p), out_h, out_w, threads,
    )
    return out


# ---------------------------------------------------------- the plain twin
def resize_bilinear_plain(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """The library's resize_bilinear in numpy float32, operation for
    operation (so bit-equal): source position (i + 0.5) * scale - 0.5,
    truncated and clamped to the image, weights clamped to [0, 1], the
    horizontal pair blended, then the vertical, + 0.5, truncated."""
    sh, sw = img.shape[:2]
    f32 = np.float32

    def axis(d, s):
        scale = f32(s) / f32(d)
        pos = (np.arange(d, dtype=f32) + f32(0.5)) * scale - f32(0.5)
        i0 = np.clip(pos.astype(np.int32), 0, s - 1)  # C's truncation toward 0
        i1 = np.minimum(s - 1, i0 + 1)
        wgt = np.clip(pos - i0.astype(f32), f32(0), f32(1))
        return i0, i1, wgt

    y0, y1, wy = axis(dh, sh)
    x0, x1, wx = axis(dw, sw)
    src = img.astype(f32)
    wx_, wy_ = wx[None, :, None], wy[:, None, None]
    a = src[y0][:, x0] * (f32(1) - wx_) + src[y0][:, x1] * wx_
    b = src[y1][:, x0] * (f32(1) - wx_) + src[y1][:, x1] * wx_
    return (a * (f32(1) - wy_) + b * wy_ + f32(0.5)).astype(np.uint8)


def crop_resize_flip_plain(images: np.ndarray, y0, x0, ch, cw, flip, out_h: int,
                           out_w: int) -> np.ndarray:
    """The library's crop_resize_flip_batch in numpy: the box clamped to the
    image as the library clamps it."""
    n, h, w, _ = images.shape
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    for i in range(n):
        cy = max(0, min(h - 1, int(y0[i])))
        cx = max(0, min(w - 1, int(x0[i])))
        chh = max(1, min(h - cy, int(ch[i])))
        cww = max(1, min(w - cx, int(cw[i])))
        r = resize_bilinear_plain(images[i, cy:cy + chh, cx:cx + cww], out_h, out_w)
        out[i] = r[:, ::-1] if flip[i] else r
    return out


def decode_jpeg_plain(encoded: Sequence[bytes], out_h: int, out_w: int) -> np.ndarray:
    """Twin of decode_jpeg_batch: the same decode, then the numpy resize."""
    return _decode_frames(encoded, out_h, out_w, 1,
                          lambda a: resize_bilinear_plain(a, out_h, out_w))
