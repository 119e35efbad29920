// Native image ops for the RLDS data path: multi-threaded bilinear resize +
// crop/flip, exposed via ctypes (vla_rft_tpu_torch/data/image_ops.py).  The
// resize and crop of the root csrc/image_ops.cc, copied; the JPEG decode is
// Pillow's libjpeg-turbo (image_ops.py), so the library links no libjpeg.
//
// Role: the reference's data pipeline leans on TensorFlow's native image ops
// (prismatic/vla/datasets/datasets.py:206 tf.io.decode_image + dlimp
// augmentations).  This module is the first-party replacement so the loader
// doesn't need TF at all: Python supplies parameters (crop boxes, flip
// flags — keeping RNG/policy in one place), C++ does the pixel work without
// the GIL.
//
// Build: vla_rft_tpu_torch/ops/cuda_build.py at first use

#include <cstddef>
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

// Bilinear resize (RGB u8, half-pixel centers — matches PIL/TF 'bilinear').
void resize_bilinear(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                     int dw) {
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = std::max(0, std::min(sh - 1, static_cast<int>(fy)));
    int y1 = std::min(sh - 1, y0 + 1);
    float wy = std::max(0.0f, std::min(1.0f, fy - y0));
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = std::max(0, std::min(sw - 1, static_cast<int>(fx)));
      int x1 = std::min(sw - 1, x0 + 1);
      float wx = std::max(0.0f, std::min(1.0f, fx - x0));
      for (int c = 0; c < 3; ++c) {
        float a = src[(y0 * sw + x0) * 3 + c] * (1 - wx) +
                  src[(y0 * sw + x1) * 3 + c] * wx;
        float b = src[(y1 * sw + x0) * 3 + c] * (1 - wx) +
                  src[(y1 * sw + x1) * 3 + c] * wx;
        dst[(y * dw + x) * 3 + c] =
            static_cast<uint8_t>(a * (1 - wy) + b * wy + 0.5f);
      }
    }
  }
}

void parallel_for(int n, int threads, const std::function<void(int)>& fn) {
  if (threads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> pool;
  std::atomic<int> next{0};
  int nt = std::min(threads, n);
  for (int t = 0; t < nt; ++t) {
    pool.emplace_back([&] {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Random-resized-crop + optional horizontal flip, batched: for image i,
// crop box (y0[i], x0[i], ch[i], cw[i]) from (h, w), resize to (out_h,
// out_w), flip if flip[i].  src: (n, h, w, 3) u8 contiguous.
void crop_resize_flip_batch(const uint8_t* src, int n, int h, int w,
                            const int* y0, const int* x0, const int* ch,
                            const int* cw, const uint8_t* flip, uint8_t* out,
                            int out_h, int out_w, int threads) {
  parallel_for(n, threads, [&](int i) {
    const uint8_t* im = src + static_cast<size_t>(i) * h * w * 3;
    uint8_t* dst = out + static_cast<size_t>(i) * out_h * out_w * 3;
    // gather the crop into a contiguous buffer, then resize
    int cy = std::max(0, std::min(h - 1, y0[i]));
    int cx = std::max(0, std::min(w - 1, x0[i]));
    int chh = std::max(1, std::min(h - cy, ch[i]));
    int cww = std::max(1, std::min(w - cx, cw[i]));
    std::vector<uint8_t> crop(static_cast<size_t>(chh) * cww * 3);
    for (int y = 0; y < chh; ++y) {
      std::memcpy(crop.data() + static_cast<size_t>(y) * cww * 3,
                  im + (static_cast<size_t>(cy + y) * w + cx) * 3,
                  static_cast<size_t>(cww) * 3);
    }
    resize_bilinear(crop.data(), chh, cww, dst, out_h, out_w);
    if (flip[i]) {
      for (int y = 0; y < out_h; ++y) {
        uint8_t* row = dst + static_cast<size_t>(y) * out_w * 3;
        for (int x = 0; x < out_w / 2; ++x) {
          for (int c = 0; c < 3; ++c)
            std::swap(row[x * 3 + c], row[(out_w - 1 - x) * 3 + c]);
        }
      }
    }
  });
}

}  // extern "C"
