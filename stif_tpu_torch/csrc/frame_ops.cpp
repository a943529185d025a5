// frame_ops: host-side frame kernels of the data and eval pipelines.
//
// The port's own copy of native/frame_ops.cpp: MATLAB-convention bicubic
// resize (the resampler of the reference's codes/data/util.py:240-371, which
// defines the LR degradation model), uint8 BGR -> float32 RGB, crop, and a
// fused crop + convert + downscale, each split over threads by rows.
//
// The threads are std::threads, not OpenMP: a compiler without an OpenMP
// runtime builds the same parallel library. Their number is
// OMP_NUM_THREADS when set (as an OpenMP build would read it), else the
// host's hardware threads.
//
// A plain C ABI, loaded with ctypes. Built at first use by
// stif_tpu_torch/ops/cuda_build.py (g++ -O3 -fPIC -shared -pthread
// -std=c++17) into stif_tpu_torch/_build/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int max_threads() {
  const char* env = std::getenv("OMP_NUM_THREADS");
  if (env != nullptr) {
    int n = std::atoi(env);
    if (n > 0) return n;
  }
  unsigned hw = std::thread::hardware_concurrency();
  return hw > 0 ? static_cast<int>(hw) : 1;
}

// body(i) for i in [0, n), in contiguous blocks, one per thread (the
// calling thread takes the first).
template <typename Body>
void parallel_for(int n, const Body& body) {
  int nt = std::min(max_threads(), n);
  if (nt <= 1) {
    for (int i = 0; i < n; ++i) body(i);
    return;
  }
  auto block = [&](int t) {
    int lo = static_cast<int>(static_cast<long>(n) * t / nt);
    int hi = static_cast<int>(static_cast<long>(n) * (t + 1) / nt);
    for (int i = lo; i < hi; ++i) body(i);
  };
  std::vector<std::thread> pool;
  pool.reserve(nt - 1);
  for (int t = 1; t < nt; ++t) pool.emplace_back(block, t);
  block(0);
  for (auto& th : pool) th.join();
}

// Keys cubic kernel, a = -0.5 (MATLAB 'cubic').
inline double cubic(double x) {
  double ax = std::fabs(x);
  double ax2 = ax * ax;
  double ax3 = ax2 * ax;
  if (ax <= 1.0) return 1.5 * ax3 - 2.5 * ax2 + 1.0;
  if (ax <= 2.0) return -0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0;
  return 0.0;
}

// MATLAB imresize weight/index plan for one axis (antialiasing on).
// Mirrors calculate_weights_indices (data/util.py:248-300) with the
// symmetric boundary fold applied directly to source indices.
struct ResamplePlan {
  int out_length;
  int taps;
  std::vector<float> weights;  // out_length * taps
  std::vector<int> indices;    // out_length * taps (folded into [0, in))
};

ResamplePlan make_plan(int in_length, int out_length, double scale,
                       bool antialiasing) {
  double kernel_width = 4.0;
  if (scale < 1.0 && antialiasing) kernel_width /= scale;
  int P = static_cast<int>(std::ceil(kernel_width)) + 2;

  std::vector<double> w(static_cast<size_t>(out_length) * P);
  std::vector<long> idx(static_cast<size_t>(out_length) * P);
  std::vector<char> col_zero(P, 1);
  for (int i = 0; i < out_length; ++i) {
    double x = i + 1.0;
    double u = x / scale + 0.5 * (1.0 - 1.0 / scale);
    double left = std::floor(u - kernel_width / 2.0);
    double rowsum = 0.0;
    for (int k = 0; k < P; ++k) {
      double pos = left + k;
      double d = u - pos;
      double wk = (scale < 1.0 && antialiasing) ? scale * cubic(d * scale)
                                                : cubic(d);
      w[i * P + k] = wk;
      idx[i * P + k] = static_cast<long>(pos);
      rowsum += wk;
    }
    for (int k = 0; k < P; ++k) {
      w[i * P + k] /= rowsum;
      if (w[i * P + k] != 0.0) col_zero[k] = 0;
    }
  }
  int lo = 0, taps = P;
  if (col_zero[0]) { lo = 1; taps = P - 2; }
  else if (col_zero[P - 1]) { taps = P - 2; }

  ResamplePlan plan;
  plan.out_length = out_length;
  plan.taps = taps;
  plan.weights.resize(static_cast<size_t>(out_length) * taps);
  plan.indices.resize(static_cast<size_t>(out_length) * taps);
  for (int i = 0; i < out_length; ++i) {
    for (int k = 0; k < taps; ++k) {
      long p = idx[i * P + lo + k] - 1;  // 0-based source index
      // symmetric fold into [0, in_length)
      while (p < 0 || p >= in_length) {
        if (p < 0) p = -p - 1;
        if (p >= in_length) p = 2L * in_length - 1 - p;
      }
      plan.indices[i * static_cast<size_t>(taps) + k] = static_cast<int>(p);
      plan.weights[i * static_cast<size_t>(taps) + k] =
          static_cast<float>(w[i * P + lo + k]);
    }
  }
  return plan;
}

}  // namespace

extern "C" {

// Output dims for a MATLAB resize.
void stif_resize_dims(int in_h, int in_w, double scale, int* out_h,
                      int* out_w) {
  *out_h = static_cast<int>(std::ceil(in_h * scale));
  *out_w = static_cast<int>(std::ceil(in_w * scale));
}

// MATLAB-convention bicubic resize, float32 HWC.
// src: (h, w, c); dst: (ceil(h*scale), ceil(w*scale), c).
void stif_imresize_f32(const float* src, int h, int w, int c, double scale,
                       float* dst) {
  int oh, ow;
  stif_resize_dims(h, w, scale, &oh, &ow);
  ResamplePlan ph = make_plan(h, oh, scale, true);
  ResamplePlan pw = make_plan(w, ow, scale, true);

  // Output row i needs row i of the row pass (h -> oh) and nothing else,
  // so one thread does both passes of a row while that row is in cache.
  std::vector<float> tmp(static_cast<size_t>(oh) * w * c);
  parallel_for(oh, [&](int i) {
    // pass 1: rows (h -> oh), width unchanged
    const float* wr_h = &ph.weights[i * static_cast<size_t>(ph.taps)];
    const int* ir_h = &ph.indices[i * static_cast<size_t>(ph.taps)];
    float* tmp_row = &tmp[static_cast<size_t>(i) * w * c];
    std::memset(tmp_row, 0, sizeof(float) * w * c);
    for (int k = 0; k < ph.taps; ++k) {
      const float* src_row = src + static_cast<size_t>(ir_h[k]) * w * c;
      float wk = wr_h[k];
      for (int j = 0; j < w * c; ++j) tmp_row[j] += wk * src_row[j];
    }
    // pass 2: cols (w -> ow)
    const float* in_row = tmp_row;
    float* out_row = dst + static_cast<size_t>(i) * ow * c;
    for (int j = 0; j < ow; ++j) {
      const float* wr = &pw.weights[j * static_cast<size_t>(pw.taps)];
      const int* ir = &pw.indices[j * static_cast<size_t>(pw.taps)];
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0.f;
        for (int k = 0; k < pw.taps; ++k)
          acc += wr[k] * in_row[ir[k] * c + ch];
        out_row[j * c + ch] = acc;
      }
    }
  });
}

// uint8 BGR HWC -> float32 RGB HWC in [0, 1].
void stif_bgr_u8_to_rgb_f32(const uint8_t* src, int n_pixels, float* dst) {
  const float inv = 1.0f / 255.0f;
  parallel_for(n_pixels, [&](int i) {
    dst[i * 3 + 0] = src[i * 3 + 2] * inv;
    dst[i * 3 + 1] = src[i * 3 + 1] * inv;
    dst[i * 3 + 2] = src[i * 3 + 0] * inv;
  });
}

// Crop (y0, x0, ch, cw) from (h, w, c) float32 HWC.
void stif_crop_f32(const float* src, int h, int w, int c, int y0, int x0,
                   int ch_, int cw, float* dst) {
  (void)h;
  parallel_for(ch_, [&](int i) {
    std::memcpy(dst + static_cast<size_t>(i) * cw * c,
                src + (static_cast<size_t>(y0 + i) * w + x0) * c,
                sizeof(float) * cw * c);
  });
}

// Fused degradation: uint8 BGR frame -> crop -> RGB float -> bicubic down.
// The collate hot path (codes/data/__init__.py:124-154) in one call.
void stif_degrade_u8(const uint8_t* src, int h, int w, int y0, int x0,
                     int crop, double scale, float* dst) {
  std::vector<float> rgb(static_cast<size_t>(crop) * crop * 3);
  parallel_for(crop, [&](int i) {
    for (int j = 0; j < crop; ++j) {
      const uint8_t* p = src + ((static_cast<size_t>(y0 + i)) * w + x0 + j) * 3;
      float* q = &rgb[(static_cast<size_t>(i) * crop + j) * 3];
      q[0] = p[2] / 255.0f;
      q[1] = p[1] / 255.0f;
      q[2] = p[0] / 255.0f;
    }
  });
  stif_imresize_f32(rgb.data(), crop, crop, 3, scale, dst);
}

int stif_num_threads() { return max_threads(); }

}  // extern "C"
