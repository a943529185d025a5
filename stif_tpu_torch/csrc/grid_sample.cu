// Channels-last grid_sample for Hopper (sm_90a): a gather of an NHWC source
// at a grid of points, written channels-last, CUDA C++ with a plain C entry.
//
// Replaces no Pallas kernel: the JAX package writes this gather in XLA
// (stif_tpu/ops/grid_sample.py). It takes the place of F.grid_sample on the
// channels-first view of the source followed by the strided copy that turns
// its (B, C, Q, 1) result into the (B, Q, C) rows the SIREN kernel reads:
// the decoder gathers every field at every output pixel and time (7.9 M
// queries of 198 channels in a x4 window of 8 frames at 720p), so that pair
// wrote each gathered field, read it and wrote it again.
//
// What bounds it on an H100: the bytes it writes. Each output row is written
// once (C floats per query); its sources are small beside it (a 192x320x198
// LR field is 49 MB against 6.2 GB of output at 7.9 M queries), and
// neighbouring queries read the same corners, so the corner reads are
// mostly L1 and L2 hits. Design:
//  * one query is served by a group of lanes (a power of two up to 32) across
//    its channels, each lane moving 16-, 8- or 4-byte vectors; the wrapper
//    picks the vector width from the source's and output's alignment and
//    strides and the group from the number of vectors per row;
//  * every lane of a group reads the query's grid point (one broadcast
//    load) and computes its corner indices and weights once;
//  * a group's stores are one contiguous run of its output row, and
//    consecutive groups own consecutive rows: coalesced channels-last stores;
//  * 256-thread blocks of small register footprint keep many queries' four
//    corner loads in flight per SM.
//
// The arithmetic is ATen's grid_sampler_2d_kernel (ATen/native/cuda/
// GridSampler.cu, GridSampler.cuh): grid_sampler_compute_source_index, floor
// corners, the weights nw, ne, sw, se as products of the same differences,
// the corners added in that order with out-of-bounds corners skipped under
// zero padding, nearest by nearbyint (half to even). Contractions are
// written out as ATen's compiler makes them: the unnormalisation
// (coord + 1) * size - 1 and each corner's accumulation are fused
// multiply-adds. The source is any view with unit channel stride and any
// batch, row and pixel strides (0 included): a channel slice or a batch
// broadcast is read in place.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;

struct Params {
  const float* src;
  long long s_n, s_h, s_w;  // element strides of the NHWC source
  int h, w, c;
  const float* grid;
  long long g_n, g_q, g_c;  // element strides of the (N, Q, 2) grid
  long long q;              // queries per batch item
  float* out;               // (N, Q, C), contiguous
  int border, align, log2_group;
};

template <int V>
struct VecOf;
template <>
struct VecOf<1> {
  using T = float;
  static __device__ __forceinline__ float zero() { return 0.f; }
};
template <>
struct VecOf<2> {
  using T = float2;
  static __device__ __forceinline__ float2 zero() {
    return make_float2(0.f, 0.f);
  }
};
template <>
struct VecOf<4> {
  using T = float4;
  static __device__ __forceinline__ float4 zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
};

// ATen's grid_sampler_compute_source_index for zeros and border padding
__device__ __forceinline__ float source_index(float coord, int size,
                                              int border, int align) {
  if (align) {
    coord = ((coord + 1.f) / 2) * (size - 1);
  } else {
    coord = __fmaf_rn(coord + 1.f, (float)size, -1.f) / 2;
  }
  if (border) coord = fminf((float)(size - 1), fmaxf(coord, 0.f));
  // safe_downgrade_to_int_range
  if (coord > (float)(INT_MAX - 1) || coord < (float)INT_MIN ||
      !isfinite(coord))
    coord = -100.f;
  return coord;
}

__device__ __forceinline__ bool inside(int y, int x, int h, int w) {
  return y >= 0 && y < h && x >= 0 && x < w;
}

__device__ __forceinline__ void add(float& acc, float v, float wt) {
  acc = __fmaf_rn(v, wt, acc);
}
__device__ __forceinline__ void add(float2& acc, float2 v, float wt) {
  add(acc.x, v.x, wt);
  add(acc.y, v.y, wt);
}
__device__ __forceinline__ void add(float4& acc, float4 v, float wt) {
  add(acc.x, v.x, wt);
  add(acc.y, v.y, wt);
  add(acc.z, v.z, wt);
  add(acc.w, v.w, wt);
}

template <int V, bool kNearest>
__global__ void __launch_bounds__(kThreads)
    grid_sample_kernel(const Params p) {
  using T = typename VecOf<V>::T;
  const int group = 1 << p.log2_group;
  const long long j =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> p.log2_group;
  if (j >= p.q) return;
  const int lane = threadIdx.x & (group - 1);
  const long long n = blockIdx.y;
  const float* g = p.grid + n * p.g_n + j * p.g_q;
  const float ix = source_index(__ldg(g), p.w, p.border, p.align);
  const float iy = source_index(__ldg(g + p.g_c), p.h, p.border, p.align);
  const float* __restrict__ src = p.src + n * p.s_n;
  T* __restrict__ out = reinterpret_cast<T*>(p.out + (n * p.q + j) * p.c);
  const int nvec = p.c / V;

  if (kNearest) {
    const int xn = (int)nearbyintf(ix), yn = (int)nearbyintf(iy);
    if (inside(yn, xn, p.h, p.w)) {
      const T* s = reinterpret_cast<const T*>(src + yn * p.s_h + xn * p.s_w);
#pragma unroll 4
      for (int v = lane; v < nvec; v += group) out[v] = __ldg(s + v);
    } else {
      for (int v = lane; v < nvec; v += group) out[v] = VecOf<V>::zero();
    }
    return;
  }

  const int x0 = (int)floorf(ix), y0 = (int)floorf(iy);
  const int x1 = x0 + 1, y1 = y0 + 1;
  const float nw = (x1 - ix) * (y1 - iy);
  const float ne = (ix - x0) * (y1 - iy);
  const float sw = (x1 - ix) * (iy - y0);
  const float se = (ix - x0) * (iy - y0);
  const bool in_nw = inside(y0, x0, p.h, p.w);
  const bool in_ne = inside(y0, x1, p.h, p.w);
  const bool in_sw = inside(y1, x0, p.h, p.w);
  const bool in_se = inside(y1, x1, p.h, p.w);
  const T* c_nw = reinterpret_cast<const T*>(src + y0 * p.s_h + x0 * p.s_w);
  const T* c_ne = reinterpret_cast<const T*>(src + y0 * p.s_h + x1 * p.s_w);
  const T* c_sw = reinterpret_cast<const T*>(src + y1 * p.s_h + x0 * p.s_w);
  const T* c_se = reinterpret_cast<const T*>(src + y1 * p.s_h + x1 * p.s_w);
#pragma unroll 4
  for (int v = lane; v < nvec; v += group) {
    T acc = VecOf<V>::zero();
    if (in_nw) add(acc, __ldg(c_nw + v), nw);
    if (in_ne) add(acc, __ldg(c_ne + v), ne);
    if (in_sw) add(acc, __ldg(c_sw + v), sw);
    if (in_se) add(acc, __ldg(c_se + v), se);
    out[v] = acc;
  }
}

template <int V>
cudaError_t launch(const Params& p, int n, int nearest, cudaStream_t stream) {
  const long long threads = p.q << p.log2_group;
  const dim3 blocks((unsigned)((threads + kThreads - 1) / kThreads),
                    (unsigned)n);
  if (nearest)
    grid_sample_kernel<V, true><<<blocks, kThreads, 0, stream>>>(p);
  else
    grid_sample_kernel<V, false><<<blocks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Gather the NHWC source (h, w, c; element strides s_n, s_h, s_w, unit
// channel stride) at the (n, q, 2) grid (element strides g_n, g_q, g_c;
// (x, y) in [-1, 1]) into the contiguous (n, q, c) out. vec: floats per
// vector (1, 2 or 4), which c, the source's strides and both pointers'
// alignment must allow; log2_group: lanes per query. Returns the launch's
// CUDA error (0: launched).
extern "C" int grid_sample_forward(const float* src, long long s_n,
                                   long long s_h, long long s_w, int h, int w,
                                   int c, const float* grid, long long g_n,
                                   long long g_q, long long g_c, int n,
                                   long long q, float* out, int nearest,
                                   int border, int align, int vec,
                                   int log2_group, void* stream) {
  if (n < 1 || n > 65535 || q < 1 || c < 1 || h < 1 || w < 1 ||
      log2_group < 0 || log2_group > 5 || c % vec != 0 ||
      ((q << log2_group) + kThreads - 1) / kThreads > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const Params p{src, s_n, s_h, s_w, h, w, c, grid, g_n, g_q, g_c, q, out,
                 border, align, log2_group};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 1:
      return (int)launch<1>(p, n, nearest, st);
    case 2:
      return (int)launch<2>(p, n, nearest, st);
    case 4:
      return (int)launch<4>(p, n, nearest, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
