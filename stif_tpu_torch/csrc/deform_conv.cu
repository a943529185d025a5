// Modulated deformable convolution (DCNv2) for Hopper (sm_90a): a fused
// sample-and-contract forward and a fused backward on the tensor cores,
// CUDA C++ with plain C entries.
//
// Replaces stif_tpu/ops/deform_conv.py's patch path: the gather, bilinear
// fold and contraction of the forward (_dcn_patch_gather, _grouped_patch_
// gather, the einsum with the weight) and its backward, the x-cotangent of
// the gather (_gpg_bwd, a jax.custom_vjp), the offset and mask gradients
// that jax.grad takes through the corner weights, and the weight's
// gradient. The JAX package has no Pallas kernel for this op: it writes it
// in XLA gathers.
//
// What bounds it on an H100. At the encoder's largest call (96x160, Cin =
// Cout = 64, 8 groups, 3x3) the op's inputs and output are 21 MB (x 3.9,
// offsets 8.8, mask 4.4, out 3.9) and its product is 1.13 GFLOP, 3.4 GFLOP
// as three TF32 passes: 6.3 us of bytes against 6.9 us of 3xTF32 tensor-core
// work. The column matrix of the unfused op (15,360 x 576 fp32, 35 MB,
// written and read again) alone would cost more than either, so neither
// kernel writes it: each column slab lives in shared memory.
//
// dcn_forward_kernel, an implicit GEMM. A block owns a tile of 128 output
// pixels (64 when a call's 64-pixel tiles fit in one wave of the SMs) and
// 64 output channels. The weights of its output channels for a chunk of
// input channels (all taps: 64 x 64 x 9 fp32, 147 KB at nf 64) arrive in
// shared memory by bulk copies (the TMA engine) on an mbarrier, one copy
// per output channel, read in place from the OIHW weight, whose (channel,
// tap) run is contiguous: no reordered copy of the weight is made. The
// block's 16 warps split in two. Eight producer warps sample the
// (pixels x channels) slab of the columns for one tap, one thread per
// (pixel, group), two items at a time: the tap's offset and mask read once
// (the pixel's coordinates from a table the block fills once), the four
// corners as 16-byte loads of contiguous channels. Meanwhile eight consumer
// warps multiply the previous tap's slab by W[k] on the tensor cores
// (mma.sync m16n8k8 TF32) into fp32 registers that accumulate over every
// tap and chunk. The two slabs alternate; one __syncthreads a step hands
// one over. The epilogue adds the bias and stores NHWC. The weight tile
// fills shared memory, so one block runs on an SM: the sampling, bound by
// the latency of its dependent loads (offsets, then corners), sets the
// pace.
//
// dcn_backward_kernel. A block (256 threads, three to an SM) owns one tap k,
// one channel chunk and one output-channel tile, and walks a run of 64-pixel
// tiles. W[k] of its chunk
// and tile is gathered once from the OIHW weight into shared memory
// (cp.async). Per tile:
//  * the grad-output tile arrives by bulk copies;
//  * gcol = g_tile x W[k]^T on the tensor cores into shared memory (the
//    grad-columns never reach device memory);
//  * one thread per (pixel, group) samples the tap again: the corner reads
//    give the slab (kept in shared memory), the dot of gcol with each corner
//    (for the offset and mask gradients) and grad x, scattered by 16-byte
//    atomicAdd on float4 (Hopper) into the four corners;
//  * gW[k] += slab^T x g_tile on the tensor cores, in registers across the
//    block's tiles. Each block writes its gW partial (OIHW) to a workspace,
//    and dcn_wgrad_sum_kernel sums the partials in a fixed order: the
//    weight's gradient is deterministic; grad x, by atomics, sums in any
//    order.
// With more than one output-channel tile, each tile's blocks add their share
// of gcol's effect: grad offset and grad mask then go by atomics too (also
// when a group spans channel chunks, more than 64 channels per group).
//
// Precision: 3xTF32. Each operand is split a = hi + lo, hi = cvt.rna.tf32(a),
// lo = cvt.rna.tf32(a - hi), and a product is lo*hi + hi*lo + hi*hi: about
// fp32's accuracy (one TF32 pass keeps ~3 decimal digits) at a third of the
// TF32 rate, still above the op's byte bound.
//
// Padding: channels pad to the mma's 8 in shared memory (zeros), pixel rows
// past the last pixel are zero, so any Cin, groups and Cout are taken; a
// chunk holds whole groups of at most 64 channels and at most 576 weights
// per output channel (64 channels of a 3x3 kernel), and kernels of up to 72
// taps (9x8) are taken.
//
// Floor convention (the JAX one): corners floor(p) and floor(p) + 1 with
// weights 1 - l and l, l = p - floor(p), so at an integer position (a fresh
// DCN has zero offsets) the derivative reads corners p and p + 1; an
// out-of-map corner weighs 0.
//
// shift_bound S >= 0 (the JAX package's impl="dense", _dcn_dense_shift):
// each corner's read index is clip(i, 0, n - 1), clamped further to
// [q - S, q + S] around the query pixel q; its weight stays the unclamped
// corner's. S < 0: exact reads (impl="patch").

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int kFwdRows = 128;    // forward: output pixels per tile (or 64
                                 // when a call has too few tiles for the SMs)
constexpr int kFwdThreads = 512; // 16 warps: 8 multiply, 8 sample
constexpr int kConsumers = 256;  // forward: warps 0-7, 4 x 2 over the tile
constexpr int kProducers = kFwdThreads - kConsumers;  // warps 8-15
constexpr int kBatch = 2;        // items a producer samples at once
constexpr int kRows = 64;        // backward: output pixels per tile
constexpr int kThreads = 256;    // 8 warps: 4 along the rows x 2 along cols
constexpr int kTileN = 64;       // output channels per tile
constexpr int kMaxCk = 64;       // input channels per chunk
constexpr int kMaxRun = 576;     // weights per output channel in a chunk
constexpr int kMaxTaps = 72;
constexpr int kLdA = kMaxCk + 4;   // slab and gcol rows (pixel-major)
constexpr int kLdWb = kTileN + 4;  // backward weight rows (channel-major)
constexpr int kLdG = kTileN + 8;   // grad-output rows (pixel-major)
constexpr int kLdS = kMaxCk + 8;   // backward slab rows (pixel-major)
constexpr int kMeta = 29;        // longs the C entries read from meta
constexpr int kFwdPlan = 10;     // ints of a forward plan
constexpr int kBwdPlan = 11;     // ints of a backward plan
constexpr int kMaxSmem = 232448;

constexpr int kBwdSmem =
    16 + 4 * (kMaxCk * kLdWb + kRows * kLdG + kRows * kLdA + kRows * kLdS);
static_assert(kBwdSmem <= kMaxSmem, "a block's shared memory");

struct Geometry {
  long long B, H, W, Cin, G, CpG, Ho, Wo, kh, kw, sh, sw, ph, pw, dh, dw, S,
      Cout;
  long long os[6];  // offset strides (elements): b, ho, wo, g, k, (dy, dx)
  long long ms[5];  // mask strides: b, ho, wo, g, k
  long long P;      // output pixels B*Ho*Wo
  int K;            // taps
  int ck, ncc, nnt; // channels per chunk, chunks, output-channel tiles
};

__host__ __device__ inline int round8(int n) { return (n + 7) & ~7; }

// Channels per chunk: whole groups, at most 64 channels and kMaxRun / K
// (rounded down to 8 where that leaves 8) so that a chunk's weights per
// output channel fit; a group wider than that is split. Never more than
// Cin.
__host__ __device__ inline int chunk_width(long long Cin, long long CpG,
                                           int K) {
  int most = kMaxRun / K;
  most = most >= 8 ? (most < kMaxCk ? most & ~7 : kMaxCk) : most;
  long long ck = CpG <= most ? CpG * (most / CpG) : most;
  return (int)(ck < Cin ? ck : Cin);
}

// Floats per output channel of the forward's weight tile: the chunk padded
// to 8 channels, all taps, then to 4 mod 32 floats (bank spread).
__host__ __device__ inline int weight_pitch(int ck, int K) {
  const int n = round8(ck) * K;
  return n + (36 - n % 32) % 32;
}

// The forward's shared memory for tiles of `rows` pixels: an mbarrier, the
// weight tile, two slabs and the tile's pixel table (32 bytes a pixel).
__host__ __device__ inline int forward_smem(int pitch, int rows) {
  return 16 + 4 * (kTileN * pitch + 2 * rows * kLdA) + 32 * rows;
}

// One axis of a bilinear sample at position p over n pixels, for query
// index q: the two corner weights (0 outside the map), their derivatives in
// p, and the two read indices (in range; clamped to [q - S, q + S] with
// S >= 0).
struct Axis {
  float w0, w1, d0, d1;
  int r0, r1;
};

__device__ __forceinline__ Axis axis(float p, int n, int q, int S) {
  Axis a;
  float f = floorf(p);
  const float l = p - f;
  f = fminf(fmaxf(f, -2.f), (float)n);  // outside stays outside; no overflow
  const int i0 = (int)f, i1 = i0 + 1;
  const bool v0 = i0 >= 0 && i0 < n, v1 = i1 >= 0 && i1 < n;
  a.w0 = v0 ? 1.f - l : 0.f;
  a.w1 = v1 ? l : 0.f;
  a.d0 = v0 ? -1.f : 0.f;
  a.d1 = v1 ? 1.f : 0.f;
  a.r0 = min(max(i0, 0), n - 1);
  a.r1 = min(max(i1, 0), n - 1);
  if (S >= 0) {
    a.r0 = min(max(a.r0, q - S), q + S);
    a.r1 = min(max(a.r1, q - S), q + S);
  }
  return a;
}

// The sample of tap k of group g at output pixel pix = (b*Ho + ho)*Wo + wo.
struct Sample {
  long long oi;         // element of (b, ho, wo, g, k) in a contiguous
                        // (B, Ho, Wo, G, K) tensor
  long long corner[4];  // element of (b, y, x, 0) in x, for the corners
                        // 00, 01, 10, 11
  float m;
  Axis ay, ax;
};

__device__ __forceinline__ Sample sample(long long pix, int g, int k,
                                         const float* offset,
                                         const float* mask,
                                         const Geometry& s) {
  Sample r;
  const int wo = (int)(pix % s.Wo);
  const long long u = pix / s.Wo;
  const int ho = (int)(u % s.Ho);
  const long long b = u / s.Ho;
  const int i = k / (int)s.kw, j = k % (int)s.kw;
  const long long ob = b * s.os[0] + ho * s.os[1] + wo * s.os[2] +
                       g * s.os[3] + k * s.os[4];
  const float py = (float)(ho * s.sh - s.ph + i * s.dh) + __ldg(offset + ob);
  const float px =
      (float)(wo * s.sw - s.pw + j * s.dw) + __ldg(offset + ob + s.os[5]);
  r.m = __ldg(mask + b * s.ms[0] + ho * s.ms[1] + wo * s.ms[2] +
              g * s.ms[3] + k * s.ms[4]);
  r.oi = (pix * s.G + g) * s.K + k;
  r.ay = axis(py, (int)s.H, ho, (int)s.S);
  r.ax = axis(px, (int)s.W, wo, (int)s.S);
  const long long y0 = (b * s.H + r.ay.r0) * s.W;
  const long long y1 = (b * s.H + r.ay.r1) * s.W;
  r.corner[0] = (y0 + r.ax.r0) * s.Cin;
  r.corner[1] = (y0 + r.ax.r1) * s.Cin;
  r.corner[2] = (y1 + r.ax.r0) * s.Cin;
  r.corner[3] = (y1 + r.ax.r1) * s.Cin;
  return r;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// ------------------------------------------------------------ tensor cores

__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(a));
  const float rest = a - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp, one k-step of 8: acc[mt][j] (16 rows x 8 columns: m-tile mt <
// MT, n-tile j < nsub <= 4) += A x B in 3xTF32, element (m, kk) of A at
// a[m * am + kk * ak], (kk, n) of B at b[kk * bk + n * bn], both in shared
// memory; m-tile mt is rows [16 mt, 16 mt + 16). acc[mt][j][2h + e] holds
// row 16 mt + g + 8h, column 8j + 2t + e (g = lane / 4, t = lane % 4). The
// three passes go over every tile in turn, so that consecutive mma
// instructions do not wait on each other. NSUB, when not 0, fixes nsub.
template <int MT, int NSUB>
__device__ __forceinline__ void mma_kstep(float (&acc)[MT][4][4],
                                          const float* a, int am, int ak,
                                          const float* b, int bk, int bn,
                                          int nsub) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (NSUB) nsub = NSUB;
  uint32_t ah[MT][4], al[MT][4], bh[4][2], bl[4][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float* r = a + 16 * mt * am;
    split_tf32(r[g * am + t * ak], ah[mt][0], al[mt][0]);
    split_tf32(r[(g + 8) * am + t * ak], ah[mt][1], al[mt][1]);
    split_tf32(r[g * am + (t + 4) * ak], ah[mt][2], al[mt][2]);
    split_tf32(r[(g + 8) * am + (t + 4) * ak], ah[mt][3], al[mt][3]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < nsub) {
      split_tf32(b[t * bk + (8 * j + g) * bn], bh[j][0], bl[j][0]);
      split_tf32(b[(t + 4) * bk + (8 * j + g) * bn], bh[j][1], bl[j][1]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)  // the small terms first
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      if (j < nsub) mma_tf32(acc[mt][j], al[mt], bh[j]);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      if (j < nsub) mma_tf32(acc[mt][j], ah[mt], bl[j]);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      if (j < nsub) mma_tf32(acc[mt][j], ah[mt], bh[j]);
}

// One warp: acc += A x B over 8 * ksteps (see mma_kstep).
template <int MT>
__device__ __forceinline__ void mma_tile(float (&acc)[MT][4][4],
                                         const float* A, int am, int ak,
                                         const float* B, int bk, int bn,
                                         int ksteps, int nsub) {
#pragma unroll 2
  for (int ks = 0; ks < ksteps; ++ks) {
    mma_kstep<MT, 0>(acc, A + 8 * ks * ak, am, ak, B + 8 * ks * bk, bk, bn,
                     nsub);
  }
}

// mma_tile over exactly KS k-steps and 4 n-tiles: unrolled, no branches.
template <int MT, int KS>
__device__ __forceinline__ void mma_tile_full(float (&acc)[MT][4][4],
                                              const float* A, int am, int ak,
                                              const float* B, int bk,
                                              int bn) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    mma_kstep<MT, 4>(acc, A + 8 * ks * ak, am, ak, B + 8 * ks * bk, bk, bn,
                     4);
  }
}

template <int MT>
__device__ __forceinline__ void zero(float (&acc)[MT][4][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
}

// A barrier among the first n threads of the block (n a multiple of 32).
__device__ __forceinline__ void sync_first(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// n8 subtiles of a warp's 32 columns starting at col0 inside `width`.
__device__ __forceinline__ int subtiles(int width, int col0) {
  return max(0, min(4, (round8(width) - col0) / 8));
}

// ------------------------------------------------------------ forward

// Start the copy of the weights of output channels [n0, n0 + nn), input
// channels [c0, c0 + ckc), every tap, from the OIHW weight: per output
// channel one contiguous run of ckc*K floats, to dst + n * pitch. Called
// by the consumer warps. Bulk copies (issued by warp 0) completing on
// `bar`, or, when the runs are not 16-byte aligned, 4-byte cp.async by
// every consumer with one plain arrive on `bar` (the consumers then wait
// with cp_async_wait_all and sync_first too).
__device__ __forceinline__ void stage_weights(const float* w,
                                              const Geometry& s, int c0,
                                              int ckc, int n0, int nn,
                                              int pitch, bool bulk,
                                              float* dst, uint64_t* bar) {
  const int run = ckc * s.K;
  const long long stride = s.Cin * s.K;
  const float* src = w + n0 * stride + (long long)c0 * s.K;
  if (bulk) {
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0) mbar_arrive_expect(bar, nn * run * 4);
      __syncwarp();
      for (int n = threadIdx.x; n < nn; n += 32) {
        bulk_copy(dst + n * pitch, src + n * stride, run * 4, bar);
      }
    }
    return;
  }
  if (threadIdx.x == 0) mbar_arrive(bar);
  for (int i = threadIdx.x; i < nn * run; i += kConsumers) {
    const int n = i / run, j = i - n * run;
    cp_async4(dst + n * pitch + j, src + n * stride + j);
  }
}

// Where a tile pixel's data lie: the element of its image in x, of its
// (b, ho, wo) in offset and in mask, and its ho and wo. Filled once per
// block, so that a step's sampling does no division.
struct Pixel {
  long long x, off, mask;
  int ho, wo;
};

template <int kR>
__device__ __forceinline__ void fill_pixels(Pixel* px, const Geometry& s,
                                            long long pix0, int tid,
                                            int threads) {
  for (int p = tid; p < kR; p += threads) {
    const long long pix = min(pix0 + p, s.P - 1);
    const int wo = (int)(pix % s.Wo);
    const long long u = pix / s.Wo;
    const int ho = (int)(u % s.Ho);
    const long long b = u / s.Ho;
    px[p].x = b * s.H * s.W * s.Cin;
    px[p].off = b * s.os[0] + ho * s.os[1] + wo * s.os[2];
    px[p].mask = b * s.ms[0] + ho * s.ms[1] + wo * s.ms[2];
    px[p].ho = ho;
    px[p].wo = wo;
  }
}

// A step of the forward: tap k of channels [c0, c1).
struct Step {
  int k, c0, c1;
};

__device__ __forceinline__ Step step_of(const Geometry& s, int st) {
  const int cc = st / s.K;
  const int c0 = cc * s.ck;
  return {st - cc * s.K, c0, min((int)s.Cin, c0 + s.ck)};
}

// One item's corner elements within its pixel's image and their bilinear
// weights times the mask (0 for a pixel past the last).
__device__ __forceinline__ void item_setup(const Geometry& s, const Pixel& q,
                                           bool live, int base_y, int base_x,
                                           float dy, float dx, float m,
                                           int (&cr)[4], float (&wt)[4]) {
  const Axis ay =
      axis((float)(q.ho * (int)s.sh + base_y) + dy, (int)s.H, q.ho, (int)s.S);
  const Axis ax =
      axis((float)(q.wo * (int)s.sw + base_x) + dx, (int)s.W, q.wo, (int)s.S);
  wt[0] = live ? ay.w0 * ax.w0 * m : 0.f;  // the plain version's order
  wt[1] = live ? ay.w0 * ax.w1 * m : 0.f;
  wt[2] = live ? ay.w1 * ax.w0 * m : 0.f;
  wt[3] = live ? ay.w1 * ax.w1 * m : 0.f;
  const int W = (int)s.W, C = (int)s.Cin;
  cr[0] = (ay.r0 * W + ax.r0) * C;
  cr[1] = (ay.r0 * W + ax.r1) * C;
  cr[2] = (ay.r1 * W + ax.r0) * C;
  cr[3] = (ay.r1 * W + ax.r1) * C;
}

// Channels [lo, hi) of one item's sample into dst[lo, hi).
template <bool kVec>
__device__ __forceinline__ void item_emit(const float* xi, const int (&cr)[4],
                                          const float (&wt)[4], int lo,
                                          int hi, float* dst) {
  if (kVec) {
    for (int c = lo; c < hi; c += 4) {
      const float4 a = ld4(xi + cr[0] + c), b = ld4(xi + cr[1] + c);
      const float4 d = ld4(xi + cr[2] + c), e = ld4(xi + cr[3] + c);
      float4 o;
      o.x = a.x * wt[0] + b.x * wt[1] + d.x * wt[2] + e.x * wt[3];
      o.y = a.y * wt[0] + b.y * wt[1] + d.y * wt[2] + e.y * wt[3];
      o.z = a.z * wt[0] + b.z * wt[1] + d.z * wt[2] + e.z * wt[3];
      o.w = a.w * wt[0] + b.w * wt[1] + d.w * wt[2] + e.w * wt[3];
      *reinterpret_cast<float4*>(dst + c) = o;
    }
  } else {
    for (int c = lo; c < hi; ++c) {
      dst[c] = __ldg(xi + cr[0] + c) * wt[0] + __ldg(xi + cr[1] + c) * wt[1] +
               __ldg(xi + cr[2] + c) * wt[2] + __ldg(xi + cr[3] + c) * wt[3];
    }
  }
}

// The slab of step t for the kR pixels from pix0: slab[p * kLdA + c - c0],
// columns [c1 - c0, round8(c1 - c0)) zero, rows past the last pixel zero.
// Run by the kProducers threads (tid 0 .. kProducers - 1), kBatch
// (pixel, group) items at a time: first their offsets and mask (the pixel
// from the block's table), then their four corners, 16-byte loads of
// contiguous channels (kVec) or 4-byte ones, so that a thread's loads are
// in flight together.
template <bool kVec, int kR>
__device__ __forceinline__ void produce_slab(const float* __restrict__ x,
                                             const float* __restrict__ offset,
                                             const float* __restrict__ mask,
                                             const Geometry& s,
                                             const Pixel* px, long long pix0,
                                             Step t, float* slab, int tid) {
  const int cpg = (int)s.CpG;
  const int g0 = t.c0 / cpg, ngc = (t.c1 - 1) / cpg - g0 + 1;
  const int n = kR * ngc;
  const int ki = t.k / (int)s.kw, kj = t.k - ki * (int)s.kw;
  const int base_y = ki * (int)s.dh - (int)s.ph;
  const int base_x = kj * (int)s.dw - (int)s.pw;
  for (int first = tid; first < n; first += kBatch * kProducers) {
    int cr[kBatch][4];
    float wt[kBatch][4];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int it = min(first + i * kProducers, n - 1);
      const int p = it / ngc, g = g0 + (it - p * ngc);
      const long long ob = px[p].off + g * s.os[3] + t.k * s.os[4];
      item_setup(s, px[p], pix0 + p < s.P, base_y, base_x,
                 __ldg(offset + ob), __ldg(offset + ob + s.os[5]),
                 __ldg(mask + px[p].mask + g * s.ms[3] + t.k * s.ms[4]),
                 cr[i], wt[i]);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int it = first + i * kProducers;
      if (it < n) {
        const int p = it / ngc, g = g0 + (it - p * ngc);
        item_emit<kVec>(x + px[p].x, cr[i], wt[i], max(t.c0, g * cpg),
                        min(t.c1, (g + 1) * cpg), slab + p * kLdA - t.c0);
      }
    }
  }
  const int w = t.c1 - t.c0, pad = round8(w) - w;
  if (pad) {
    for (int i = tid; i < kR * pad; i += kProducers) {
      slab[(i / pad) * kLdA + w + i % pad] = 0.f;
    }
  }
}

// Warps 0-7 (consumers) multiply, warps 8-15 (producers) sample the next
// step's slab meanwhile; a step is one (chunk, tap), and the two slabs
// alternate. One __syncthreads a step hands a slab over.
template <bool kVec, int kR>
__global__ void __launch_bounds__(kFwdThreads)
    dcn_forward_kernel(const float* __restrict__ x,
                       const float* __restrict__ offset,
                       const float* __restrict__ mask,
                       const float* __restrict__ w,
                       const float* __restrict__ bias,
                       float* __restrict__ out, const Geometry s, int pitch,
                       bool bulk) {
  extern __shared__ float4 smem4[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem4);
  float* wsm = reinterpret_cast<float*>(smem4 + 1);  // [n][c * K + k]
  float* slabs = wsm + kTileN * pitch;               // 2 x [p][c]
  Pixel* px = reinterpret_cast<Pixel*>(slabs + 2 * kR * kLdA);
  const long long pix0 = (long long)blockIdx.x * kR;
  constexpr int MT = kR / 64;  // m-tiles of 16 rows a consumer warp takes
  const int n0 = blockIdx.y * kTileN;
  const int nn = min(kTileN, (int)s.Cout - n0);
  const bool producer = threadIdx.x >= kConsumers;
  const int warp = threadIdx.x >> 5;
  const int wm = warp & 3, wn = (warp >> 2) & 1;  // rows 16 MT wm, cols 32 wn
  const int nsub = subtiles(nn, 32 * wn);
  const int steps = s.K * s.ncc;

  // the padding of the weight tile stays zero: copies never write it
  for (int i = threadIdx.x; i < kTileN * pitch; i += kFwdThreads) wsm[i] = 0.f;
  fill_pixels<kR>(px, s, pix0, threadIdx.x, kFwdThreads);
  proxy_fence();
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (producer) {
    produce_slab<kVec, kR>(x, offset, mask, s, px, pix0, step_of(s, 0), slabs,
                           threadIdx.x - kConsumers);
  } else {
    stage_weights(w, s, 0, min(s.ck, (int)s.Cin), n0, nn, pitch, bulk, wsm,
                  bar);
  }
  __syncthreads();

  float acc[MT][4][4];
  zero(acc);
  for (int st = 0; st < steps; ++st) {
    const int cc = st / s.K, k = st - cc * s.K;
    const int c0 = cc * s.ck, c1 = min((int)s.Cin, c0 + s.ck);
    if (!producer) {
      if (k == 0) {
        if (cc > 0) {  // every product of the chunk before is done
          stage_weights(w, s, c0, c1 - c0, n0, nn, pitch, bulk, wsm, bar);
        }
        cp_async_wait_all();
        mbar_wait(bar, cc & 1);
        sync_first(kConsumers);
      }
      const float* a = slabs + (st & 1) * kR * kLdA + 16 * MT * wm * kLdA;
      const float* b = wsm + 32 * wn * pitch + k;
      const int ksteps = round8(c1 - c0) / 8;
      if (ksteps == 8 && nsub == 4) {  // 64 channels, 64 outputs: nf 64
        mma_tile_full<MT, 8>(acc, a, kLdA, 1, b, s.K, pitch);
      } else {
        mma_tile(acc, a, kLdA, 1, b, s.K, pitch, ksteps, nsub);
      }
    } else if (st + 1 < steps) {
      produce_slab<kVec, kR>(x, offset, mask, s, px, pix0, step_of(s, st + 1),
                             slabs + ((st + 1) & 1) * kR * kLdA,
                             threadIdx.x - kConsumers);
    }
    __syncthreads();  // slab st + 1 is written; slab st is free
  }
  if (producer) return;

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= nsub) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long pix = pix0 + 16 * (MT * wm + mt) + g + 8 * h;
        if (pix >= s.P) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 32 * wn + 8 * j + 2 * t + e;
          if (n < nn) {
            out[pix * s.Cout + n0 + n] = acc[mt][j][2 * h + e] +
                                         (bias ? __ldg(bias + n0 + n) : 0.f);
          }
        }
      }
    }
}

// ------------------------------------------------------------ backward

// Start the copy of rows [row0, row0 + nk), columns [n0, n0 + nn) of the
// row-major grad-output (`cols` columns) into shared rows `ld` floats
// apart: bulk copies (one per row, issued by warp 0) completing on `bar`,
// or, when rows are not 16-byte runs, 4-byte cp.async by every thread with
// one plain arrive on `bar` (the block then waits with cp_async_wait_all).
__device__ __forceinline__ void stage_rows(const float* src, long long cols,
                                           long long row0, int nk, int n0,
                                           int nn, bool bulk, float* dst,
                                           int ld, uint64_t* bar) {
  if (bulk) {
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0) mbar_arrive_expect(bar, nk * nn * 4);
      __syncwarp();
      for (int r = threadIdx.x; r < nk; r += 32) {
        bulk_copy(dst + r * ld, src + (row0 + r) * cols + n0, nn * 4, bar);
      }
    }
    return;
  }
  if (threadIdx.x == 0) mbar_arrive(bar);
  for (int i = threadIdx.x; i < nk * nn; i += kThreads) {
    const int r = i / nn, j = i - r * nn;
    cp_async4(dst + r * ld + j, src + (row0 + r) * cols + n0 + j);
  }
}


// From gcol (tap k, channels [c0, c1) of the 64 pixels from pix0, in
// shared memory): grad x by atomics into the four corners, grad offset and
// grad mask, and the tap's slab (for gW) into `slab` (rows kLdS apart; rows
// past the last pixel zero).
template <bool kVec>
__device__ __forceinline__ void col2im_tile(
    const float* __restrict__ x, const float* __restrict__ offset,
    const float* __restrict__ mask, float* gx, float* goff, float* gmask,
    const Geometry& s, long long pix0, int k, int c0, int c1,
    const float* gcol, float* slab, bool accumulate) {
  const int cpg = (int)s.CpG;
  const int g0 = c0 / cpg, ngc = (c1 - 1) / cpg - g0 + 1;
  for (int it = threadIdx.x; it < kRows * ngc; it += kThreads) {
    const int p = it / ngc, g = g0 + (it - p * ngc);
    const int lo = max(c0, g * cpg), hi = min(c1, (g + 1) * cpg);
    float* sl = slab + p * kLdS - c0;
    if (pix0 + p >= s.P) {
      for (int c = lo; c < hi; ++c) sl[c] = 0.f;
      continue;
    }
    const float* gc = gcol + p * kLdA - c0;
    const Sample r = sample(pix0 + p, g, k, offset, mask, s);
    const float wy[2] = {r.ay.w0, r.ay.w1}, wx[2] = {r.ax.w0, r.ax.w1};
    const float dy[2] = {r.ay.d0, r.ay.d1}, dx[2] = {r.ax.d0, r.ax.d1};
    float wm[4];
#pragma unroll
    for (int cn = 0; cn < 4; ++cn) wm[cn] = wy[cn >> 1] * wx[cn & 1] * r.m;
    float dot[4] = {0.f, 0.f, 0.f, 0.f};  // sum over c of gcol x corner
    if (kVec) {
      for (int c = lo; c < hi; c += 4) {
        const float4 v = *reinterpret_cast<const float4*>(gc + c);
        float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int cn = 0; cn < 4; ++cn) {
          const float4 a = ld4(x + r.corner[cn] + c);
          dot[cn] += v.x * a.x + v.y * a.y + v.z * a.z + v.w * a.w;
          o.x += a.x * wm[cn];
          o.y += a.y * wm[cn];
          o.z += a.z * wm[cn];
          o.w += a.w * wm[cn];
          if (wm[cn] != 0.f) {  // one 16-byte atomic (sm_90): 4 adds
            atomicAdd(reinterpret_cast<float4*>(gx + r.corner[cn] + c),
                      make_float4(v.x * wm[cn], v.y * wm[cn], v.z * wm[cn],
                                  v.w * wm[cn]));
          }
        }
        *reinterpret_cast<float4*>(sl + c) = o;
      }
    } else {
      for (int c = lo; c < hi; ++c) {
        const float v = gc[c];
        float o = 0.f;
#pragma unroll
        for (int cn = 0; cn < 4; ++cn) {
          const float a = __ldg(x + r.corner[cn] + c);
          dot[cn] += v * a;
          o += a * wm[cn];
          if (wm[cn] != 0.f) atomicAdd(gx + r.corner[cn] + c, v * wm[cn]);
        }
        sl[c] = o;
      }
    }
    float gm = 0.f, gy = 0.f, gxo = 0.f;
#pragma unroll
    for (int cn = 0; cn < 4; ++cn) {
      const int a = cn >> 1, b = cn & 1;
      gm += wy[a] * wx[b] * dot[cn];
      gy += dy[a] * wx[b] * dot[cn];
      gxo += wy[a] * dx[b] * dot[cn];
    }
    if (accumulate) {
      atomicAdd(gmask + r.oi, gm);
      atomicAdd(goff + 2 * r.oi, gy * r.m);
      atomicAdd(goff + 2 * r.oi + 1, gxo * r.m);
    } else {
      gmask[r.oi] = gm;
      goff[2 * r.oi] = gy * r.m;
      goff[2 * r.oi + 1] = gxo * r.m;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 3)
    dcn_backward_kernel(const float* __restrict__ grad,
                        const float* __restrict__ x,
                        const float* __restrict__ offset,
                        const float* __restrict__ mask,
                        const float* __restrict__ w, float* gx,
                        float* goff, float* gmask, float* __restrict__ ws,
                        const Geometry s, int tiles_per_block,
                        bool accumulate, bool bulk) {
  extern __shared__ float4 smem4[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem4);  // the grad-output's
  float* wt = reinterpret_cast<float*>(smem4 + 1);     // [c][n]
  float* gt = wt + kMaxCk * kLdWb;                     // [p][n]
  float* gcol = gt + kRows * kLdG;                     // [p][c]
  float* slab = gcol + kRows * kLdA;                   // [p][c]
  const int nt = blockIdx.y % s.nnt;
  const int u = blockIdx.y / s.nnt;
  const int k = u / s.ncc, c0 = (u - k * s.ncc) * s.ck;
  const int c1 = min((int)s.Cin, c0 + s.ck), ckc = c1 - c0;
  const int n0 = nt * kTileN, nn = min(kTileN, (int)s.Cout - n0);
  const int warp = threadIdx.x >> 5;
  const int wm = warp & 3, wn = warp >> 2;

  for (int i = threadIdx.x; i < kMaxCk * kLdWb + kRows * kLdG;
       i += kThreads) {
    wt[i] = 0.f;  // and gt: the padding stays zero
  }
  proxy_fence();
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  // W[k] of the chunk and column tile, gathered from OIHW (taps innermost:
  // consecutive threads take consecutive channels, K floats apart); the
  // first tile's cp_async_wait_all and barrier complete it
  for (int i = threadIdx.x; i < ckc * nn; i += kThreads) {
    const int n = i / ckc, c = i - n * ckc;
    cp_async4(wt + c * kLdWb + n,
              w + ((long long)(n0 + n) * s.Cin + c0 + c) * s.K + k);
  }

  float accw[1][4][4];  // gW rows 16 wm (channels), columns 32 wn
  zero(accw);
  const long long n_tiles = (s.P + kRows - 1) / kRows;
  const long long t0 = (long long)blockIdx.x * tiles_per_block;
  const long long t1 = min(n_tiles, t0 + tiles_per_block);
  for (long long tile = t0; tile < t1; ++tile) {
    const long long pix0 = tile * kRows;
    const int rows = (int)min((long long)kRows, s.P - pix0);
    for (int i = threadIdx.x; i < (kRows - rows) * kLdG; i += kThreads) {
      gt[rows * kLdG + i] = 0.f;  // a ragged last tile: rows past P
    }
    proxy_fence();
    __syncthreads();
    stage_rows(grad, s.Cout, pix0, rows, n0, nn, bulk, gt, kLdG, bar);
    cp_async_wait_all();
    mbar_wait(bar, (int)((tile - t0) & 1));
    __syncthreads();

    {  // gcol (pixels x channels) = g_tile x W[k]^T over this column tile
      float acc[1][4][4];
      zero(acc);
      const int nsub = subtiles(ckc, 32 * wn);
      if (nn == kTileN && nsub == 4) {
        mma_tile_full<1, 8>(acc, gt + 16 * wm * kLdG, kLdG, 1,
                            wt + 32 * wn * kLdWb, 1, kLdWb);
      } else {
        mma_tile(acc, gt + 16 * wm * kLdG, kLdG, 1, wt + 32 * wn * kLdWb, 1,
                 kLdWb, round8(nn) / 8, nsub);
      }
      const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= nsub) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* dst = gcol + (16 * wm + g + 8 * h) * kLdA + 32 * wn + 8 * j +
                       2 * t;
          dst[0] = acc[0][j][2 * h];
          dst[1] = acc[0][j][2 * h + 1];
        }
      }
    }
    __syncthreads();
    col2im_tile<kVec>(x, offset, mask, gx, goff, gmask, s, pix0, k, c0, c1,
                      gcol, slab, accumulate);
    __syncthreads();
    if (16 * wm < ckc) {  // gW[k] (channels x columns) += slab^T x g_tile
      if (nn == kTileN) {
        mma_tile_full<1, kRows / 8>(accw, slab + 16 * wm, 1, kLdS,
                                    gt + 32 * wn, kLdG, 1);
      } else {
        mma_tile(accw, slab + 16 * wm, 1, kLdS, gt + 32 * wn, kLdG, 1,
                 kRows / 8, subtiles(nn, 32 * wn));
      }
    }
    __syncthreads();  // gt, gcol and the slab are free for the next tile
  }

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* part = ws + (long long)blockIdx.x * s.Cout * s.Cin * s.K;  // OIHW
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 16 * wm + g + 8 * h;
      if (c >= ckc) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 32 * wn + 8 * j + 2 * t + e;
        if (n < nn) {
          part[((long long)(n0 + n) * s.Cin + c0 + c) * s.K + k] =
              accw[0][j][2 * h + e];
        }
      }
    }
  }
}

// gw[i] = sum over the parts of ws[part][i], in order.
__global__ void __launch_bounds__(kThreads)
    dcn_wgrad_sum_kernel(const float* __restrict__ ws, float* __restrict__ gw,
                         long long n, int parts) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float v = 0.f;
  for (int p = 0; p < parts; ++p) v += ws[p * n + i];
  gw[i] = v;
}

// ------------------------------------------------------------ host side

bool read_geometry(const long long* meta, int n_meta, Geometry* s) {
  if (n_meta != kMeta || meta[kMeta - 1] != kMeta) return false;
  long long* f[] = {&s->B,  &s->H,  &s->W,  &s->Cin, &s->G,  &s->Ho,
                    &s->Wo, &s->kh, &s->kw, &s->sh,  &s->sw, &s->ph,
                    &s->pw, &s->dh, &s->dw, &s->S,   &s->Cout};
  for (int i = 0; i < 17; ++i) *f[i] = meta[i];
  for (int i = 0; i < 6; ++i) s->os[i] = meta[17 + i];
  for (int i = 0; i < 5; ++i) s->ms[i] = meta[23 + i];
  if (s->B < 0 || s->H <= 0 || s->W <= 0 || s->Cin <= 0 || s->G <= 0 ||
      s->Cin % s->G != 0 || s->kh <= 0 || s->kw <= 0 ||
      s->kh * s->kw > kMaxTaps || s->Cout <= 0 || s->Ho < 0 || s->Wo < 0) {
    return false;
  }
  if (s->S >= 0 && (s->Ho != s->H || s->Wo != s->W)) return false;
  if (s->H * s->W * s->Cin >= (1LL << 31)) return false;  // 32-bit offsets
  s->CpG = s->Cin / s->G;
  s->P = s->B * s->Ho * s->Wo;
  s->K = (int)(s->kh * s->kw);
  s->ck = chunk_width(s->Cin, s->CpG, s->K);
  s->ncc = (int)((s->Cin + s->ck - 1) / s->ck);
  s->nnt = (int)((s->Cout + kTileN - 1) / kTileN);
  return s->nnt <= 65535 && (long long)s->K * s->ncc * s->nnt <= 65535;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

long long tiles(const Geometry& s, int rows) {
  return (s.P + rows - 1) / rows;
}

// The plan's head, shared by both kernels: rows per tile, threads, channels
// per chunk, the chunk padded to the mma's 8, chunks, output-channel tiles.
bool check_head(const int* plan, const Geometry& s, int rows, int threads) {
  return plan[0] == rows && plan[1] == threads && plan[2] == s.ck &&
         plan[3] == round8(s.ck) && plan[4] == s.ncc && plan[5] == s.nnt;
}

cudaError_t allow_smem(const void* kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// meta (29 longs): B, H, W, Cin, G, Ho, Wo, kh, kw, sh, sw, ph, pw, dh, dw,
// S (-1: no shift bound), Cout, the six strides of offset, the five of
// mask, then 29. x is contiguous NHWC; w is the contiguous OIHW weight
// (Cout, Cin, kh, kw); bias (Cout,) or null; out contiguous (B, Ho, Wo,
// Cout).
// plan (10 ints): rows per tile (128, or 64), threads, channels per chunk, the chunk
// padded to 8, chunks, output-channel tiles, shared-memory bytes, grid x,
// grid y, floats per output channel of the weight tile. Returns the
// launch's CUDA error (0 on success; cudaErrorInvalidValue for a geometry
// or a plan the kernel does not take).
extern "C" int dcn_forward(const float* x, const float* offset,
                           const float* mask, const float* w,
                           const float* bias, float* out,
                           const long long* meta, int n_meta, const int* plan,
                           int n_plan, void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  Geometry s;
  const int rows = n_plan == kFwdPlan ? plan[0] : 0;
  if (!read_geometry(meta, n_meta, &s) || (rows != kFwdRows && rows != 64) ||
      !check_head(plan, s, rows, kFwdThreads)) {
    return bad;
  }
  const int pitch = weight_pitch(s.ck, s.K), smem = forward_smem(pitch, rows);
  const long long n_tiles = tiles(s, rows);
  if (plan[6] != smem || smem > kMaxSmem || plan[7] != n_tiles ||
      plan[8] != s.nnt || plan[9] != pitch || n_tiles > 0x7fffffffLL) {
    return bad;
  }
  const bool vec = s.CpG % 4 == 0 && aligned16(x);
  const bool bulk = (s.Cin * s.K) % 4 == 0 && (s.ck * s.K) % 4 == 0 &&
                    aligned16(w);
  auto kernel = rows == kFwdRows
                    ? (vec ? dcn_forward_kernel<true, kFwdRows>
                           : dcn_forward_kernel<false, kFwdRows>)
                    : (vec ? dcn_forward_kernel<true, 64>
                           : dcn_forward_kernel<false, 64>);
  cudaError_t err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (s.P == 0) return 0;
  kernel<<<dim3((unsigned)n_tiles, (unsigned)s.nnt), kFwdThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(x, offset, mask, w, bias, out,
                                                s, pitch, bulk);
  return (int)cudaGetLastError();
}

// grad: contiguous (B*Ho*Wo, Cout); x, offset, mask, w and meta as for the
// forward. gx: contiguous NHWC, zeroed by the caller (the kernel adds into
// it); goff: contiguous (B, Ho, Wo, G, K, 2); gmask: contiguous (B, Ho, Wo,
// G, K), both zeroed by the caller when the plan accumulates; ws: grid-x
// partials of the OIHW weight's gradient, summed into gw; with one part ws
// is gw and nothing is summed.
// plan (11 ints): the forward's first six (with this kernel's rows and
// threads), shared-memory bytes, grid x (parts), grid y, tiles per block,
// accumulate (grad offset and mask by atomics).
extern "C" int dcn_backward(const float* grad, const float* x,
                            const float* offset, const float* mask,
                            const float* w, float* gx, float* goff,
                            float* gmask, float* ws, float* gw,
                            const long long* meta, int n_meta,
                            const int* plan, int n_plan, void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  Geometry s;
  if (!read_geometry(meta, n_meta, &s) || n_plan != kBwdPlan ||
      !check_head(plan, s, kRows, kThreads)) {
    return bad;
  }
  const long long n_tiles = tiles(s, kRows);
  const long long grid_y = (long long)s.K * s.ncc * s.nnt;
  const int tpb = plan[9];
  const bool accumulate = s.nnt > 1 || s.CpG > s.ck;
  if (plan[6] != kBwdSmem || tpb < 1 ||
      plan[7] != (n_tiles + tpb - 1) / tpb + (n_tiles == 0) ||
      plan[8] != grid_y || plan[10] != (int)accumulate) {
    return bad;
  }
  const int parts = plan[7];
  if (parts == 1 ? ws != gw : ws == gw) return bad;
  const bool vec = s.CpG % 4 == 0 && aligned16(x) && aligned16(gx);
  const bool bulk = s.Cout % 4 == 0 && aligned16(grad);
  auto kernel = vec ? dcn_backward_kernel<true> : dcn_backward_kernel<false>;
  cudaError_t err = allow_smem((const void*)kernel, kBwdSmem);
  if (err != cudaSuccess) return (int)err;
  if (s.P == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<dim3((unsigned)parts, (unsigned)grid_y), kThreads, kBwdSmem, st>>>(
      grad, x, offset, mask, w, gx, goff, gmask, ws, s, tpb, accumulate, bulk);
  err = cudaGetLastError();
  if (err != cudaSuccess || parts == 1) return (int)err;
  const long long n = s.Cout * s.Cin * s.K;
  dcn_wgrad_sum_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                         0, st>>>(ws, gw, n, parts);
  return (int)cudaGetLastError();
}

// Blocks of each kernel one SM holds (the occupancy calculator's answer):
// the forward's at `fwd_smem` bytes of shared memory in out[0], the
// backward's in out[1]. Returns a CUDA error.
extern "C" int dcn_blocks_per_sm(int fwd_smem, int* out) {
  const void* kernels[2] = {(const void*)dcn_forward_kernel<true, kFwdRows>,
                            (const void*)dcn_backward_kernel<true>};
  const int smem[2] = {fwd_smem, kBwdSmem};
  const int threads[2] = {kFwdThreads, kThreads};
  for (int i = 0; i < 2; ++i) {
    cudaError_t err = allow_smem(kernels[i], smem[i]);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          out + i, kernels[i], threads[i], smem[i]);
    }
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
