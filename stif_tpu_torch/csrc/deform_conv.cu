// Modulated deformable convolution (DCNv2) sampling for Hopper (sm_90a),
// CUDA C++ with plain C entries.
//
// Replaces the sampling of stif_tpu/ops/deform_conv.py: the patch gather
// and bilinear fold of the forward (_dcn_patch_gather, _grouped_patch_gather)
// and its backward, the x-cotangent of the gather (_gpg_bwd, a
// jax.custom_vjp) and the offset and mask gradients that jax.grad takes
// through the corner weights. The JAX package has no Pallas kernel for this
// op: it writes it in XLA gathers. The contraction with the conv weight is
// not here: the wrapper (stif_tpu_torch/ops/deform_conv.py) does it with one
// torch.addmm, as the JAX package leaves its einsum to XLA.
//
// Two kernels, one thread per (b, q, k, g) row, g fastest:
//  * dcn_im2col: the sample position base + offset of tap k of group g at
//    output pixel q, its four bilinear corners, each zeroed when outside the
//    map, times the mask; writes the group's CpG channels of the column row
//    (B*Q, K*Cin), k-major then Cin, the layout the plain version builds.
//  * dcn_col2im: the backward from the grad-columns. Scatters grad-col x
//    corner weight x mask into the four corners of grad x with fp32
//    atomicAdd (sums land in any order), and, from the same corner reads,
//    writes the gradient of the offset (dy, dx) and of the mask: the sum
//    over the group's channels of grad-col x d(bilinear)/d(dy, dx) x mask
//    and of grad-col x bilinear value. The col2im_coord of the reference's
//    CUDA op is fused here: both need the same positions and the same
//    grad-col row.
//
// Floor convention (the JAX one): corners floor(p) and floor(p) + 1 with
// weights 1 - l and l, l = p - floor(p), so at an integer position (a fresh
// DCN has zero offsets) the derivative reads corners p and p + 1.
//
// shift_bound S >= 0 (the JAX package's impl="dense", _dcn_dense_shift):
// each corner's read index is clip(i, 0, n - 1), clamped further to
// [q - S, q + S] around the query pixel q; its weight stays the unclamped
// corner's. S < 0: exact reads (impl="patch").
//
// What bounds it on an H100: bytes. Per (q, k, g) row the forward reads
// 4 corners x CpG floats of x (from L2 mostly: the corners of neighbouring
// taps and pixels overlap) and writes CpG floats of columns. At the
// encoder's largest call (96x160, Cin 64, 72 rows of 8 channels per pixel)
// the columns are 35.4 MB written, against 3.9 MB of x, 8.8 MB of offsets and
// 4.4 MB of mask read, a few FLOPs per byte: far below the card's 20
// FLOP/byte fp32 machine balance. The design keeps the bytes at the minimum
// of the column layout: the eight threads of a (q, k) cover the 64
// contiguous channels of a pixel, so each corner read and each column write
// of a warp is four 256-byte runs, made of 16-byte loads and stores (two
// per corner per thread with CpG 8). The backward reads the grad-columns
// once and x again; its atomics go to L2 and bound it, so they are
// Hopper's 16-byte atomicAdd on float4: four channels per atomic, not one.
// fp32 only, no tensor cores; a fused sample-and-contract kernel on the
// tensor cores, which never writes the columns, is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMeta = 28;  // longs the C entries read from meta

struct Geometry {
  long long B, H, W, Cin, G, CpG, Ho, Wo, kh, kw, sh, sw, ph, pw, dh, dw, S;
  long long os[6];  // offset strides (elements): b, ho, wo, g, k, (dy, dx)
  long long ms[5];  // mask strides: b, ho, wo, g, k
};

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

// The sample of row t = ((b*Ho + ho)*Wo + wo)*K*G + k*G + g.
struct Sample {
  long long row;         // column row b*Q + q
  long long oi;          // element of (b, ho, wo, g, k) in a contiguous
                         // (B, Ho, Wo, G, K) tensor
  long long corner[4];   // element of (b, y, x, g*CpG) in x, for the
                         // corners 00, 01, 10, 11
  int k;
  float m;
  Axis ay, ax;
};

__device__ __forceinline__ Sample sample(long long t, const float* offset,
                                         const float* mask,
                                         const Geometry& s) {
  Sample r;
  const int K = (int)(s.kh * s.kw);
  const int g = (int)(t % s.G);
  long long u = t / s.G;
  r.k = (int)(u % K);
  u /= K;
  r.row = u;
  const int wo = (int)(u % s.Wo);
  u /= s.Wo;
  const int ho = (int)(u % s.Ho);
  const long long b = u / s.Ho;
  const int i = r.k / (int)s.kw, j = r.k % (int)s.kw;
  const long long ob = b * s.os[0] + ho * s.os[1] + wo * s.os[2] +
                       g * s.os[3] + r.k * s.os[4];
  const float py = (float)(ho * s.sh - s.ph + i * s.dh) + __ldg(offset + ob);
  const float px =
      (float)(wo * s.sw - s.pw + j * s.dw) + __ldg(offset + ob + s.os[5]);
  r.m = __ldg(mask + b * s.ms[0] + ho * s.ms[1] + wo * s.ms[2] +
              g * s.ms[3] + r.k * s.ms[4]);
  r.oi = (((b * s.Ho + ho) * s.Wo + wo) * s.G + g) * K + r.k;
  r.ay = axis(py, (int)s.H, ho, (int)s.S);
  r.ax = axis(px, (int)s.W, wo, (int)s.S);
  const long long gc = g * s.CpG;
  const long long y0 = (b * s.H + r.ay.r0) * s.W, y1 = (b * s.H + r.ay.r1) * s.W;
  r.corner[0] = (y0 + r.ax.r0) * s.Cin + gc;
  r.corner[1] = (y0 + r.ax.r1) * s.Cin + gc;
  r.corner[2] = (y1 + r.ax.r0) * s.Cin + gc;
  r.corner[3] = (y1 + r.ax.r1) * s.Cin + gc;
  return r;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    dcn_im2col_kernel(const float* __restrict__ x,
                      const float* __restrict__ offset,
                      const float* __restrict__ mask,
                      float* __restrict__ cols, Geometry s, long long n) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  const Sample r = sample(t, offset, mask, s);
  // corner weights times the mask, in the plain version's order
  const float w00 = r.ay.w0 * r.ax.w0 * r.m, w01 = r.ay.w0 * r.ax.w1 * r.m;
  const float w10 = r.ay.w1 * r.ax.w0 * r.m, w11 = r.ay.w1 * r.ax.w1 * r.m;
  const int g = (int)(t % s.G);
  float* out = cols + r.row * (s.kh * s.kw * s.Cin) + r.k * s.Cin + g * s.CpG;
  if (kVec) {
    for (int c = 0; c < s.CpG; c += 4) {
      const float4 a = ld4(x + r.corner[0] + c), b = ld4(x + r.corner[1] + c);
      const float4 d = ld4(x + r.corner[2] + c), e = ld4(x + r.corner[3] + c);
      float4 o;
      o.x = a.x * w00 + b.x * w01 + d.x * w10 + e.x * w11;
      o.y = a.y * w00 + b.y * w01 + d.y * w10 + e.y * w11;
      o.z = a.z * w00 + b.z * w01 + d.z * w10 + e.z * w11;
      o.w = a.w * w00 + b.w * w01 + d.w * w10 + e.w * w11;
      *reinterpret_cast<float4*>(out + c) = o;
    }
  } else {
    for (int c = 0; c < s.CpG; ++c) {
      out[c] = __ldg(x + r.corner[0] + c) * w00 +
               __ldg(x + r.corner[1] + c) * w01 +
               __ldg(x + r.corner[2] + c) * w10 +
               __ldg(x + r.corner[3] + c) * w11;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    dcn_col2im_kernel(const float* __restrict__ gcols,
                      const float* __restrict__ x,
                      const float* __restrict__ offset,
                      const float* __restrict__ mask, float* gx,
                      float* __restrict__ goff, float* __restrict__ gmask,
                      Geometry s, long long n) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  const Sample r = sample(t, offset, mask, s);
  const float wy[2] = {r.ay.w0, r.ay.w1}, wx[2] = {r.ax.w0, r.ax.w1};
  const float dy[2] = {r.ay.d0, r.ay.d1}, dx[2] = {r.ax.d0, r.ax.d1};
  float wm[4];
  for (int c = 0; c < 4; ++c) wm[c] = wy[c >> 1] * wx[c & 1] * r.m;
  const int g = (int)(t % s.G);
  const float* gc =
      gcols + r.row * (s.kh * s.kw * s.Cin) + r.k * s.Cin + g * s.CpG;
  float dot[4] = {0.f, 0.f, 0.f, 0.f};  // sum over c of grad-col x corner
  if (kVec) {
    for (int c = 0; c < s.CpG; c += 4) {
      const float4 v = ld4(gc + c);
      for (int cn = 0; cn < 4; ++cn) {
        const float4 a = ld4(x + r.corner[cn] + c);
        dot[cn] += v.x * a.x + v.y * a.y + v.z * a.z + v.w * a.w;
        if (wm[cn] != 0.f) {  // one 16-byte atomic (sm_90): 4 adds
          atomicAdd(reinterpret_cast<float4*>(gx + r.corner[cn] + c),
                    make_float4(v.x * wm[cn], v.y * wm[cn], v.z * wm[cn],
                                v.w * wm[cn]));
        }
      }
    }
  } else {
    for (int c = 0; c < s.CpG; ++c) {
      const float v = __ldg(gc + c);
      for (int cn = 0; cn < 4; ++cn) {
        dot[cn] += v * __ldg(x + r.corner[cn] + c);
        if (wm[cn] != 0.f) atomicAdd(gx + r.corner[cn] + c, v * wm[cn]);
      }
    }
  }
  float gm = 0.f, gy = 0.f, gxo = 0.f;
  for (int cn = 0; cn < 4; ++cn) {
    const int a = cn >> 1, b = cn & 1;
    gm += wy[a] * wx[b] * dot[cn];
    gy += dy[a] * wx[b] * dot[cn];
    gxo += wy[a] * dx[b] * dot[cn];
  }
  gmask[r.oi] = gm;
  goff[2 * r.oi] = gy * r.m;
  goff[2 * r.oi + 1] = gxo * r.m;
}

bool read_geometry(const long long* meta, int n_meta, Geometry* s) {
  if (n_meta != kMeta) return false;
  long long* f[] = {&s->B,  &s->H,  &s->W,  &s->Cin, &s->G,  &s->Ho,
                    &s->Wo, &s->kh, &s->kw, &s->sh,  &s->sw, &s->ph,
                    &s->pw, &s->dh, &s->dw, &s->S};
  for (int i = 0; i < 16; ++i) *f[i] = meta[i];
  for (int i = 0; i < 6; ++i) s->os[i] = meta[16 + i];
  for (int i = 0; i < 5; ++i) s->ms[i] = meta[22 + i];
  if (meta[27] != kMeta) return false;  // the caller's layout matches ours
  if (s->G <= 0 || s->Cin % s->G != 0 || s->kh <= 0 || s->kw <= 0)
    return false;
  s->CpG = s->Cin / s->G;
  if (s->S >= 0 && (s->Ho != s->H || s->Wo != s->W)) return false;
  return true;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

long long rows(const Geometry& s) {
  return s.B * s.Ho * s.Wo * s.kh * s.kw * s.G;
}

unsigned int blocks(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

// meta: B, H, W, Cin, G, Ho, Wo, kh, kw, sh, sw, ph, pw, dh, dw, S (-1: no
// shift bound), the six strides of offset, the five of mask, then 28.
// x is contiguous NHWC; cols is contiguous (B*Ho*Wo, kh*kw*Cin). Returns
// the CUDA error of the launch (0 on success; cudaErrorInvalidValue for a
// geometry the kernel does not take).
extern "C" int dcn_im2col_forward(const float* x, const float* offset,
                                  const float* mask, float* cols,
                                  const long long* meta, int n_meta,
                                  void* stream) {
  Geometry s;
  if (!read_geometry(meta, n_meta, &s)) return (int)cudaErrorInvalidValue;
  const long long n = rows(s);
  if (n == 0) return 0;
  const bool vec = s.CpG % 4 == 0 && aligned16(x) && aligned16(cols);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    dcn_im2col_kernel<true><<<blocks(n), kThreads, 0, st>>>(x, offset, mask,
                                                            cols, s, n);
  else
    dcn_im2col_kernel<false><<<blocks(n), kThreads, 0, st>>>(x, offset, mask,
                                                             cols, s, n);
  return (int)cudaGetLastError();
}

// gcols: contiguous (B*Ho*Wo, kh*kw*Cin); gx: contiguous NHWC, zeroed by
// the caller (the kernel adds into it); goff: contiguous (B, Ho, Wo, G, K,
// 2); gmask: contiguous (B, Ho, Wo, G, K). meta as for the forward.
extern "C" int dcn_col2im_backward(const float* gcols, const float* x,
                                   const float* offset, const float* mask,
                                   float* gx, float* goff, float* gmask,
                                   const long long* meta, int n_meta,
                                   void* stream) {
  Geometry s;
  if (!read_geometry(meta, n_meta, &s)) return (int)cudaErrorInvalidValue;
  const long long n = rows(s);
  if (n == 0) return 0;
  const bool vec = s.CpG % 4 == 0 && aligned16(x) && aligned16(gcols) &&
                   aligned16(gx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    dcn_col2im_kernel<true><<<blocks(n), kThreads, 0, st>>>(
        gcols, x, offset, mask, gx, goff, gmask, s, n);
  else
    dcn_col2im_kernel<false><<<blocks(n), kThreads, 0, st>>>(
        gcols, x, offset, mask, gx, goff, gmask, s, n);
  return (int)cudaGetLastError();
}
