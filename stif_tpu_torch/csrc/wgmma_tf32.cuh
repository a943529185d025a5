// Hopper (sm_90a) warpgroup products in TF32 with fp32 accumulation, and
// the 3xTF32 split of an fp32 value, for siren_fused.cu.
//
// wgmma_tf32<N>(d, a, desc) is one
//   wgmma.mma_async.sync.aligned.m64nNk8.f32.tf32.tf32
// for N = 8, 16, ..., 64: d (64 x N, N / 2 floats a thread) += A (64 x 8,
// four registers a thread) x B (8 x N, in shared memory behind `desc`). A
// wider tile is a run of such products over slices of its columns: slice i
// (columns 64 i on) is d[32 i ...] against B's 8-row groups 8 i on, 8 x 256
// bytes further (128 in the descriptor's 16-byte units; see kmajor_desc).
// Register layouts, with g = lane / 4, t = lane % 4 and warp w of the
// warpgroup:
//   a[0] = A(16w + g, t)      a[1] = A(16w + g + 8, t)
//   a[2] = A(16w + g, t + 4)  a[3] = A(16w + g + 8, t + 4)
//   d[4j + 2h + e] = D(16w + g + 8h, 8j + 2t + e)
// TF32 operands must be K-major in shared memory: B is stored as N rows of
// K, in core matrices of 8 rows x 16 bytes (128 contiguous bytes) without
// swizzle; `kmajor_desc` describes such a tile (see there).
//
// The product is asynchronous: wgmma_fence() before the first product that
// reads registers written since, wgmma_commit() to close a group,
// wgmma_wait<n>() until at most n groups are pending. Registers handed to a
// pending product (accumulators and A) must not be touched until its group
// is done; fence_operands keeps the compiler from moving accesses of the
// accumulators or the A registers across the fence and the wait (ptxas
// would otherwise fence before every product).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// a rounded to TF32's 10 mantissa bits, to nearest with ties away from
// zero, as cvt.rna.tf32.f32 rounds a finite value: half a TF32 unit added
// to the magnitude's bits, the 13 bits below TF32 cleared (two integer
// operations where cvt takes a slow path).
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
}

// hi = tf32(a), lo = tf32(a - hi), both rounded to nearest: a = hi + lo to
// about 2^-22 relative, so lo*hi + hi*lo + hi*hi keeps fp32's accuracy.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(Pending)
               : "memory");
}

// A named barrier over one warpgroup's 128 threads (barrier 0 is
// __syncthreads').
template <int Id>
__device__ __forceinline__ void group_barrier() {
  asm volatile("bar.sync %0, 128;\n" ::"n"(Id) : "memory");
}

// A warpgroup gives up registers to, or takes them from, the others of its
// block (setmaxnreg; every warp of the group executes it).
template <int N>
__device__ __forceinline__ void set_max_registers_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void set_max_registers_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_operands(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// Descriptor of a K-major tile without swizzle at shared address `p`
// (16-byte aligned): element (n, k) of a k-block of 8 lies at byte
//   (n / 8) * 256 + (k / 4) * 128 + (n % 8) * 16 + (k % 4) * 4,
// i.e. the two 4-wide K halves of each 8-row group are adjacent core
// matrices (leading byte offset 128) and the 8-row groups follow each other
// (stride byte offset 256).
__device__ __forceinline__ uint64_t kmajor_desc(const void* p) {
  const uint32_t a =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t (&a)[4],
                                           uint64_t desc);

// The accumulator operands of one product, N / 2 of them: the register
// list and the constraints, four at a time.
#define WG_D4 "%0, %1, %2, %3"
#define WG_C4 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
#define WG_D8 WG_D4 ", %4, %5, %6, %7"
#define WG_C8 WG_C4, "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
#define WG_D12 WG_D8 ", %8, %9, %10, %11"
#define WG_C12 WG_C8, "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
#define WG_D16 WG_D12 ", %12, %13, %14, %15"
#define WG_C16 WG_C12, "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define WG_D20 WG_D16 ", %16, %17, %18, %19"
#define WG_C20 WG_C16, "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
#define WG_D24 WG_D20 ", %20, %21, %22, %23"
#define WG_C24 WG_C20, "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
#define WG_D28 WG_D24 ", %24, %25, %26, %27"
#define WG_C28 WG_C24, "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
#define WG_D32 WG_D28 ", %28, %29, %30, %31"
#define WG_C32 WG_C28, "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// One specialisation per width: DS / DC the accumulators, then the operand
// numbers of a[0..3], the descriptor and the scale-d flag that follow them.
#define WGMMA_TF32(N, DS, DC, A0, A1, A2, A3, B, S)                         \
  template <>                                                               \
  __device__ __forceinline__ void wgmma_tf32<N>(                            \
      float* d, const uint32_t (&a)[4], uint64_t desc) {                    \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" S ", 0;\n"            \
                 "wgmma.mma_async.sync.aligned.m64n" #N                     \
                 "k8.f32.tf32.tf32 {" DS "}, {%" A0 ", %" A1 ", %" A2       \
                 ", %" A3 "}, %" B ", p, 1, 1;\n}\n"                        \
                 : DC                                                       \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),   \
                   "r"(1));                                                 \
  }

WGMMA_TF32(8, WG_D4, WG_C4, "4", "5", "6", "7", "8", "9")
WGMMA_TF32(16, WG_D8, WG_C8, "8", "9", "10", "11", "12", "13")
WGMMA_TF32(24, WG_D12, WG_C12, "12", "13", "14", "15", "16", "17")
WGMMA_TF32(32, WG_D16, WG_C16, "16", "17", "18", "19", "20", "21")
WGMMA_TF32(40, WG_D20, WG_C20, "20", "21", "22", "23", "24", "25")
WGMMA_TF32(48, WG_D24, WG_C24, "24", "25", "26", "27", "28", "29")
WGMMA_TF32(56, WG_D28, WG_C28, "28", "29", "30", "31", "32", "33")
WGMMA_TF32(64, WG_D32, WG_C32, "32", "33", "34", "35", "36", "37")
