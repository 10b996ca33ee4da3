// Building blocks of the flash kernels for Hopper (sm_90a), shared by the
// forward (flash_fwd.cu, K1) and the backward (flash_bwd.cu, K2 and K3).
//
// Tiles are 64 rows (kBlock) and a block is one warpgroup (kThreads = 128).
// A tile of a 16-bit tensor lives in shared memory in the input dtype, in
// 64-column panels of 128-byte rows with the 128-byte swizzle (16-byte chunk
// c of row r at chunk c ^ (r % 8)), 1024-byte aligned: the layout TMA's
// SWIZZLE_128B writes. cp.async writes it (load_tile_async); wgmma reads it
// through descriptors (desc), K-major for the products whose contraction runs
// over the head dim (product_k_major) and MN-major, through the transpose
// bit, for those whose contraction runs over the tile's rows
// (product_mn_major). The f32 accumulator of a 64-row wgmma has, per warp,
// the register layout of the 16-bit A fragment of the next product, so a
// score tile is rounded and packed in registers (pack2) and never passes
// through shared memory. Every helper here is device code; including this
// header adds no kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlock = 64;  // query and key tile rows
constexpr int kThreads = 128;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__half>(__half x) { return __half2float(x); }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool pair_ok(int qpos, int kpos, int Sq, int Sk, int causal,
                                        int window) {
  bool ok = qpos < Sq && kpos < Sk;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && (qpos - kpos < window);
  return ok;
}

constexpr int kPanel = 64;                 // 16-bit columns of one 128-byte swizzled row
constexpr int kPanelBytes = kBlock * 128;  // one 64-row panel
constexpr uint32_t kKMajorLbo = 16;        // unused by a swizzled K-major operand
constexpr uint32_t kMnMajorLbo = 1024;     // one 64-wide atom: only the 8-row groups step
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Tile {
  static constexpr int panels = HD > kPanel ? HD / kPanel : 1;  // hd 16 / 32: one padded panel
  static constexpr int bytes = panels * kPanelBytes;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of the 16-byte chunk c (8 elements) of row r in a swizzled tile
__device__ __forceinline__ uint32_t chunk_offset(int r, int c) {
  return (c >> 3) * kPanelBytes + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// cp.async of 16 (or 4) bytes; when !valid the destination is zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// this thread's shared-memory writes, made visible to wgmma's (async proxy) reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows r0 .. r0+63 of one head of a (B, S, H, hd) tensor into a swizzled
// tile; rows at or past S are zero
template <typename T, int HD>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const T* base, long long row_stride,
                                                int r0, int S) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < kBlock * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i - (i / kChunks) * kChunks;
    const int s = r0 + r;
    const T* src = s < S ? base + s * row_stride + c * 8 : base;
    cp_async16(dst + chunk_offset(r, c), src, s < S);
  }
}

// 64 consecutive f32 values of a (B, H, S) row (lse or delta) from s0; zero past S
__device__ __forceinline__ void load_rows_async(uint32_t dst, const float* row, int s0, int S,
                                                int t) {
  const int s = s0 + t;
  cp_async4(dst + 4 * t, s < S ? row + s : row, s < S);
}

// wgmma descriptor of a 128-byte-swizzled operand at shared address addr;
// 8-row groups are 1024 bytes apart
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of registers that a wgmma
// owns across the fence / wait around it
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j]) :: "memory");
}

#define DSTORCH_D32                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define DSTORCH_D32_OUT(d)                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),      \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),   \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),   \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),   \
      "+f"(d[31])

// d (64 x 64, f32) = A B (+ d when accumulate): A and B from shared memory
// (descriptors da, db), both K-major
#define DSTORCH_WGMMA_SS(TY)                                                            \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                             \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " DSTORCH_D32 \
               ", %32, %33, p, 1, 1, 0, 0;\n}\n"                                        \
               : DSTORCH_D32_OUT(d)                                                     \
               : "l"(da), "l"(db), "r"(accumulate))
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    DSTORCH_WGMMA_SS("bf16");
  } else {
    DSTORCH_WGMMA_SS("f16");
  }
}

// d (64 x 64, f32) += A B: A from registers (a 16-bit A fragment), B from
// shared memory, MN-major (transposed)
#define DSTORCH_WGMMA_RS(TY)                                                            \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                             \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " DSTORCH_D32 \
               ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                          \
               : DSTORCH_D32_OUT(d)                                                     \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    DSTORCH_WGMMA_RS("bf16");
  } else {
    DSTORCH_WGMMA_RS("f16");
  }
}

// S (or S^T) = A B^T over HD columns, both tiles K-major
template <typename T, int HD>
__device__ __forceinline__ void product_k_major(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk >> 2) * kPanelBytes + (kk & 3) * 32;
    wgmma_ss<T>(d, desc(a + off, kKMajorLbo), desc(b + off, kKMajorLbo), kk > 0);
  }
}

// acc += A B over the 64 rows of tile b (the contraction), A the packed
// fragments of a 64 x 64 accumulator, B read MN-major, one 64-column panel
// at a time
template <typename T, int NP>
__device__ __forceinline__ void product_mn_major(float (&acc)[NP][32], const uint32_t (&a)[4][4],
                                                 uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int p = 0; p < NP; ++p)
      wgmma_rs<T>(acc[p], a[kk], desc(b + p * kPanelBytes + kk * 16 * 128, kMnMajorLbo));
}

template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator element 4j + 2e + t of thread (warp w, lane l) is row
// 16w + l/4 + 8e, column 8j + 2(l%4) + t. Its pair (t = 0, 1) is the
// A-fragment register (j % 2) * 2 + e of k-step j / 2.
__device__ __forceinline__ bool tile_unmasked(int q0, int k0, int Sq, int Sk, int causal,
                                              int window) {
  return q0 + kBlock <= Sq && k0 + kBlock <= Sk && (!causal || k0 + kBlock - 1 <= q0) &&
         (window <= 0 || q0 + kBlock - 1 - k0 < window);
}

}  // namespace
