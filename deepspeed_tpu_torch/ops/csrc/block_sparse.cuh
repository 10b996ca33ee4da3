// Device code shared by the block-sparse attention kernels: K4 (forward,
// block_sparse_fwd.cu) and K5/K6 (dq and dk/dv, block_sparse_bwd.cu), in
// both variants: the FMA kernels' tiles and row reductions, and the
// tensor-core kernels' split of an f32 operand into 16-bit parts and their
// products (end of file).
//
// Tiles. The kernels work on square TILE x TILE score tiles, TILE = min(b, 64)
// for the layout block b in {16, 32, 64, 128}; the host splits each layout
// block into (b / TILE)^2 such tiles before it builds the tile lists, so the
// kernels never see b. Sequence lengths are multiples of b, so no tile has a
// ragged edge.
//
// Tile lists. Which tiles a block visits comes from the host, built once per
// (layout, causal) and kept on the card (block_sparse_attention.tile_lists):
// CSR-style offsets and indices, per head,
//   row_ptr, cols: the live k-tiles of each (head, q-tile), ascending  (K4, K5)
//   col_ptr, rows: the live q-tiles of each (head, k-tile), ascending  (K6)
// Under causal the host drops the tiles wholly above the diagonal (ki > qi):
// in the TPU kernels such a tile adds exp(-1e30 - m) = 0 to the forward sum
// and p = 0 to the gradients, so the result is the same. The diagonal tile
// (ki == qi) is the only one left that needs the causal mask.
//
// Launch order. Beside the lists the host keeps an order of the (head, tile)
// lists for each list kind, longest list first (row_order for the row lists,
// col_order for the column lists; entry h * n + tile). The tensor-core K4, K5
// and K6 take their list from it through blockIdx.x, the batch rows of one
// entry in consecutive blocks; every block still walks its own list in
// ascending order, so the order decides when a block runs and never the order
// of a sum.
//
// Threads (the FMA kernels). 128 threads own a TILE x TILE score tile as 16 row groups x 8
// column groups: thread (rg, cg) holds rows rg * R + i (i < R) and columns
// cg + 8 * c (c < C), R = TILE / 16, C = TILE / 8, and output dimensions
// cg + 8 * j (j < HD / 8). The 8 lanes of a row group are neighbours in one
// warp, so row reductions are three xor shuffles.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// kThreads (128), to_f32 and from_f32 come from here, as do the tensor-core
// building blocks (swizzled cp.async tiles, wgmma descriptors and wrappers,
// pack2) of the tensor-core K4, K5 and K6
#include "flash_sm90.cuh"

namespace bsa {

constexpr float kNegInf = -1e30f;

template <int TILE>
struct Geom {
  static_assert(TILE == 16 || TILE == 32 || TILE == 64, "tile of 16, 32 or 64 rows");
  static constexpr int R = TILE / 16;  // score rows per thread
  static constexpr int C = TILE / 8;   // score columns per thread
  static constexpr int SP = TILE + 1;  // padded row of a score tile in shared memory
};

struct Strides {
  long long q[3], k[3], v[3], o[3];  // (batch, seq, head) in elements; o is do's
};

// rows r0 .. r0 + TILE - 1 of one head of a (B, S, H, hd) tensor into an f32
// tile with rows padded by one float (column walks then hit distinct banks)
template <typename T, int HD, int TILE>
__device__ __forceinline__ void load_tile(float* dst, const T* base, long long row_stride,
                                          int r0) {
  for (int i = threadIdx.x; i < TILE * HD; i += kThreads) {
    const int r = i / HD, d = i - (i / HD) * HD;
    dst[r * (HD + 1) + d] = to_f32(base[static_cast<long long>(r0 + r) * row_stride + d]);
  }
}

// TILE values of one (batch, head) row of a contiguous (B, H, S) f32 tensor
template <int TILE>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long at) {
  for (int r = threadIdx.x; r < TILE; r += kThreads) dst[r] = src[at + r];
}

__device__ __forceinline__ float row_max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float row_sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// ---------------------------------------------------------------------------
// tensor-core pieces of K4, K5 and K6 (float16 / bfloat16, tile 64)
// ---------------------------------------------------------------------------

// The f32 operands p and ds reach the tensor cores as kParts 16-bit parts:
// part 0 = round16(x), each next part round16 of what the parts so far leave
// (exact in f32: the bits of x they drop), all multiplied by the same 16-bit
// partner into one f32 accumulator. Three bfloat16 parts keep x to about
// 2^-26 relative, below f32's own rounding (two parts, 2^-17, left several
// times more output roundings off the exact ones than the f32 plain version
// leaves); two float16 parts keep it to about 2^-23.
template <typename T>
constexpr int kParts = std::is_same<T, __half>::value ? 2 : 3;

// float16 has 5 exponent bits: p (at most 1) is scaled by 2^14 so that its
// parts stay in float16's normal range
template <typename T>
__device__ __forceinline__ constexpr float p_scale() {
  return std::is_same<T, __half>::value ? 16384.f : 1.f;
}

template <typename T>
__device__ __forceinline__ void split_pack(float x0, float x1,
                                           uint32_t (&out)[kParts<T>][4][4], int r, int c) {
#pragma unroll
  for (int part = 0; part < kParts<T>; ++part) {
    const float h0 = to_f32(from_f32<T>(x0)), h1 = to_f32(from_f32<T>(x1));
    out[part][r][c] = pack2<T>(h0, h1);
    x0 -= h0;
    x1 -= h1;
  }
}

// the parts of a 64 x 64 f32 operand on the accumulator layout, as the A
// fragments of the products that take it (element pair 4j + 2e of a thread
// is register (j % 2) * 2 + e of k-step j / 2)
template <typename T>
__device__ __forceinline__ void split_rows(const float (&x)[32],
                                           uint32_t (&out)[kParts<T>][4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      split_pack<T>(x[4 * j + 2 * e], x[4 * j + 2 * e + 1], out, j >> 1, (j & 1) * 2 + e);
#pragma unroll
  for (int part = 0; part < kParts<T>; ++part) fence_regs(out[part]);
}

// acc += (sum of A's parts) B. The tensor cores do not round their f32 sums
// to nearest: over a long list, products added straight into acc drift
// towards zero, further than the plain version's f32 sum strays. So each
// 64-column panel's tile product (kParts x 4 wgmma steps) is summed from
// zero in its own accumulator t and added to acc in f32, rounding to
// nearest; the sum over the list is then an f32 sum as the plain version's.
template <typename T, int NP>
__device__ __forceinline__ void add_product(float (&acc)[NP][32],
                                            const uint32_t (&a)[kParts<T>][4][4], uint32_t b) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    float t[1][32];
#pragma unroll
    for (int i = 0; i < 32; ++i) t[0][i] = 0.f;
    fence_regs(t[0]);
    wgmma_fence();
#pragma unroll
    for (int part = 0; part < kParts<T>; ++part)
      product_mn_major<T, 1>(t, a[part], b + p * kPanelBytes);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(t[0]);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] += t[0][i];
  }
}

// s = A B^T and dp = C D^T over HD columns, all four tiles K-major. At head
// dim 128 each 64-column panel is summed by the tensor cores from zero and
// the two are added in f32, so that no truncating sum runs over more than
// the 4 steps of one panel, as at head dim 64.
template <typename T, int HD>
__device__ __forceinline__ void scores(float (&s)[32], float (&dp)[32], uint32_t a, uint32_t b,
                                       uint32_t c, uint32_t d) {
  if constexpr (Tile<HD>::panels == 1) {
    wgmma_fence();
    product_k_major<T, HD>(s, a, b);
    product_k_major<T, HD>(dp, c, d);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
  } else {
    static_assert(Tile<HD>::panels == 2, "head dims up to 128");
    float s1[32], dp1[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s1[i] = dp1[i] = 0.f;
    fence_regs(s1);
    fence_regs(dp1);
    wgmma_fence();
    product_k_major<T, kPanel>(s, a, b);
    product_k_major<T, kPanel>(dp, c, d);
    product_k_major<T, kPanel>(s1, a + kPanelBytes, b + kPanelBytes);
    product_k_major<T, kPanel>(dp1, c + kPanelBytes, d + kPanelBytes);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
    fence_regs(s1);
    fence_regs(dp1);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] += s1[i];
      dp[i] += dp1[i];
    }
  }
}

// s = A B^T over HD columns, both tiles K-major (K4's S = Q K^T), summed as
// the two-product scores above: at head dim 128 each 64-column panel from
// zero, the two added in f32
template <typename T, int HD>
__device__ __forceinline__ void scores(float (&s)[32], uint32_t a, uint32_t b) {
  if constexpr (Tile<HD>::panels == 1) {
    wgmma_fence();
    product_k_major<T, HD>(s, a, b);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
  } else {
    static_assert(Tile<HD>::panels == 2, "head dims up to 128");
    float s1[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s1[i] = 0.f;
    fence_regs(s1);
    wgmma_fence();
    product_k_major<T, kPanel>(s, a, b);
    product_k_major<T, kPanel>(s1, a + kPanelBytes, b + kPanelBytes);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(s1);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] += s1[i];
  }
}

}  // namespace bsa
