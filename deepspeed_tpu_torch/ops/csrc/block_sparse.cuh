// Device code shared by the block-sparse attention kernels: K4 (forward,
// block_sparse_fwd.cu) and K5/K6 (dq and dk/dv, block_sparse_bwd.cu).
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
// col_order for the column lists; entry h * n + tile). The tensor-core K5 and
// K6 take their list from it through blockIdx.x, the batch rows of one entry
// in consecutive blocks; every block still walks its own list in ascending
// order, so the order decides when a block runs and never the order of a sum.
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

// kThreads (128), to_f32 and from_f32 come from here, as do the tensor-core
// pieces (swizzled cp.async tiles, wgmma descriptors and wrappers, pack2)
// of K5's and K6's tensor-core variants
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

}  // namespace bsa
