// Block-sparse attention backward for Hopper (sm_90a), hand-written CUDA C++:
// dq (K5) and dk/dv (K6).
//
// Replaces the TPU kernels
// deepspeed_tpu/ops/pallas/block_sparse_attention.py::_sparse_dq_kernel and
// ::_sparse_dkv_kernel (both driven by _bwd). Over the pairs of the tiles
// whose layout entry is nonzero (and, when causal, kpos <= qpos), with
// s = q k^T * sm_scale, p = exp(s - lse) from the forward's f32 lse, and
// delta = rowsum(do * o) (computed by the caller in f32, as _bwd does, :172):
//     ds = p (do v^T - delta) sm_scale
//     dq = sum_k ds k,     dk = sum_q ds^T q,     dv = sum_q p^T do
// All arithmetic is f32, as in the TPU kernels, which upcast q, k, v and do
// before every dot (:78-81, :109-112): p and ds are never rounded to the
// input dtype (unlike the flash backward K2/K3, whose TPU kernels round
// them), and dq, dk and dv are rounded to the input dtype once, at the
// store. There is no GQA in the kernels: the model repeats the kv heads
// before the call, as the JAX package does (models/transformer.py:541-543),
// and autograd sums the group.
//
// Two variants, chosen from (dtype, tile) alone, as
// block_sparse_attention.kernel_variant reports them; never a fallback: a
// launch that fails is an error and the caller raises.
//  - float16 / bfloat16 at tile 64 (layout blocks 64 and 128): the
//    tensor-core kernels block_sparse_bwd_{dq,dkv}_kernel_wgmma below;
//  - float32, and tiles 16 and 32 (a wgmma needs 64 rows): the FMA kernels
//    block_sparse_bwd_{dq,dkv}_kernel.
//
// Tensor-core design (the pieces are flash_sm90.cuh's, shared with K1-K3,
// and block_sparse.cuh's, shared with K4).
// One warpgroup (128 threads) per (64-row tile, batch, head), the tile and
// head taken from the host's launch order (longest list first,
// block_sparse.cuh), walking its row's (K5) or column's (K6) list in
// ascending order; at head dim 128 K6 runs one such block for each
// 64-column panel of dK and dV. Tiles of q, k, v and do are
// 128-byte-swizzled 16-bit copies made by cp.async, double buffered over
// the list: the next tile is in flight during this one's products. Every
// product is a wgmma m64n64k16 with f32 accumulators:
//  - K5: S = Q K^T and dP = dO V^T (K-major), p = exp(S sm_scale - lse) and
//    ds = p (dP - delta) sm_scale in f32 on the accumulator layout, then
//    dQ += ds K with K read MN-major from the copy that fed Q K^T.
//  - K6: S^T = K Q^T and dP^T = V dO^T, p^T and ds^T likewise, then
//    dV += p^T dO and dK += ds^T Q with dO and Q read MN-major.
// The TPU kernels' dots are f32. q k^T and do v^T multiply two 16-bit
// inputs, whose products are exact in f32, so the tensor cores take them as
// they are. p and ds are f32 values: each is split into 16-bit parts (three
// in bfloat16, two in float16: split_pack) that go through the same product
// into one f32 accumulator, which keeps it below f32's own rounding, at 5
// products a pair in K5 (3 in f32) and 8 in K6 (4 in f32). The parts are
// packed from the accumulators straight into the next product's A
// fragments (pack2) and never pass through shared memory. The tensor cores
// do not round their sums to nearest, so no sum of theirs runs longer than
// one 64-wide panel: S and dP add their panels in f32 (scores), each tile's
// ds K, p^T dO and ds^T Q is summed from zero and added to the running
// gradient in f32 (add_product), and p = exp(s sm_scale - lse) is rounded
// step by step as the plain version computes it. In float16, rows of ds are
// scaled by powers of two and p by 2^14 so that the parts stay in its
// normal range (scale_rows). dq, dk and dv are rounded once, at the store.
//
// FMA design (float32, tiles 16 and 32). 128 threads per block; tiles, tile
// lists and the thread layout as in block_sparse.cuh. The TPU grids walk
// every tile of a row (K5) or a column (K6) and test the layout at each
// (:76, :107); here a block walks only its list, in ascending order:
//  - K5: one block per (query tile, batch * head), over the live k-tiles of
//    its row; dq stays in registers and is written once.
//  - K6: one block per (key tile, batch * head), over the live q-tiles of its
//    column (the transposed lists); dk and dv stay in registers and are
//    written once.
// Nothing is carried between blocks in either variant: no atomics and no
// second pass, so two calls give the same bits. Under causal the lists hold
// no tile above the diagonal (those add p = 0).
//
// What bounds it on an H100. K5 does 6 * hd FLOPs per pair the layout and
// the mask let through (q k^T, do v^T, ds k), K6 8 * hd (q k^T, do v^T,
// p^T do, ds^T q); each reads q, k, v and do once, plus lse and delta, and
// writes its gradients once. At the training shape (B2 S4096 H12 hd64 bf16,
// fixed layout, causal) that is 23 and 31 GFLOP over 64 and 76 MB: just
// above the bf16 ridge, so the bound is the tensor-core rate, 23 and 31 us;
// with the split parts the tensor cores do 5/3 and 2x that. The f32 CUDA-core
// rate, the FMA kernels' ceiling, puts the same work at 0.34 and 0.46 ms.
// K6's columns differ in length (a global column of the fixed layout is live
// in every row below it); the launch order starts the long ones first.
//
// Interface: plain C, loaded with ctypes. Strides are in elements, the last
// dimension of q, k, v and do must be contiguous (for the tensor-core
// variant also 16-byte aligned rows: base addresses a multiple of 16 bytes,
// strides of 8 elements); lse and delta are contiguous (B, H, Sq) f32; dq is
// a contiguous (B, Sq, H, hd) tensor, dk and dv contiguous (B, Sk, H, hd).
// Launches go on the caller's stream; the return value is
// cudaGetLastError().

#include <stdint.h>

#include <type_traits>

#include "block_sparse.cuh"

namespace {

using namespace bsa;

template <int HD, int TILE>
constexpr int dq_smem_floats() {
  return 4 * TILE * (HD + 1) + TILE * Geom<TILE>::SP + 2 * TILE;
}

template <int HD, int TILE>
constexpr int dkv_smem_floats() {
  return 4 * TILE * (HD + 1) + 2 * TILE * Geom<TILE>::SP + 2 * TILE;
}

// K5: dq for one query tile of one (batch, head)
template <typename T, int HD, int TILE>
__global__ void __launch_bounds__(kThreads)
block_sparse_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           T* __restrict__ dq, const int* __restrict__ row_ptr,
                           const int* __restrict__ cols, int H, int Sq, int nq, Strides st,
                           float sm_scale, int causal) {
  constexpr int P = HD + 1;
  constexpr int R = Geom<TILE>::R, C = Geom<TILE>::C, SP = Geom<TILE>::SP;
  constexpr int DT = HD / 8;
  extern __shared__ float smem[];
  float* Qs = smem;                  // TILE x P
  float* dOs = Qs + TILE * P;        // TILE x P
  float* Ks = dOs + TILE * P;        // TILE x P
  float* Vs = Ks + TILE * P;         // TILE x P
  float* dSs = Vs + TILE * P;        // TILE x SP
  float* lse_s = dSs + TILE * SP;    // TILE
  float* delta_s = lse_s + TILE;     // TILE

  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // query rows rg*R .. rg*R+R-1
  const int cg = tid & 7;   // keys cg + 8*c of the key tile, dims cg + 8*j of dq
  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = qt * TILE;

  load_tile<T, HD, TILE>(Qs, q + b * st.q[0] + h * st.q[2], st.q[1], q0);
  load_tile<T, HD, TILE>(dOs, dout + b * st.o[0] + h * st.o[2], st.o[1], q0);
  load_rows<TILE>(lse_s, lse, static_cast<long long>(bh) * Sq + q0);
  load_rows<TILE>(delta_s, delta, static_cast<long long>(bh) * Sq + q0);
  const T* kb = k + b * st.k[0] + h * st.k[2];
  const T* vb = v + b * st.v[0] + h * st.v[2];

  float acc[R][DT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DT; ++j) acc[i][j] = 0.f;

  const int e_end = row_ptr[h * nq + qt + 1];
  for (int e = row_ptr[h * nq + qt]; e < e_end; ++e) {
    const int k0 = cols[e] * TILE;
    const bool diag = causal && k0 == q0;
    __syncthreads();  // the previous tile's Ks / dSs reads are done (and Qs / dOs are loaded)
    load_tile<T, HD, TILE>(Ks, kb, st.k[1], k0);
    load_tile<T, HD, TILE>(Vs, vb, st.v[1], k0);
    __syncthreads();

    float sc[R][C], dp[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) sc[i][c] = dp[i][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; ++d) {
      float qv[R], ov[R], kv[C], vv[C];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qv[i] = Qs[(rg * R + i) * P + d];
        ov[i] = dOs[(rg * R + i) * P + d];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        kv[c] = Ks[(cg + 8 * c) * P + d];
        vv[c] = Vs[(cg + 8 * c) * P + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          sc[i][c] = fmaf(qv[i], kv[c], sc[i][c]);
          dp[i][c] = fmaf(ov[i], vv[c], dp[i][c]);
        }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = rg * R + i;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int kc = cg + 8 * c;
        // a masked pair's exp(-1e30 - lse) is exactly 0 in the TPU kernel
        const float p = (diag && kc > r) ? 0.f : expf(sc[i][c] * sm_scale - lse_s[r]);
        dSs[r * SP + kc] = p * (dp[i][c] - delta_s[r]) * sm_scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < TILE; ++kk) {
      float dsv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) dsv[i] = dSs[(rg * R + i) * SP + kk];
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const float kv = Ks[kk * P + cg + 8 * j];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qpos = q0 + rg * R + i;
    T* row = dq + ((static_cast<long long>(b) * Sq + qpos) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < DT; ++j) row[cg + 8 * j] = from_f32<T>(acc[i][j]);
  }
}

// K6: dk and dv for one key tile of one (batch, head)
template <typename T, int HD, int TILE>
__global__ void __launch_bounds__(kThreads)
block_sparse_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            T* __restrict__ dk, T* __restrict__ dv,
                            const int* __restrict__ col_ptr, const int* __restrict__ rows, int H,
                            int Sq, int Sk, int nk, Strides st, float sm_scale, int causal) {
  constexpr int P = HD + 1;
  constexpr int R = Geom<TILE>::R, C = Geom<TILE>::C, SP = Geom<TILE>::SP;
  constexpr int DT = HD / 8;
  extern __shared__ float smem[];
  float* Ks = smem;                  // TILE x P
  float* Vs = Ks + TILE * P;         // TILE x P
  float* Qs = Vs + TILE * P;         // TILE x P
  float* dOs = Qs + TILE * P;        // TILE x P
  float* Ps = dOs + TILE * P;        // TILE (keys) x SP (queries)
  float* dSs = Ps + TILE * SP;       // TILE x SP
  float* lse_s = dSs + TILE * SP;    // TILE
  float* delta_s = lse_s + TILE;     // TILE

  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // key rows rg*R .. rg*R+R-1
  const int cg = tid & 7;   // queries cg + 8*c of the query tile, dims cg + 8*j of dk/dv
  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = kt * TILE;

  load_tile<T, HD, TILE>(Ks, k + b * st.k[0] + h * st.k[2], st.k[1], k0);
  load_tile<T, HD, TILE>(Vs, v + b * st.v[0] + h * st.v[2], st.v[1], k0);
  const T* qb = q + b * st.q[0] + h * st.q[2];
  const T* ob = dout + b * st.o[0] + h * st.o[2];

  float dk_acc[R][DT], dv_acc[R][DT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int e_end = col_ptr[h * nk + kt + 1];
  for (int e = col_ptr[h * nk + kt]; e < e_end; ++e) {
    const int q0 = rows[e] * TILE;
    const bool diag = causal && q0 == k0;
    __syncthreads();  // the previous tile's Qs / dOs / Ps / dSs reads are done
    load_tile<T, HD, TILE>(Qs, qb, st.q[1], q0);
    load_tile<T, HD, TILE>(dOs, ob, st.o[1], q0);
    load_rows<TILE>(lse_s, lse, static_cast<long long>(bh) * Sq + q0);
    load_rows<TILE>(delta_s, delta, static_cast<long long>(bh) * Sq + q0);
    __syncthreads();

    // p^T for this thread's R keys x C queries
    {
      float sc[R][C];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) sc[i][c] = 0.f;
#pragma unroll 2
      for (int d = 0; d < HD; ++d) {
        float kv[R], qv[C];
#pragma unroll
        for (int i = 0; i < R; ++i) kv[i] = Ks[(rg * R + i) * P + d];
#pragma unroll
        for (int c = 0; c < C; ++c) qv[c] = Qs[(cg + 8 * c) * P + d];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < C; ++c) sc[i][c] = fmaf(kv[i], qv[c], sc[i][c]);
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int qr = cg + 8 * c;
          const int kr = rg * R + i;
          Ps[kr * SP + qr] = (diag && kr > qr) ? 0.f : expf(sc[i][c] * sm_scale - lse_s[qr]);
        }
    }
    // ds^T = p^T (dp^T - delta) sm_scale
    {
      float dp[R][C];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) dp[i][c] = 0.f;
#pragma unroll 2
      for (int d = 0; d < HD; ++d) {
        float vv[R], ov[C];
#pragma unroll
        for (int i = 0; i < R; ++i) vv[i] = Vs[(rg * R + i) * P + d];
#pragma unroll
        for (int c = 0; c < C; ++c) ov[c] = dOs[(cg + 8 * c) * P + d];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < C; ++c) dp[i][c] = fmaf(vv[i], ov[c], dp[i][c]);
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int qr = cg + 8 * c;
          const int at = (rg * R + i) * SP + qr;  // this thread's own Ps entry
          dSs[at] = Ps[at] * (dp[i][c] - delta_s[qr]) * sm_scale;
        }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < TILE; ++qq) {
      float pv[R], dsv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pv[i] = Ps[(rg * R + i) * SP + qq];
        dsv[i] = dSs[(rg * R + i) * SP + qq];
      }
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const float ov = dOs[qq * P + cg + 8 * j];
        const float qv = Qs[qq * P + cg + 8 * j];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          dv_acc[i][j] = fmaf(pv[i], ov, dv_acc[i][j]);
          dk_acc[i][j] = fmaf(dsv[i], qv, dk_acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kpos = k0 + rg * R + i;
    const long long at = ((static_cast<long long>(b) * Sk + kpos) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      dk[at + cg + 8 * j] = from_f32<T>(dk_acc[i][j]);
      dv[at + cg + 8 * j] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// tensor-core kernels (float16 / bfloat16, tile 64)
// ---------------------------------------------------------------------------

// float16 has 5 exponent bits: ds's rows are scaled by powers of two
// (scale_rows), starting from 2^60, so that its parts stay in float16's
// normal range (p is scaled by 2^14, p_scale in block_sparse.cuh)
constexpr float kMulStart = 1152921504606846976.f;

// float16 only (bfloat16 has f32's exponent range): scale each of this
// thread's two rows (r0 and r0 + 8) of the f32 operand x by mul[e], a power
// of two that puts the row's largest |x| at or under 2^15 (within 2^-60 ..
// 2^60), so that the parts stay in float16's normal range where they can and
// never overflow. mul only falls, when a tile brings a larger row maximum;
// the row's accumulator, which holds mul times its sum, is scaled by the same
// power of two then, and divided by mul at the store. Every step is exact.
template <typename T, int NP>
__device__ __forceinline__ void scale_rows(float (&x)[32], float (&acc)[NP][32],
                                           float (&mul)[2]) {
  if constexpr (std::is_same<T, __half>::value) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float m = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        m = fmaxf(m, fmaxf(fabsf(x[4 * j + 2 * e]), fabsf(x[4 * j + 2 * e + 1])));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));  // the row's quad
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      // 2^(14 - floor(log2 m)) from m's biased exponent; m = 0 gives 2^60
      const int k = min(60, max(-60, 141 - ((__float_as_int(m) >> 23) & 0xff)));
      const float need = __int_as_float((k + 127) << 23);
      if (need < mul[e]) {
        const float r = need / mul[e];
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[p][4 * j + 2 * e] *= r;
            acc[p][4 * j + 2 * e + 1] *= r;
          }
        mul[e] = need;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        x[4 * j + 2 * e] *= mul[e];
        x[4 * j + 2 * e + 1] *= mul[e];
      }
    }
  }
}

// accumulator element pair (i, i + 1) of row e, rounded to T as a packed pair
template <typename T>
__device__ __forceinline__ uint32_t store_pair(float x0, float x1, float mul) {
  if constexpr (std::is_same<T, __half>::value) {
    x0 /= mul;
    x1 /= mul;
  }
  return pack2<T>(x0, x1);
}

// p = exp(s sm_scale - lse) for a score s of the accumulator, rounded step
// by step as the plain version computes it
__device__ __forceinline__ float softmax_p(float s, float sm_scale, float lse) {
  return expf(__fsub_rn(__fmul_rn(s, sm_scale), lse));
}

template <int HD>
constexpr int dq_wgmma_smem() {
  return 1024 + 6 * Tile<HD>::bytes;  // alignment slack, Q, dO, 2 x (K, V)
}

// K5: dq for one 64-row query tile of one (batch, head): batch row
// blockIdx.x % B of the (head, tile) that order[blockIdx.x / B] names
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
block_sparse_bwd_dq_kernel_wgmma(const T* __restrict__ q, const T* __restrict__ k,
                                 const T* __restrict__ v, const T* __restrict__ dout,
                                 const float* __restrict__ lse, const float* __restrict__ delta,
                                 T* __restrict__ dq, const int* __restrict__ row_ptr,
                                 const int* __restrict__ cols, const int* __restrict__ order,
                                 int B, int H, int Sq, int Sk, int nq, Strides st,
                                 float sm_scale, int causal) {
  constexpr int NP = Tile<HD>::panels;
  constexpr int TB = Tile<HD>::bytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sdO = sQ + TB;
  const uint32_t sKV = sdO + TB;  // buffer i: K at sKV + 2 i TB, V after it

  const int tid = threadIdx.x;
  const int r0 = (tid >> 5) * 16 + ((tid & 31) >> 2);  // rows r0, r0 + 8
  const int c0 = (tid & 3) * 2;                         // columns 8j + c0 + t
  const int code = order[blockIdx.x / B];               // h * nq + qt
  const int b = blockIdx.x % B;
  const int h = code / nq;
  const int qt = code - h * nq;
  const int bh = b * H + h;
  const int q0 = qt * kBlock;

  const T* kb = k + b * st.k[0] + h * st.k[2];
  const T* vb = v + b * st.v[0] + h * st.v[2];
  load_tile_async<T, HD>(sQ, q + b * st.q[0] + h * st.q[2], st.q[1], q0, Sq);
  load_tile_async<T, HD>(sdO, dout + b * st.o[0] + h * st.o[2], st.o[1], q0, Sq);
  const int e0 = row_ptr[h * nq + qt];
  const int n = row_ptr[h * nq + qt + 1] - e0;
  if (n > 0) {
    load_tile_async<T, HD>(sKV, kb, st.k[1], cols[e0] * kBlock, Sk);
    load_tile_async<T, HD>(sKV + TB, vb, st.v[1], cols[e0] * kBlock, Sk);
  }
  cp_async_commit();

  float lse_r[2], dlt[2];  // rows r0, r0 + 8
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const long long at = static_cast<long long>(bh) * Sq + q0 + r0 + 8 * e;
    lse_r[e] = lse[at];
    dlt[e] = delta[at];
  }

  float acc[NP][32], s[32], dp[32];
  float mul[2] = {kMulStart, kMulStart};  // float16: the rows' scales (scale_rows)
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = dp[i] = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) acc[p][i] = 0.f;
  }

  for (int it = 0; it < n; ++it) {
    const int k0 = cols[e0 + it] * kBlock;
    const uint32_t sK = sKV + (it & 1) * 2 * TB;
    __syncthreads();  // every thread is done with the buffer the prefetch overwrites
    if (it + 1 < n) {
      const uint32_t nK = sKV + ((it + 1) & 1) * 2 * TB;
      const int nk0 = cols[e0 + it + 1] * kBlock;
      load_tile_async<T, HD>(nK, kb, st.k[1], nk0, Sk);
      load_tile_async<T, HD>(nK + TB, vb, st.v[1], nk0, Sk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the prefetch: Q, dO and this tile are here
    fence_async_smem();
    __syncthreads();

    scores<T, HD>(s, dp, sQ, sK, sdO, sK + TB);

    // ds = p (dp - delta) sm_scale in f32, in place of dp; its parts are the
    // A fragments of ds k
    const bool diag = causal && k0 == q0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int e = (i >> 1) & 1;
      // a masked pair's exp(-1e30 - lse) is exactly 0 in the TPU kernel
      const float p = (diag && 8 * (i >> 2) + c0 + (i & 1) > r0 + 8 * e)
                          ? 0.f : softmax_p(s[i], sm_scale, lse_r[e]);
      dp[i] = p * (dp[i] - dlt[e]) * sm_scale;
    }
    scale_rows<T, NP>(dp, acc, mul);
    uint32_t a[kParts<T>][4][4];
    split_rows<T>(dp, a);
    add_product<T, NP>(acc, a, sK);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qpos = q0 + r0 + 8 * e;
    T* row = dq + ((static_cast<long long>(b) * Sq + qpos) * H + h) * HD;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = p * kPanel + 8 * j + c0;
        if (col < HD)
          *reinterpret_cast<uint32_t*>(row + col) =
              store_pair<T>(acc[p][4 * j + 2 * e], acc[p][4 * j + 2 * e + 1], mul[e]);
      }
  }
}

template <int HD>
__host__ __device__ constexpr int dkv_wgmma_step_bytes() {
  // Q, dO, then lse and delta (512 bytes) padded so that every tile stays 1024-aligned
  return 2 * Tile<HD>::bytes + 1024;
}

template <int HD>
constexpr int dkv_wgmma_smem() {
  return 1024 + 2 * Tile<HD>::bytes + 2 * dkv_wgmma_step_bytes<HD>();  // slack, K, V, 2 steps
}

// K6: dk and dv for one 64-row key tile of one (batch, head), one
// 64-column panel of them a block (NP = 2 at head dim 128, else 1): panel
// blockIdx.x % NP of batch row (blockIdx.x / NP) % B of the (head, tile)
// that order[blockIdx.x / (NP B)] names. Each panel's block computes S^T and
// dP^T over the whole head dim, so that dK and dV take 64 registers a
// thread at every head dim, and each tile's product is summed in f32.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
block_sparse_bwd_dkv_kernel_wgmma(const T* __restrict__ q, const T* __restrict__ k,
                                  const T* __restrict__ v, const T* __restrict__ dout,
                                  const float* __restrict__ lse, const float* __restrict__ delta,
                                  T* __restrict__ dk, T* __restrict__ dv,
                                  const int* __restrict__ col_ptr, const int* __restrict__ rows,
                                  const int* __restrict__ order, int B, int H, int Sq, int Sk,
                                  int nk, Strides st, float sm_scale, int causal) {
  constexpr int NP = Tile<HD>::panels;
  constexpr int TB = Tile<HD>::bytes;
  constexpr int SB = dkv_wgmma_step_bytes<HD>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023) & ~1023u;
  const uint32_t sV = sK + TB;
  const uint32_t sStep = sV + TB;  // buffer i: Q, dO, lse, delta at sStep + i SB

  const int tid = threadIdx.x;
  const int r0 = (tid >> 5) * 16 + ((tid & 31) >> 2);  // key rows r0, r0 + 8
  const int c0 = (tid & 3) * 2;                         // query columns 8j + c0 + t
  const int panel = blockIdx.x % NP;
  const int code = order[blockIdx.x / (NP * B)];        // h * nk + kt
  const int b = (blockIdx.x / NP) % B;
  const int h = code / nk;
  const int kt = code - h * nk;
  const int bh = b * H + h;
  const int k0 = kt * kBlock;
  const int e0 = col_ptr[h * nk + kt];
  const int n = col_ptr[h * nk + kt + 1] - e0;
  const T* qb = q + b * st.q[0] + h * st.q[2];
  const T* ob = dout + b * st.o[0] + h * st.o[2];
  const float* lse_row = lse + static_cast<long long>(bh) * Sq;
  const float* delta_row = delta + static_cast<long long>(bh) * Sq;

  // the Q, dO, lse and delta of list entry i into buffer i % 2
  auto load_step = [&](int i) {
    const int q0 = rows[e0 + i] * kBlock;
    const uint32_t buf = sStep + (i & 1) * SB;
    load_tile_async<T, HD>(buf, qb, st.q[1], q0, Sq);
    load_tile_async<T, HD>(buf + TB, ob, st.o[1], q0, Sq);
    if (tid < kBlock)
      load_rows_async(buf + 2 * TB, lse_row, q0, Sq, tid);
    else
      load_rows_async(buf + 2 * TB + kBlock * 4, delta_row, q0, Sq, tid - kBlock);
  };

  load_tile_async<T, HD>(sK, k + b * st.k[0] + h * st.k[2], st.k[1], k0, Sk);
  load_tile_async<T, HD>(sV, v + b * st.v[0] + h * st.v[2], st.v[1], k0, Sk);
  if (n > 0) load_step(0);
  cp_async_commit();

  float dka[1][32], dva[1][32], s[32], dp[32];  // dK and dV: this block's panel
  float mul_k[2] = {kMulStart, kMulStart};       // float16: ds^T's row scales (scale_rows)
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = dka[0][i] = dva[0][i] = 0.f;

  for (int it = 0; it < n; ++it) {
    const int q0 = rows[e0 + it] * kBlock;
    const uint32_t buf = sStep + (it & 1) * SB;
    const uint32_t sQ = buf, sdO = buf + TB;
    const float* lse_s = reinterpret_cast<const float*>(smem_raw + (buf + 2 * TB - raw));
    const float* delta_s = lse_s + kBlock;
    __syncthreads();  // every thread is done with the buffer the prefetch overwrites
    if (it + 1 < n) load_step(it + 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the prefetch: K, V and this step are here
    fence_async_smem();
    __syncthreads();

    scores<T, HD>(s, dp, sK, sQ, sV, sdO);  // S^T = K Q^T, dP^T = V dO^T

    // p^T in place of s and ds^T = p^T (dp^T - delta) sm_scale in place of
    // dp, in f32; their parts are the A fragments of p^T dO and ds^T Q
    const bool diag = causal && q0 == k0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qc = 8 * (i >> 2) + c0 + (i & 1);
      const float p = (diag && r0 + 8 * ((i >> 1) & 1) > qc)
                          ? 0.f : softmax_p(s[i], sm_scale, lse_s[qc]);
      dp[i] = p * (dp[i] - delta_s[qc]) * sm_scale;
      s[i] = p * p_scale<T>();
    }
    uint32_t pa[kParts<T>][4][4];
    split_rows<T>(s, pa);
    add_product<T, 1>(dva, pa, sdO + panel * kPanelBytes);  // dV += p^T dO
    // ds^T's parts only now, when pa's registers are free: the fence keeps
    // the compiler from splitting dp ahead of dV's products
    fence_regs(dp);
    scale_rows<T, 1>(dp, dka, mul_k);
    uint32_t da[kParts<T>][4][4];
    split_rows<T>(dp, da);
    add_product<T, 1>(dka, da, sQ + panel * kPanelBytes);  // dK += ds^T Q
  }
  cp_async_wait<0>();

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int kpos = k0 + r0 + 8 * e;
    const long long at = ((static_cast<long long>(b) * Sk + kpos) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = panel * kPanel + 8 * j + c0;
      if (col >= HD) continue;
      const int i = 4 * j + 2 * e;
      *reinterpret_cast<uint32_t*>(dk + at + col) =
          store_pair<T>(dka[0][i], dka[0][i + 1], mul_k[e]);
      *reinterpret_cast<uint32_t*>(dv + at + col) =
          store_pair<T>(dva[0][i], dva[0][i + 1], p_scale<T>());
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  const int *ptr, *idx;  // the row lists (K5) or the column lists (K6)
  const int* order;      // the tensor-core kernels' launch order of (head, tile)
  int B, H, Sq, Sk, n;   // n: query tiles (K5) or key tiles (K6)
  Strides st;
  float sm_scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int HD, int TILE>
int launch_dq(const Args& a) {
  constexpr int smem = dq_smem_floats<HD, TILE>() * static_cast<int>(sizeof(float));
  // above 48 KB of shared memory a block needs the opt-in
  cudaError_t err = cudaFuncSetAttribute(block_sparse_bwd_dq_kernel<T, HD, TILE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.n, a.B * a.H);
  block_sparse_bwd_dq_kernel<T, HD, TILE><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dq), a.ptr, a.idx, a.H, a.Sq, a.n,
      a.st, a.sm_scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD, int TILE>
int launch_dkv(const Args& a) {
  constexpr int smem = dkv_smem_floats<HD, TILE>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(block_sparse_bwd_dkv_kernel<T, HD, TILE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.n, a.B * a.H);
  block_sparse_bwd_dkv_kernel<T, HD, TILE><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.ptr,
      a.idx, a.H, a.Sq, a.Sk, a.n, a.st, a.sm_scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dq_wgmma(const Args& a) {
  constexpr int smem = dq_wgmma_smem<HD>();
  cudaError_t err = cudaFuncSetAttribute(block_sparse_bwd_dq_kernel_wgmma<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  block_sparse_bwd_dq_kernel_wgmma<T, HD><<<a.B * a.H * a.n, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dq), a.ptr, a.idx, a.order, a.B,
      a.H, a.Sq, a.Sk, a.n, a.st, a.sm_scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dkv_wgmma(const Args& a) {
  constexpr int smem = dkv_wgmma_smem<HD>();
  cudaError_t err = cudaFuncSetAttribute(block_sparse_bwd_dkv_kernel_wgmma<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = a.B * a.H * a.n * Tile<HD>::panels;  // a block per dK/dV panel
  block_sparse_bwd_dkv_kernel_wgmma<T, HD><<<blocks, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.ptr,
      a.idx, a.order, a.B, a.H, a.Sq, a.Sk, a.n, a.st, a.sm_scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

// the variant by (dtype, tile), as block_sparse_attention.kernel_variant:
// the tensor-core kernels for 16-bit inputs at tile 64, the FMA kernels for
// float32 and for tiles 16 and 32
template <typename T, int HD, bool DQ>
int dispatch_tile(int tile, const Args& a) {
  switch (tile) {
    case 16: return DQ ? launch_dq<T, HD, 16>(a) : launch_dkv<T, HD, 16>(a);
    case 32: return DQ ? launch_dq<T, HD, 32>(a) : launch_dkv<T, HD, 32>(a);
    case 64:
      if constexpr (std::is_same<T, float>::value)
        return DQ ? launch_dq<T, HD, 64>(a) : launch_dkv<T, HD, 64>(a);
      else
        return DQ ? launch_dq_wgmma<T, HD>(a) : launch_dkv_wgmma<T, HD>(a);
    default: return -1;
  }
}

template <typename T, bool DQ>
int dispatch_hd(int hd, int tile, const Args& a) {
  switch (hd) {
    case 16: return dispatch_tile<T, 16, DQ>(tile, a);
    case 32: return dispatch_tile<T, 32, DQ>(tile, a);
    case 64: return dispatch_tile<T, 64, DQ>(tile, a);
    case 128: return dispatch_tile<T, 128, DQ>(tile, a);
    default: return -1;
  }
}

template <bool DQ>
int dispatch(int dtype, int hd, int tile, const Args& a) {
  switch (dtype) {
    case 0: return dispatch_hd<float, DQ>(hd, tile, a);
    case 1: return dispatch_hd<__half, DQ>(hd, tile, a);
    case 2: return dispatch_hd<__nv_bfloat16, DQ>(hd, tile, a);
    default: return -1;
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* ptr, const void* idx, const void* order, int B,
               int H, int Sq, int Sk, int n, const long long* strides, float sm_scale,
               int causal, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.ptr = static_cast<const int*>(ptr);
  a.idx = static_cast<const int*>(idx);
  a.order = static_cast<const int*>(order);
  a.B = B; a.H = H; a.Sq = Sq; a.Sk = Sk; a.n = n;
  for (int i = 0; i < 3; ++i) {
    a.st.q[i] = strides[i];
    a.st.k[i] = strides[3 + i];
    a.st.v[i] = strides[6 + i];
    a.st.o[i] = strides[9 + i];
  }
  a.sm_scale = sm_scale; a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16; tile: 16, 32 or 64 rows.
// strides: 12 values, the (batch, seq, head) strides of q, k, v and do in
// that order, in elements. row_ptr/cols are the row lists (H * nq + 1
// offsets), col_ptr/rows the column lists (H * nk + 1 offsets);
// row_order/col_order the launch orders of their (head, tile) lists (H * nq
// or H * nk entries h * n + tile), read by the tensor-core kernels alone.
// Return cudaGetLastError() after the launch, or -1 for a dtype, head size
// or tile the kernels do not take.
extern "C" int dstorch_block_sparse_bwd_dq(int dtype, int hd, int tile, const void* q,
                                           const void* k, const void* v, const void* dout,
                                           const void* lse, const void* delta, void* dq,
                                           const void* row_ptr, const void* cols,
                                           const void* row_order, int B, int H, int Sq, int Sk,
                                           int nq, const long long* strides, float sm_scale,
                                           int causal, void* stream) {
  Args a = make_args(q, k, v, dout, lse, delta, row_ptr, cols, row_order, B, H, Sq, Sk, nq,
                     strides, sm_scale, causal, stream);
  a.dq = dq;
  return dispatch<true>(dtype, hd, tile, a);
}

extern "C" int dstorch_block_sparse_bwd_dkv(int dtype, int hd, int tile, const void* q,
                                            const void* k, const void* v, const void* dout,
                                            const void* lse, const void* delta, void* dk,
                                            void* dv, const void* col_ptr, const void* rows,
                                            const void* col_order, int B, int H, int Sq, int Sk,
                                            int nk, const long long* strides, float sm_scale,
                                            int causal, void* stream) {
  Args a = make_args(q, k, v, dout, lse, delta, col_ptr, rows, col_order, B, H, Sq, Sk, nk,
                     strides, sm_scale, causal, stream);
  a.dk = dk;
  a.dv = dv;
  return dispatch<false>(dtype, hd, tile, a);
}
