// FlashAttention-2 backward for Hopper (sm_90a), hand-written CUDA C++: two
// kernels, dq (K2) and dk/dv (K3).
//
// Replaces the TPU kernels deepspeed_tpu/ops/pallas/flash_attention.py::_dq_kernel
// and ::_dkv_kernel (both driven by _bwd). With s = q k^T * sm_scale (masked
// to -1e30 where causal / window / the ragged edge forbid the pair),
// p = exp(s - lse) from the forward's f32 lse, and delta = rowsum(do * o)
// (computed by the caller in f32, as _bwd does outside its kernels):
//     dq = sum_k ds k,          ds = p (do v^T - delta) sm_scale
//     dv = sum_q p^T do,        dk = sum_q ds^T q
// Numerics follow the TPU kernels. Products of input-dtype values are exact
// in f32 and summed in f32 (the TPU's bf16 dots with f32 accumulation).
// K2 keeps p in f32 and rounds ds to the input dtype before ds k. K3 rounds
// p to do's dtype before p^T do, computes ds in f32 from that rounded p and
// rounds ds to q's dtype before ds^T q. Accumulators are f32; outputs are in
// the input dtype, rounded once. No atomics: two calls give the same bits.
//
// Two variants, chosen by the input dtype (never as a fallback: a failed
// launch is an error and the caller raises):
//  - float16 / bfloat16: the tensor-core kernels (flash_bwd_dq_kernel_wgmma,
//    flash_bwd_dkv_kernel_wgmma) below;
//  - float32: the FMA kernels (flash_bwd_dq_kernel, flash_bwd_dkv_kernel).
//    On the tensor cores f32 would be TF32, about three decimal digits,
//    where the f32 path is held to 1e-4 of each gradient.
//
// Tensor-core design (its building blocks are in flash_sm90.cuh, shared with
// the forward). One warpgroup (128 threads) per block and 64-row tiles.
// Every product is a wgmma.mma_async m64n64k16 with f32 accumulators:
//  - K2, one block per (64-row query tile, batch * head), loops over the
//    key tiles the mask lets through: S = Q K^T and dP = dO V^T (A and B from
//    shared memory, both K-major), then dQ += dS K with dS in registers and
//    K read MN-major (transposed) from the same copy that fed Q K^T.
//  - K3, one block per (64-row key tile, batch * kv head), loops over the
//    `group` query heads of its kv head and, for each, over the query tiles
//    that see the key tile. Keys are the rows, so the transposes land in
//    registers: S^T = K Q^T and dP^T = V dO^T (K-major), then dV += P^T dO
//    and dK += dS^T Q with Q and dO read MN-major from the copies that fed
//    the first two products.
//  - The f32 accumulator of a 64-row wgmma has, per warp, the register
//    layout of the 16-bit A fragment of the next product: P and dS are
//    rounded and packed in registers and never pass through shared memory.
//  - Tiles live in shared memory in the input dtype, in 64-column panels of
//    128-byte rows with the 128-byte swizzle (16-byte chunk c of row r at
//    chunk c ^ (r % 8)), 1024-byte aligned: the layout TMA's SWIZZLE_128B
//    writes, read by the descriptors below without bank conflicts. Head dims
//    16 and 32 use one panel, padded: their Q K^T-type products step only
//    over the real columns; the accumulating products run 64 wide and the
//    padded columns are never stored.
//  - Loads are cp.async 16-byte copies, double-buffered over K2's key-tile
//    loop and K3's query-tile loop: the next tile is in flight during the
//    current tile's products. cp.async rather than TMA: q, k, v and do are
//    strided views of the fused QKV projection, with the head as the middle
//    axis, so each tile is 64 rows at a row stride of 3 * H * hd; cp.async
//    takes those strides as they are, zero-fills the ragged edge per row,
//    and needs no tensor map made on the host for every call. The copies
//    need 16-byte aligned rows; the wrapper makes a tensor that is not so
//    contiguous before the launch and refuses one that reaches a kernel.
//  - Causal, window and the ragged edge are masked in registers, on the
//    tiles that need it; fully masked tiles are skipped. Under causal
//    masking the grid's slow axis runs the longest tiles first: K2's last
//    query tiles, K3's first key tiles.
//  - GQA: K3's per-head walk is the same for any group. With group > 1 each
//    head's dk/dv partial is rounded to the input dtype and added, in head
//    order, into f32 group totals in shared memory (each thread its own
//    entries), rounded once at the store: the head sum _bwd does outside its
//    kernel (:412-414).
//
// FMA design (float32). 4 warps per block; a thread owns a 4 x 8 register
// tile of the 64 x 64 score block and a 4 x HD/8 tile of its f32
// accumulator; tiles of q, k, v and do are staged in shared memory as f32
// (rows padded by one float so column walks hit distinct banks). The same
// blocks and loops as above; K3 keeps its GQA totals in shared memory too.
// Ragged edges (S not a multiple of 64) are masked in the kernel; q, k, v
// and do are read through strides, so views of a fused QKV projection need
// no copy.
//
// What bounds it on an H100. K2 does 6 * hd FLOPs per (query, key) pair the
// mask lets through (q k^T, do v^T, ds k), K3 8 * hd (q k^T, do v^T, p^T do,
// ds^T q). Both read q, k, v and do once (plus lse and delta) and write
// their gradients once: at hd 64 and causal S = 1024 that is ~256 FLOPs per
// byte, near the ~295 ridge of the bf16 tensor cores, so the bound is the
// tensor-core rate (989 TFLOP/s). A single warpgroup per block that waits
// for each product before the next, and K2's and K3's recomputation of
// q k^T and do v^T, keep these kernels well below it.
//
// Interface: plain C, loaded with ctypes. Strides are in elements, the last
// dimension of q, k, v and do must be contiguous (for 16-bit inputs also
// 16-byte aligned rows: base addresses a multiple of 16 bytes, strides of 8
// elements); lse and delta are contiguous (B, H, Sq) f32; dq is a contiguous
// (B, Sq, H, hd) tensor, dk and dv contiguous (B, Sk, Hkv, hd). Launches go
// on the caller's stream; the return value is cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_sm90.cuh"

namespace {

constexpr int kSP = kBlock + 1;  // padded row of a 64 x 64 score tile

// x rounded to T and back: the TPU kernels' .astype(input dtype) on an f32 value
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

struct Strides {
  long long q[3], k[3], v[3], o[3];  // (batch, seq, head) in elements; o is do's
};

// rows r0 .. r0+63 of one head of a (B, S, H, hd) tensor into a padded f32 tile
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* base, long long row_stride,
                                          int r0, int S) {
  for (int i = threadIdx.x; i < kBlock * HD; i += kThreads) {
    const int r = i / HD, d = i - (i / HD) * HD;
    const int s = r0 + r;
    dst[r * (HD + 1) + d] = s < S ? to_f32(base[s * row_stride + d]) : 0.f;
  }
}

template <int HD>
constexpr int dq_smem_floats() {
  return 4 * kBlock * (HD + 1) + kBlock * kSP + 2 * kBlock;
}

// with GQA (group > 1) the f32 group totals of dk and dv follow: 2 * kBlock * HD
// more floats (at HD 128, 231,424 bytes in all, under the 232,448 a block may use)
template <int HD>
constexpr int dkv_smem_floats(bool group_totals) {
  return 4 * kBlock * (HD + 1) + 2 * kBlock * kSP + 2 * kBlock
         + (group_totals ? 2 * kBlock * HD : 0);
}


// K2 (FMA, float32): dq for one 64-row query tile of one (batch, head)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int H, int group,
                    int Sq, int Sk, Strides st, float sm_scale, int causal, int window) {
  constexpr int P = HD + 1;
  constexpr int DT = HD / 8;
  extern __shared__ float smem[];
  float* Qs = smem;                  // kBlock x P
  float* dOs = Qs + kBlock * P;      // kBlock x P
  float* Ks = dOs + kBlock * P;      // kBlock x P
  float* Vs = Ks + kBlock * P;       // kBlock x P
  float* dSs = Vs + kBlock * P;      // kBlock x kSP
  float* lse_s = dSs + kBlock * kSP;  // kBlock
  float* delta_s = lse_s + kBlock;    // kBlock

  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // query rows rg*4 .. rg*4+3
  const int cg = tid & 7;   // keys cg + 8*c of the key tile, dims cg + 8*j of dq
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / group;
  const int q0 = blockIdx.x * kBlock;

  load_tile<T, HD>(Qs, q + b * st.q[0] + h * st.q[2], st.q[1], q0, Sq);
  load_tile<T, HD>(dOs, dout + b * st.o[0] + h * st.o[2], st.o[1], q0, Sq);
  for (int r = tid; r < kBlock; r += kThreads) {
    const int s = q0 + r;
    lse_s[r] = s < Sq ? lse[static_cast<long long>(bh) * Sq + s] : 0.f;
    delta_s[r] = s < Sq ? delta[static_cast<long long>(bh) * Sq + s] : 0.f;
  }
  const T* kb = k + b * st.k[0] + hk * st.k[2];
  const T* vb = v + b * st.v[0] + hk * st.v[2];

  float acc[4][DT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DT; ++j) acc[i][j] = 0.f;

  // key range this query tile can see: [k_lo, k_hi)
  int k_hi = Sk;
  if (causal) k_hi = min(Sk, q0 + kBlock);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int kt_lo = k_lo / kBlock;
  const int kt_hi = (k_hi + kBlock - 1) / kBlock;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();  // the previous tile's Ks / dSs reads are done (and Qs/dOs are loaded)
    load_tile<T, HD>(Ks, kb, st.k[1], k0, Sk);
    load_tile<T, HD>(Vs, vb, st.v[1], k0, Sk);
    __syncthreads();

    float sc[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) sc[i][c] = dp[i][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; ++d) {
      float qv[4], ov[4], kv[8], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(rg * 4 + i) * P + d];
        ov[i] = dOs[(rg * 4 + i) * P + d];
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        kv[c] = Ks[(cg + 8 * c) * P + d];
        vv[c] = Vs[(cg + 8 * c) * P + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          sc[i][c] = fmaf(qv[i], kv[c], sc[i][c]);
          dp[i][c] = fmaf(ov[i], vv[c], dp[i][c]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int kpos = k0 + cg + 8 * c;
        // a masked pair's exp(-1e30 - lse) is exactly 0 in the TPU kernel
        const float p = pair_ok(q0 + r, kpos, Sq, Sk, causal, window)
                            ? expf(sc[i][c] * sm_scale - lse_s[r]) : 0.f;
        dSs[r * kSP + cg + 8 * c] = round_to<T>(p * (dp[i][c] - delta_s[r]) * sm_scale);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlock; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(rg * 4 + i) * kSP + kk];
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const float kv = Ks[kk * P + cg + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + rg * 4 + i;
    if (qpos < Sq) {
      T* row = dq + ((static_cast<long long>(b) * Sq + qpos) * H + h) * HD;
#pragma unroll
      for (int j = 0; j < DT; ++j) row[cg + 8 * j] = from_f32<T>(acc[i][j]);
    }
  }
}

// K3 (FMA, float32): dk and dv for one 64-row key tile of one (batch, kv
// head), summed over the query heads of its group
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int H, int Hkv, int group, int Sq, int Sk, Strides st, float sm_scale,
                     int causal, int window) {
  constexpr int P = HD + 1;
  constexpr int DT = HD / 8;
  extern __shared__ float smem[];
  float* Ks = smem;                  // kBlock x P
  float* Vs = Ks + kBlock * P;       // kBlock x P
  float* Qs = Vs + kBlock * P;       // kBlock x P
  float* dOs = Qs + kBlock * P;      // kBlock x P
  float* Ps = dOs + kBlock * P;      // kBlock (keys) x kSP (queries)
  float* dSs = Ps + kBlock * kSP;    // kBlock x kSP
  float* lse_s = dSs + kBlock * kSP;  // kBlock
  float* delta_s = lse_s + kBlock;    // kBlock
  float* dk_tot = delta_s + kBlock;   // kBlock x HD, only when group > 1
  float* dv_tot = dk_tot + kBlock * HD;

  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // key rows rg*4 .. rg*4+3
  const int cg = tid & 7;   // queries cg + 8*c of the query tile, dims cg + 8*j of dk/dv
  const int bhk = blockIdx.y;
  const int b = bhk / Hkv;
  const int hk = bhk - b * Hkv;
  const int k0 = blockIdx.x * kBlock;

  load_tile<T, HD>(Ks, k + b * st.k[0] + hk * st.k[2], st.k[1], k0, Sk);
  load_tile<T, HD>(Vs, v + b * st.v[0] + hk * st.v[2], st.v[1], k0, Sk);

  float dk_acc[4][DT], dv_acc[4][DT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      dk_acc[i][j] = dv_acc[i][j] = 0.f;
      // each thread reads and writes only its own total entries: no barrier
      if (group > 1) dk_tot[(rg * 4 + i) * HD + cg + 8 * j] = 0.f;
      if (group > 1) dv_tot[(rg * 4 + i) * HD + cg + 8 * j] = 0.f;
    }

  // query range that can see this key tile: [q_lo, q_hi)
  const int q_lo = causal ? k0 : 0;
  int q_hi = Sq;
  if (window > 0) q_hi = min(Sq, k0 + kBlock + window - 1);
  const int qt_lo = q_lo / kBlock;
  const int qt_hi = (q_hi + kBlock - 1) / kBlock;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long long bh = static_cast<long long>(b) * H + h;
    const T* qb = q + b * st.q[0] + h * st.q[2];
    const T* ob = dout + b * st.o[0] + h * st.o[2];
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * kBlock;
      __syncthreads();  // the previous tile's Qs / dOs / Ps / dSs reads are done
      load_tile<T, HD>(Qs, qb, st.q[1], q0, Sq);
      load_tile<T, HD>(dOs, ob, st.o[1], q0, Sq);
      for (int r = tid; r < kBlock; r += kThreads) {
        const int s = q0 + r;
        lse_s[r] = s < Sq ? lse[bh * Sq + s] : 0.f;
        delta_s[r] = s < Sq ? delta[bh * Sq + s] : 0.f;
      }
      __syncthreads();

      // p^T for this thread's 4 keys x 8 queries, rounded to do's dtype
      {
        float sc[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) sc[i][c] = 0.f;
#pragma unroll 2
        for (int d = 0; d < HD; ++d) {
          float kv[4], qv[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) kv[i] = Ks[(rg * 4 + i) * P + d];
#pragma unroll
          for (int c = 0; c < 8; ++c) qv[c] = Qs[(cg + 8 * c) * P + d];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 8; ++c) sc[i][c] = fmaf(kv[i], qv[c], sc[i][c]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int qr = cg + 8 * c;
            const float p = pair_ok(q0 + qr, k0 + rg * 4 + i, Sq, Sk, causal, window)
                                ? expf(sc[i][c] * sm_scale - lse_s[qr]) : 0.f;
            Ps[(rg * 4 + i) * kSP + qr] = round_to<T>(p);
          }
      }
      // ds^T = p (dp - delta) sm_scale from the rounded p, rounded to q's dtype
      {
        float dp[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) dp[i][c] = 0.f;
#pragma unroll 2
        for (int d = 0; d < HD; ++d) {
          float vv[4], ov[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) vv[i] = Vs[(rg * 4 + i) * P + d];
#pragma unroll
          for (int c = 0; c < 8; ++c) ov[c] = dOs[(cg + 8 * c) * P + d];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 8; ++c) dp[i][c] = fmaf(vv[i], ov[c], dp[i][c]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int qr = cg + 8 * c;
            const int at = (rg * 4 + i) * kSP + qr;  // this thread's own Ps entry
            dSs[at] = round_to<T>(Ps[at] * (dp[i][c] - delta_s[qr]) * sm_scale);
          }
      }
      __syncthreads();

#pragma unroll 4
      for (int qq = 0; qq < kBlock; ++qq) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[(rg * 4 + i) * kSP + qq];
          dsv[i] = dSs[(rg * 4 + i) * kSP + qq];
        }
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          const float ov = dOs[qq * P + cg + 8 * j];
          const float qv = Qs[qq * P + cg + 8 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][j] = fmaf(pv[i], ov, dv_acc[i][j]);
            dk_acc[i][j] = fmaf(dsv[i], qv, dk_acc[i][j]);
          }
        }
      }
    }
    if (group > 1) {  // this head's partial, rounded to the input dtype, into the group total
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          const int at = (rg * 4 + i) * HD + cg + 8 * j;
          dk_tot[at] += round_to<T>(dk_acc[i][j]);
          dv_tot[at] += round_to<T>(dv_acc[i][j]);
          dk_acc[i][j] = dv_acc[i][j] = 0.f;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + rg * 4 + i;
    if (kpos < Sk) {
      const long long at = ((static_cast<long long>(b) * Sk + kpos) * Hkv + hk) * HD;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const int own = (rg * 4 + i) * HD + cg + 8 * j;
        dk[at + cg + 8 * j] = from_f32<T>(group > 1 ? dk_tot[own] : dk_acc[i][j]);
        dv[at + cg + 8 * j] = from_f32<T>(group > 1 ? dv_tot[own] : dv_acc[i][j]);
      }
    }
  }
}


// ---------------------------------------------------------------------------
// tensor-core kernels (float16 / bfloat16)
// ---------------------------------------------------------------------------

template <int HD>
constexpr int dq_wgmma_smem() {
  return 1024 + 6 * Tile<HD>::bytes;  // alignment slack, Q, dO, 2 x (K, V)
}

// K2: dq for one 64-row query tile of one (batch, head)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel_wgmma(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dq, int H, int group, int Sq, int Sk, Strides st,
                          float sm_scale, int causal, int window) {
  constexpr int NP = Tile<HD>::panels;
  constexpr int TB = Tile<HD>::bytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sdO = sQ + TB;
  const uint32_t sKV = sdO + TB;  // buffer i: K at sKV + 2 i TB, V after it

  const int tid = threadIdx.x;
  const int r0 = (tid >> 5) * 16 + ((tid & 31) >> 2);  // rows r0, r0 + 8
  const int c0 = (tid & 3) * 2;                         // columns 8j + c0 + t
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlock;  // the longest (last) tiles first

  const T* kb = k + b * st.k[0] + hk * st.k[2];
  const T* vb = v + b * st.v[0] + hk * st.v[2];
  load_tile_async<T, HD>(sQ, q + b * st.q[0] + h * st.q[2], st.q[1], q0, Sq);
  load_tile_async<T, HD>(sdO, dout + b * st.o[0] + h * st.o[2], st.o[1], q0, Sq);

  float lse2[2], dlt[2];  // rows r0, r0 + 8: lse in base 2, delta
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qs = q0 + r0 + 8 * e;
    lse2[e] = qs < Sq ? lse[static_cast<long long>(bh) * Sq + qs] * kLog2e : 0.f;
    dlt[e] = qs < Sq ? delta[static_cast<long long>(bh) * Sq + qs] : 0.f;
  }
  const float scale2 = sm_scale * kLog2e;

  // key range this query tile can see: [k_lo, k_hi)
  int k_hi = Sk;
  if (causal) k_hi = min(Sk, q0 + kBlock);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int kt_lo = k_lo / kBlock;
  const int n = max(0, (k_hi + kBlock - 1) / kBlock - kt_lo);

  if (n > 0) {
    load_tile_async<T, HD>(sKV, kb, st.k[1], kt_lo * kBlock, Sk);
    load_tile_async<T, HD>(sKV + TB, vb, st.v[1], kt_lo * kBlock, Sk);
  }
  cp_async_commit();

  float acc[NP][32], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = dp[i] = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) acc[p][i] = 0.f;
  }
#pragma unroll
  for (int p = 0; p < NP; ++p) fence_regs(acc[p]);

  for (int it = 0; it < n; ++it) {
    const int k0 = (kt_lo + it) * kBlock;
    const uint32_t sK = sKV + (it & 1) * 2 * TB;
    __syncthreads();  // every thread is done with the buffer the prefetch overwrites
    if (it + 1 < n) {
      const uint32_t nK = sKV + ((it + 1) & 1) * 2 * TB;
      load_tile_async<T, HD>(nK, kb, st.k[1], k0 + kBlock, Sk);
      load_tile_async<T, HD>(nK + TB, vb, st.v[1], k0 + kBlock, Sk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the prefetch: Q, dO and this tile are here
    fence_async_smem();
    __syncthreads();

    wgmma_fence();
    product_k_major<T, HD>(s, sQ, sK);
    product_k_major<T, HD>(dp, sdO, sK + TB);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // ds = p (dp - delta) sm_scale, rounded to T, as the A fragments of ds k
    const bool unmasked = tile_unmasked(q0, k0, Sq, Sk, causal, window);
    uint32_t a[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float ds[2];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int i = 4 * j + 2 * e + t;
          // a masked pair's exp(-1e30 - lse) is exactly 0 in the TPU kernel
          const bool ok = unmasked || pair_ok(q0 + r0 + 8 * e, k0 + 8 * j + c0 + t, Sq, Sk,
                                              causal, window);
          const float p = ok ? exp2f(fmaf(s[i], scale2, -lse2[e])) : 0.f;
          ds[t] = p * (dp[i] - dlt[e]) * sm_scale;
        }
        a[j >> 1][(j & 1) * 2 + e] = pack2<T>(ds[0], ds[1]);
      }
    fence_regs(a);
    wgmma_fence();
    product_mn_major<T, NP>(acc, a, sK);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qpos = q0 + r0 + 8 * e;
    if (qpos >= Sq) continue;
    T* row = dq + ((static_cast<long long>(b) * Sq + qpos) * H + h) * HD;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = p * kPanel + 8 * j + c0;
        if (col < HD)
          *reinterpret_cast<uint32_t*>(row + col) =
              pack2<T>(acc[p][4 * j + 2 * e], acc[p][4 * j + 2 * e + 1]);
      }
  }
}

template <int HD>
__host__ __device__ constexpr int dkv_wgmma_step_bytes() {
  // Q, dO, then lse and delta (512 bytes) padded so that every tile stays 1024-aligned
  return 2 * Tile<HD>::bytes + 1024;
}

template <int HD>
int dkv_wgmma_smem(bool group_totals) {
  // alignment slack, K, V, 2 query-tile buffers, then the f32 group totals
  return 1024 + 2 * Tile<HD>::bytes + 2 * dkv_wgmma_step_bytes<HD>() +
         (group_totals ? 2 * kBlock * Tile<HD>::panels * kPanel * 4 : 0);
}

// K3: dk and dv for one 64-row key tile of one (batch, kv head), summed over
// the query heads of its group
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel_wgmma(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           T* __restrict__ dk, T* __restrict__ dv, int H, int Hkv, int group,
                           int Sq, int Sk, Strides st, float sm_scale, int causal, int window) {
  constexpr int NP = Tile<HD>::panels;
  constexpr int TB = Tile<HD>::bytes;
  constexpr int SB = dkv_wgmma_step_bytes<HD>();
  constexpr int TW = NP * kPanel;  // row width of the group totals
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023) & ~1023u;
  const uint32_t sV = sK + TB;
  const uint32_t sStep = sV + TB;  // buffer i: Q, dO, lse, delta at sStep + i SB
  float* dk_tot = reinterpret_cast<float*>(smem_raw + (sStep + 2 * SB - raw));
  float* dv_tot = dk_tot + kBlock * TW;

  const int tid = threadIdx.x;
  const int r0 = (tid >> 5) * 16 + ((tid & 31) >> 2);  // key rows r0, r0 + 8
  const int c0 = (tid & 3) * 2;                         // query columns 8j + c0 + t
  const int bhk = blockIdx.x;
  const int b = bhk / Hkv;
  const int hk = bhk - b * Hkv;
  const int k0 = blockIdx.y * kBlock;  // the first key tiles, the longest when causal, first
  const float scale2 = sm_scale * kLog2e;

  // query range that can see this key tile: [q_lo, q_hi)
  const int q_lo = causal ? k0 : 0;
  int q_hi = Sq;
  if (window > 0) q_hi = min(Sq, k0 + kBlock + window - 1);
  const int qt_lo = q_lo / kBlock;
  const int nq = max(0, (q_hi + kBlock - 1) / kBlock - qt_lo);
  const int n = group * nq;  // steps: (head g, query tile) in head order

  // the Q, dO, lse and delta of step i into buffer i % 2
  auto load_step = [&](int i) {
    const int g = i / nq;
    const int q0 = (qt_lo + i - g * nq) * kBlock;
    const int h = hk * group + g;
    const long long bh = static_cast<long long>(b) * H + h;
    const uint32_t buf = sStep + (i & 1) * SB;
    load_tile_async<T, HD>(buf, q + b * st.q[0] + h * st.q[2], st.q[1], q0, Sq);
    load_tile_async<T, HD>(buf + TB, dout + b * st.o[0] + h * st.o[2], st.o[1], q0, Sq);
    if (tid < kBlock)
      load_rows_async(buf + 2 * TB, lse + bh * Sq, q0, Sq, tid);
    else
      load_rows_async(buf + 2 * TB + kBlock * 4, delta + bh * Sq, q0, Sq, tid - kBlock);
  };

  load_tile_async<T, HD>(sK, k + b * st.k[0] + hk * st.k[2], st.k[1], k0, Sk);
  load_tile_async<T, HD>(sV, v + b * st.v[0] + hk * st.v[2], st.v[1], k0, Sk);
  if (n > 0) load_step(0);
  cp_async_commit();

  float dka[NP][32], dva[NP][32], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = dp[i] = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) dka[p][i] = dva[p][i] = 0.f;
  }
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    fence_regs(dka[p]);
    fence_regs(dva[p]);
  }
  if (group > 1) {  // each thread reads and writes only its own total entries: no barrier
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int at = (r0 + 8 * e) * TW + p * kPanel + 8 * j + c0;
          *reinterpret_cast<float2*>(dk_tot + at) = make_float2(0.f, 0.f);
          *reinterpret_cast<float2*>(dv_tot + at) = make_float2(0.f, 0.f);
        }
  }

  for (int it = 0; it < n; ++it) {
    const int g = it / nq;
    const int q0 = (qt_lo + it - g * nq) * kBlock;
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

    wgmma_fence();
    product_k_major<T, HD>(s, sK, sQ);    // S^T = K Q^T
    product_k_major<T, HD>(dp, sV, sdO);  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // p^T rounded to do's dtype, and ds^T = p (dp - delta) sm_scale from the
    // rounded p, rounded to q's dtype: the A fragments of p^T do and ds^T q
    const bool unmasked = tile_unmasked(q0, k0, Sq, Sk, causal, window);
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float pr[2], ds[2];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int i = 4 * j + 2 * e + t;
          const int qc = 8 * j + c0 + t;
          const bool ok = unmasked || pair_ok(q0 + qc, k0 + r0 + 8 * e, Sq, Sk, causal, window);
          const float p = ok ? exp2f(fmaf(s[i], scale2, -lse_s[qc] * kLog2e)) : 0.f;
          pr[t] = round_to<T>(p);
          ds[t] = pr[t] * (dp[i] - delta_s[qc]) * sm_scale;
        }
        pa[j >> 1][(j & 1) * 2 + e] = pack2<T>(pr[0], pr[1]);
        da[j >> 1][(j & 1) * 2 + e] = pack2<T>(ds[0], ds[1]);
      }
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
    product_mn_major<T, NP>(dva, pa, sdO);  // dV += P^T dO
    product_mn_major<T, NP>(dka, da, sQ);   // dK += dS^T Q
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      fence_regs(dka[p]);
      fence_regs(dva[p]);
    }

    if (group > 1 && (it + 1) % nq == 0) {  // head g done: its rounded partial into the totals
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * e;
            const int at = (r0 + 8 * e) * TW + p * kPanel + 8 * j + c0;
            float2* tk = reinterpret_cast<float2*>(dk_tot + at);
            float2* tv = reinterpret_cast<float2*>(dv_tot + at);
            const float2 ok = *tk, ov = *tv;
            *tk = make_float2(ok.x + round_to<T>(dka[p][i]), ok.y + round_to<T>(dka[p][i + 1]));
            *tv = make_float2(ov.x + round_to<T>(dva[p][i]), ov.y + round_to<T>(dva[p][i + 1]));
            dka[p][i] = dka[p][i + 1] = dva[p][i] = dva[p][i + 1] = 0.f;
          }
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        fence_regs(dka[p]);
        fence_regs(dva[p]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int kpos = k0 + r0 + 8 * e;
    if (kpos >= Sk) continue;
    const long long at = ((static_cast<long long>(b) * Sk + kpos) * Hkv + hk) * HD;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = p * kPanel + 8 * j + c0;
        if (col >= HD) continue;
        const int i = 4 * j + 2 * e;
        float2 kv = make_float2(dka[p][i], dka[p][i + 1]);
        float2 vv = make_float2(dva[p][i], dva[p][i + 1]);
        if (group > 1) {
          kv = *reinterpret_cast<const float2*>(dk_tot + (r0 + 8 * e) * TW + col);
          vv = *reinterpret_cast<const float2*>(dv_tot + (r0 + 8 * e) * TW + col);
        }
        *reinterpret_cast<uint32_t*>(dk + at + col) = pack2<T>(kv.x, kv.y);
        *reinterpret_cast<uint32_t*>(dv + at + col) = pack2<T>(vv.x, vv.y);
      }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int B, H, Hkv, Sq, Sk;
  Strides st;
  float sm_scale;
  int causal, window;
  cudaStream_t stream;
};

template <typename T, int HD>
int launch_dq(const Args& a) {
  constexpr int smem = dq_smem_floats<HD>() * static_cast<int>(sizeof(float));
  // above 48 KB of shared memory a block needs the opt-in
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.Sq + kBlock - 1) / kBlock, a.B * a.H);
  flash_bwd_dq_kernel<T, HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dq), a.H, a.H / a.Hkv, a.Sq, a.Sk,
      a.st, a.sm_scale, a.causal, a.window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dkv(const Args& a) {
  const int smem = dkv_smem_floats<HD>(a.H > a.Hkv) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.Sk + kBlock - 1) / kBlock, a.B * a.Hkv);
  flash_bwd_dkv_kernel<T, HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H,
      a.Hkv, a.H / a.Hkv, a.Sq, a.Sk, a.st, a.sm_scale, a.causal, a.window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dq_wgmma(const Args& a) {
  constexpr int smem = dq_wgmma_smem<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel_wgmma<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the tile index on the slow axis, so that the longest tiles go out first
  dim3 grid(a.B * a.H, (a.Sq + kBlock - 1) / kBlock);
  flash_bwd_dq_kernel_wgmma<T, HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dq), a.H, a.H / a.Hkv, a.Sq, a.Sk,
      a.st, a.sm_scale, a.causal, a.window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dkv_wgmma(const Args& a) {
  const int smem = dkv_wgmma_smem<HD>(a.H > a.Hkv);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel_wgmma<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.B * a.Hkv, (a.Sk + kBlock - 1) / kBlock);
  flash_bwd_dkv_kernel_wgmma<T, HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H,
      a.Hkv, a.H / a.Hkv, a.Sq, a.Sk, a.st, a.sm_scale, a.causal, a.window);
  return static_cast<int>(cudaGetLastError());
}

// float32: the FMA kernels; float16 / bfloat16: the tensor-core kernels
template <typename T, bool DQ>
int dispatch_hd(int hd, const Args& a) {
  if constexpr (std::is_same<T, float>::value) {
    switch (hd) {
      case 16: return DQ ? launch_dq<T, 16>(a) : launch_dkv<T, 16>(a);
      case 32: return DQ ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
      case 64: return DQ ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
      case 128: return DQ ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
      default: return -1;
    }
  } else {
    switch (hd) {
      case 16: return DQ ? launch_dq_wgmma<T, 16>(a) : launch_dkv_wgmma<T, 16>(a);
      case 32: return DQ ? launch_dq_wgmma<T, 32>(a) : launch_dkv_wgmma<T, 32>(a);
      case 64: return DQ ? launch_dq_wgmma<T, 64>(a) : launch_dkv_wgmma<T, 64>(a);
      case 128: return DQ ? launch_dq_wgmma<T, 128>(a) : launch_dkv_wgmma<T, 128>(a);
      default: return -1;
    }
  }
}

template <bool DQ>
int dispatch(int dtype, int hd, const Args& a) {
  switch (dtype) {
    case 0: return dispatch_hd<float, DQ>(hd, a);
    case 1: return dispatch_hd<__half, DQ>(hd, a);
    case 2: return dispatch_hd<__nv_bfloat16, DQ>(hd, a);
    default: return -1;
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, int B, int H, int Hkv, int Sq, int Sk,
               const long long* strides, float sm_scale, int causal, int window, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.B = B; a.H = H; a.Hkv = Hkv; a.Sq = Sq; a.Sk = Sk;
  for (int i = 0; i < 3; ++i) {
    a.st.q[i] = strides[i];
    a.st.k[i] = strides[3 + i];
    a.st.v[i] = strides[6 + i];
    a.st.o[i] = strides[9 + i];
  }
  a.sm_scale = sm_scale; a.causal = causal; a.window = window;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. strides: 12 values, the
// (batch, seq, head) strides of q, k, v and do in that order, in elements.
// Return cudaGetLastError() after the launch, or -1 for an unsupported dtype /
// head size.
extern "C" int dstorch_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dq, int B, int H, int Hkv, int Sq, int Sk, int hd,
                                    const long long* strides, float sm_scale, int causal,
                                    int window, void* stream) {
  Args a = make_args(q, k, v, dout, lse, delta, B, H, Hkv, Sq, Sk, strides, sm_scale, causal,
                     window, stream);
  a.dq = dq;
  return dispatch<true>(dtype, hd, a);
}

extern "C" int dstorch_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dk, void* dv, int B, int H, int Hkv, int Sq, int Sk,
                                     int hd, const long long* strides, float sm_scale,
                                     int causal, int window, void* stream) {
  Args a = make_args(q, k, v, dout, lse, delta, B, H, Hkv, Sq, Sk, strides, sm_scale, causal,
                     window, stream);
  a.dk = dk;
  a.dv = dv;
  return dispatch<false>(dtype, hd, a);
}
