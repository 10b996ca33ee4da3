// FlashAttention-2 forward for Hopper (sm_90a), hand-written CUDA C++ (K1).
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/flash_attention.py::_fwd_kernel
// (driven by _fwd). Computes, per (batch, head, query row):
//     o   = softmax(q k^T * sm_scale + mask) v
//     lse = m + log(l)          (f32, laid out (B, H, Sq, 1))
// with causal masking, an optional causal sliding window (keys in
// (qpos - window, qpos]) and grouped-query attention (query head h reads kv
// head h / (H / Hkv)). Numerics follow the TPU kernel: q k^T from exact
// products of input-dtype values summed in f32 (its bf16 dots with
// preferred_element_type=f32); masked scores -1e30; the running max m, sum l
// and accumulator in f32; p rounded to v's dtype before p v (its
// p.astype(v.dtype)); o = acc / max(l, 1e-20), rounded once. A masked score
// contributes exactly 0 (the TPU kernel's exp(-1e30 - m) is the same 0 once
// any key of the row has been seen), so a row whose first tile lies wholly
// outside its window gives the same o and lse.
//
// Two variants, chosen by the input dtype (never as a fallback: a failed
// launch is an error and the caller raises):
//  - float16 / bfloat16: the tensor-core kernel flash_fwd_kernel_wgmma;
//  - float32: the FMA kernel flash_fwd_kernel. On the tensor cores f32 would
//    be TF32, about three decimal digits, where the f32 path is held to 1e-5.
// Both run one block per (64-row query tile, batch * head). A loop over the
// 64-key tiles the mask lets through takes the place of the TPU grid's
// sequential "arbitrary" dimension: it starts at the first tile the window
// band can reach and stops at the diagonal when causal. Ragged edges (S not
// a multiple of 64) are masked in the kernel, so any sequence length works;
// the TPU tile hints block_q / block_k do not apply.
//
// Tensor-core design (its building blocks are in flash_sm90.cuh, shared with
// the backward). One warpgroup (128 threads) per block; both products are
// wgmma.mma_async m64n64k16 with f32 accumulators:
//  - S = Q K^T with Q and K K-major from shared memory (K2's S product);
//  - O += P V with P in registers as the A fragment and V read MN-major
//    (transposed) from its one copy (K2's dQ += dS K). P is rounded to
//    nearest and packed from the S accumulator straight into the A
//    fragments; it never passes through shared memory.
//  - The online softmax runs on the accumulator layout: a thread holds 16
//    scores of each of rows r and r + 8, the 4 lanes of its quad hold the
//    rest of both rows, and each row max and row sum takes two shuffles.
//    Scores are scaled once by sm_scale * log2(e) and exponentiated with
//    exp2f; lse = m ln(2) + logf(l). Rescaling O by exp2(m_old - m_new)
//    touches the accumulator, so it runs after the previous P V has finished
//    (wait_group 0), between register fences.
//  - Q is loaded once. K and V tiles are cp.async 16-byte copies in the
//    input dtype into 128-byte-swizzled, 1024-byte-aligned panels, double
//    buffered over the key loop: the next tile is in flight during the
//    current tile's products. cp.async rather than TMA: q, k and v are
//    strided views of the fused QKV projection, with the head as the middle
//    axis, so each tile is 64 rows at a row stride of 3 * H * hd; cp.async
//    takes those strides as they are, zero-fills the ragged edge per row,
//    and needs no tensor map made on the host for every call. The copies
//    need 16-byte aligned rows; the wrapper makes a tensor that is not so
//    contiguous before the launch and refuses one that reaches the kernel.
//  - Masking happens in registers, only on diagonal or edge tiles; fully
//    masked tiles are skipped. Under causal masking the grid's slow axis
//    runs the longest (last) query tiles first.
//  - Head dims 16 and 32 use one padded 64-wide panel: Q K^T steps over the
//    real columns only, and the padded o columns are never stored. Head dim
//    128 keeps two 64-wide O accumulators.
//
// FMA design (float32). 4 warps. Q, K and V tiles are staged in shared
// memory as f32 (Q and K rows padded by one float so column reads hit
// distinct banks). Each thread owns a 4 x 8 register tile of scores (4 query
// rows x 8 keys) and a 4 x HD/8 tile of the output; the 8 lanes sharing a
// row reduce its max and sum with warp shuffles, and p goes through shared
// memory to the P V loop.
//
// What bounds it on an H100. Work is 4 * hd FLOPs per (query, key) pair the
// mask lets through: 4 * B * H * Sq * Sk * hd, about half when causal. The
// bytes it must move are (2 * B * H * Sq + 2 * B * Hkv * Sk) * hd * itemsize
// plus 4 * B * H * Sq for lse. In bf16 without GQA that is about S / 2 FLOPs
// per byte (S / 4 when causal), under the card's ~295 FLOPs-per-byte ridge
// at the model's lengths (causal S <= 1024): the roofline bound is the
// memory rate, a few microseconds to a few tens. What holds the tensor-core
// kernel above it: one warpgroup per block that waits for each product
// before the softmax and the next product, and K and V tiles read again for
// every 64-row query tile (mostly from the 50 MB L2). The FMA kernel is held
// by the f32 CUDA cores (67 TFLOP/s).
//
// Interface: plain C, loaded with ctypes. Strides are in elements; the last
// dimension of q, k and v must be contiguous (for 16-bit inputs also 16-byte
// aligned rows: base addresses a multiple of 16 bytes, strides of 8
// elements). o is a contiguous (B, Sq, H, hd) tensor, lse a contiguous
// (B, H, Sq) f32 tensor. The launch goes on the caller's stream; the return
// value is cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

template <int HD>
constexpr int smem_floats() {
  // Q and K rows padded by one float so column reads hit distinct banks.
  return kBlock * (HD + 1) + kBlock * (HD + 1) + kBlock * HD + kBlock * (kBlock + 1);
}

// K1 (FMA, float32): o and lse for one 64-row query tile of one (batch, head)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int H, int group, int Sq, int Sk,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 float sm_scale, int causal, int window) {
  constexpr int QP = HD + 1;
  constexpr int PP = kBlock + 1;
  constexpr int DT = HD / 8;  // output dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // kBlock x QP
  float* Ks = Qs + kBlock * QP;  // kBlock x QP
  float* Vs = Ks + kBlock * QP;  // kBlock x HD
  float* Ps = Vs + kBlock * HD;  // kBlock x PP

  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // rows rg*4 .. rg*4+3 of the query tile
  const int cg = tid & 7;   // keys cg + 8*c of the key tile, dims cg + 8*j of the output
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / group;
  const int q0 = blockIdx.x * kBlock;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;

  for (int i = tid; i < kBlock * HD; i += kThreads) {
    const int r = i / HD, d = i - (i / HD) * HD;
    const int s = q0 + r;
    Qs[r * QP + d] = s < Sq ? to_f32(qb[s * q_ss + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DT; ++j) acc[i][j] = 0.f;
  }

  // key range this query tile can see: [k_lo, k_hi)
  int k_hi = Sk;
  if (causal) k_hi = min(Sk, q0 + kBlock);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int kt_lo = k_lo / kBlock;
  const int kt_hi = (k_hi + kBlock - 1) / kBlock;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();  // the previous tile's Ks/Vs/Ps reads are done
    for (int i = tid; i < kBlock * HD; i += kThreads) {
      const int r = i / HD, d = i - (i / HD) * HD;
      const int s = k0 + r;
      const bool ok = s < Sk;
      Ks[r * QP + d] = ok ? to_f32(kb[s * k_ss + d]) : 0.f;
      Vs[r * HD + d] = ok ? to_f32(vb[s * v_ss + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) sc[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(rg * 4 + i) * QP + d];
#pragma unroll
      for (int c = 0; c < 8; ++c) kv[c] = Ks[(cg + 8 * c) * QP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) sc[i][c] = fmaf(qv[i], kv[c], sc[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + rg * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int kpos = k0 + cg + 8 * c;
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && (qpos - kpos < window);
        const float s = ok ? sc[i][c] * sm_scale : kNegInf;
        sc[i][c] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        // a masked score contributes nothing (the TPU kernel's exp(-1e30 - m)
        // is the same 0 once any key of the row has been seen)
        const float p = sc[i][c] == kNegInf ? 0.f : expf(sc[i][c] - m_new);
        rs += p;
        Ps[(rg * 4 + i) * PP + cg + 8 * c] = to_f32(from_f32<T>(p));
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DT; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlock; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(rg * 4 + i) * PP + kk];
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const float vv = Vs[kk * HD + cg + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + rg * 4 + i;
    if (qpos < Sq) {
      const float lc = fmaxf(l[i], 1e-20f);
      T* orow = o + ((static_cast<long long>(b) * Sq + qpos) * H + h) * HD;
#pragma unroll
      for (int j = 0; j < DT; ++j) orow[cg + 8 * j] = from_f32<T>(acc[i][j] / lc);
      if (cg == 0) lse[static_cast<long long>(bh) * Sq + qpos] = m[i] + logf(lc);
    }
  }
}

template <int HD>
constexpr int wgmma_smem() {
  return 1024 + 5 * Tile<HD>::bytes;  // alignment slack, Q, 2 x (K, V)
}

// K1 (tensor cores, float16 / bfloat16): o and lse for one 64-row query tile
// of one (batch, head)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel_wgmma(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                       int H, int group, int Sq, int Sk,
                       long long q_sb, long long q_ss, long long q_sh,
                       long long k_sb, long long k_ss, long long k_sh,
                       long long v_sb, long long v_ss, long long v_sh,
                       float sm_scale, int causal, int window) {
  constexpr int NP = Tile<HD>::panels;
  constexpr int TB = Tile<HD>::bytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sKV = sQ + TB;  // buffer i: K at sKV + 2 i TB, V after it

  const int tid = threadIdx.x;
  const int r0 = (tid >> 5) * 16 + ((tid & 31) >> 2);  // rows r0, r0 + 8
  const int c0 = (tid & 3) * 2;                         // columns 8j + c0 + t
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlock;  // the longest (last) tiles first

  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  load_tile_async<T, HD>(sQ, q + b * q_sb + h * q_sh, q_ss, q0, Sq);

  // key range this query tile can see: [k_lo, k_hi)
  int k_hi = Sk;
  if (causal) k_hi = min(Sk, q0 + kBlock);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int kt_lo = k_lo / kBlock;
  const int n = max(0, (k_hi + kBlock - 1) / kBlock - kt_lo);

  if (n > 0) {
    load_tile_async<T, HD>(sKV, kb, k_ss, kt_lo * kBlock, Sk);
    load_tile_async<T, HD>(sKV + TB, vb, v_ss, kt_lo * kBlock, Sk);
  }
  cp_async_commit();

  const float scale2 = sm_scale * kLog2e;
  // rows r0, r0 + 8: the running max of the scores (in base 2) and sum of p
  float m2[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[NP][32], s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = 0.f;
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
      load_tile_async<T, HD>(nK, kb, k_ss, k0 + kBlock, Sk);
      load_tile_async<T, HD>(nK + TB, vb, v_ss, k0 + kBlock, Sk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the prefetch: Q and this tile are here
    fence_async_smem();
    __syncthreads();

    wgmma_fence();
    product_k_major<T, HD>(s, sQ, sK);  // S = Q K^T
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scores in base 2, masked ones -1e30; each row's new max and the
    // factor that carries the old sums over to it
    const bool unmasked = tile_unmasked(q0, k0, Sq, Sk, causal, window);
    float corr[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int i = 4 * j + 2 * e + t;
          const bool ok = unmasked || pair_ok(q0 + r0 + 8 * e, k0 + 8 * j + c0 + t, Sq, Sk,
                                              causal, window);
          s[i] = ok ? s[i] * scale2 : kNegInf;
          mx = fmaxf(mx, s[i]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m2[e], mx);
      corr[e] = exp2f(m2[e] - m_new);
      m2[e] = m_new;
    }

    // p in f32 for the row sums, rounded to T as the A fragments of P V
    uint32_t pa[4][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p[2];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const float sc = s[4 * j + 2 * e + t];
          p[t] = sc == kNegInf ? 0.f : exp2f(sc - m2[e]);  // a masked score adds nothing
        }
        rs[e] += p[0] + p[1];
        pa[j >> 1][(j & 1) * 2 + e] = pack2<T>(p[0], p[1]);
      }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      rs[e] += __shfl_xor_sync(0xffffffffu, rs[e], 1);
      rs[e] += __shfl_xor_sync(0xffffffffu, rs[e], 2);
      l[e] = l[e] * corr[e] + rs[e];
    }
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] *= corr[(i >> 1) & 1];
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
    fence_regs(pa);
    wgmma_fence();
    product_mn_major<T, NP>(acc, pa, sK + TB);  // O += P V
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
    const float lc = fmaxf(l[e], 1e-20f);
    T* row = o + ((static_cast<long long>(b) * Sq + qpos) * H + h) * HD;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = p * kPanel + 8 * j + c0;
        if (col < HD)
          *reinterpret_cast<uint32_t*>(row + col) =
              pack2<T>(acc[p][4 * j + 2 * e] / lc, acc[p][4 * j + 2 * e + 1] / lc);
      }
    if ((tid & 3) == 0) lse[static_cast<long long>(bh) * Sq + qpos] = m2[e] * kLn2 + logf(lc);
  }
}

// float32: the FMA kernel; float16 / bfloat16: the tensor-core kernel
template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
           int Hkv, int Sq, int Sk, const long long* qs, const long long* ks,
           const long long* vs, float sm_scale, int causal, int window, cudaStream_t stream) {
  const int nq = (Sq + kBlock - 1) / kBlock;
  if constexpr (std::is_same<T, float>::value) {
    constexpr int smem = smem_floats<HD>() * static_cast<int>(sizeof(float));
    // above 48 KB of shared memory a block needs the opt-in
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_kernel<T, HD><<<dim3(nq, B * H), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), static_cast<float*>(lse), H, H / Hkv, Sq, Sk,
        qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
        sm_scale, causal, window);
  } else {
    constexpr int smem = wgmma_smem<HD>();
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel_wgmma<T, HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    // the tile index on the slow axis, so that the longest tiles go out first
    flash_fwd_kernel_wgmma<T, HD><<<dim3(B * H, nq), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), static_cast<float*>(lse), H, H / Hkv, Sq, Sk,
        qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
        sm_scale, causal, window);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o, void* lse, int B,
                int H, int Hkv, int Sq, int Sk, const long long* qs, const long long* ks,
                const long long* vs, float sm_scale, int causal, int window,
                cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, qs, ks, vs, sm_scale, causal, window, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, qs, ks, vs, sm_scale, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, qs, ks, vs, sm_scale, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, qs, ks, vs, sm_scale, causal, window, stream);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. Strides are (batch, seq, head)
// in elements. Returns cudaGetLastError() after the launch, or -1 for an
// unsupported dtype / head size.
extern "C" int dstorch_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                                 void* o, void* lse, int B, int H, int Hkv, int Sq, int Sk,
                                 int hd, long long q_sb, long long q_ss, long long q_sh,
                                 long long k_sb, long long k_ss, long long k_sh,
                                 long long v_sb, long long v_ss, long long v_sh,
                                 float sm_scale, int causal, int window, void* stream) {
  const long long qs[3] = {q_sb, q_ss, q_sh};
  const long long ks[3] = {k_sb, k_ss, k_sh};
  const long long vs[3] = {v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_hd<float>(hd, q, k, v, o, lse, B, H, Hkv, Sq, Sk, qs, ks, vs, sm_scale, causal, window, st);
    case 1: return dispatch_hd<__half>(hd, q, k, v, o, lse, B, H, Hkv, Sq, Sk, qs, ks, vs, sm_scale, causal, window, st);
    case 2: return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, lse, B, H, Hkv, Sq, Sk, qs, ks, vs, sm_scale, causal, window, st);
    default: return -1;
  }
}
