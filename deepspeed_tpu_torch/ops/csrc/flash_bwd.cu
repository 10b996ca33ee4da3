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
// K2 rounds ds to the input dtype before ds k. K3 rounds p to do's dtype
// before p^T do, computes ds in f32 from that rounded p and rounds ds to q's
// dtype before ds^T q. Accumulators are f32; outputs are in the input dtype.
//
// Design. 4 warps per block; a thread owns a 4 x 8 register tile of the
// 64 x 64 score block and a 4 x HD/8 tile of its f32 accumulator; tiles of
// q, k, v and do are staged in shared memory as f32 (rows padded by one
// float so column walks hit distinct banks).
//  - K2: one block per (64-row query tile, batch * head). A loop over the
//    64-key tiles the mask lets through (from the window band's first tile
//    to the diagonal when causal) takes the place of the TPU grid's
//    sequential axis; dq stays in registers and is written once.
//  - K3: one block per (64-row key tile, batch * kv head). It loops over
//    the `group` query heads that share the kv head and, for each, over the
//    query tiles from the diagonal (or all, when not causal) to the end of
//    the window band. Each head's dk and dv sum in f32 registers; with GQA
//    (group > 1) each head's partial is then rounded to the input dtype and
//    added into an f32 group total in shared memory, and the total is
//    rounded once at the store. That is the GQA head sum _bwd does outside
//    its kernel (:412-414), where each head's dk_full / dv_full is in the
//    input dtype, done without a second pass and without atomics.
// Ragged edges (S not a multiple of 64) are masked in the kernel; q, k, v
// and do are read through strides, so views of a fused QKV projection need
// no copy.
//
// What bounds it on an H100. K2 does 6 * hd FLOPs per (query, key) pair the
// mask lets through (q k^T, do v^T, ds k), K3 8 * hd (q k^T, do v^T, p^T do,
// ds^T q). Both read q, k, v and do once (plus lse and delta) and write
// their gradients once: at hd 64 and causal S = 1024 that is ~256 FLOPs per
// byte, near the ~295 ridge of the bf16 tensor cores, so the bound is the
// tensor-core rate. This version does its arithmetic with f32 FMAs from
// shared memory (67 TFLOP/s ceiling, no tensor cores, no TMA): it is limited
// by that, and by the shared-memory traffic of its operand loads, not by
// memory. Moving the four products to wgmma is the next step.
//
// Interface: plain C, loaded with ctypes. Strides are in elements, the last
// dimension of q, k, v and do must be contiguous; lse and delta are
// contiguous (B, H, Sq) f32; dq is a contiguous (B, Sq, H, hd) tensor, dk
// and dv contiguous (B, Sk, Hkv, hd). Launches go on the caller's stream;
// the return value is cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 64;  // query and key tile rows
constexpr int kThreads = 128;
constexpr int kSP = kBlock + 1;  // padded row of a 64 x 64 score tile

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

__device__ __forceinline__ bool pair_ok(int qpos, int kpos, int Sq, int Sk, int causal,
                                        int window) {
  bool ok = qpos < Sq && kpos < Sk;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && (qpos - kpos < window);
  return ok;
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

// K2: dq for one 64-row query tile of one (batch, head)
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

// K3: dk and dv for one 64-row key tile of one (batch, kv head), summed over
// the query heads of its group
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

template <typename T, bool DQ>
int dispatch_hd(int hd, const Args& a) {
  switch (hd) {
    case 16: return DQ ? launch_dq<T, 16>(a) : launch_dkv<T, 16>(a);
    case 32: return DQ ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
    case 64: return DQ ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128: return DQ ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    default: return -1;
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
// Return cudaGetLastError() after the launch, or -1 for an unsupported
// dtype / head size.
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
