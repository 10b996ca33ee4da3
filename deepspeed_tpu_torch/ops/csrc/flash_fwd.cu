// FlashAttention-2 forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/flash_attention.py::_fwd_kernel
// (driven by _fwd). Computes, per (batch, head, query row):
//     o   = softmax(q k^T * sm_scale + mask) v
//     lse = m + log(l)          (f32, laid out (B, H, Sq, 1))
// with causal masking, an optional causal sliding window (keys in
// (qpos - window, qpos]) and grouped-query attention (query head h reads kv
// head h / (H / Hkv)). Masked scores are -1e30 and o divides by max(l, 1e-20),
// as the TPU kernel does.
//
// Design. One thread block per (query tile of 64 rows, batch * head); 4 warps.
// A loop over 64-key tiles inside the block takes the place of the TPU grid's
// sequential "arbitrary" dimension: it starts at the first tile the window
// band can reach and stops at the diagonal when causal. The running max m,
// sum l and accumulator acc stay in f32 registers. Q, K and V tiles are
// staged in shared memory as f32, so QK^T and PV are exact products of the
// input-dtype values summed in f32 (the TPU kernel's bf16 dots with
// preferred_element_type=f32); p is rounded to the input dtype before PV, as
// the TPU kernel's p.astype(v.dtype). Each thread owns a 4 x 8 register tile
// of scores (4 query rows x 8 keys) and a 4 x HD/8 tile of the output; the
// 8 lanes sharing a row reduce the row max and sum with warp shuffles.
// Ragged edges (S not a multiple of 64) are masked in the kernel, so any
// sequence length works; the TPU tile hints block_q/block_k do not apply.
//
// What bounds it on an H100. Work is 4 * hd FLOPs per (query, key) pair the
// mask lets through: 4 * B * H * Sq * Sk * hd, about half when causal. The
// bytes it must move are (2 * B * H * Sq + 2 * B * Hkv * Sk) * hd * itemsize
// plus 4 * B * H * Sq for lse. In bf16 without GQA that is about S / 2 FLOPs
// per byte (S / 4 when causal), under the card's ~295 FLOPs-per-byte ridge
// at the serving prefill lengths (causal S <= 1024): the roofline bound is
// the memory rate, a few microseconds. This version does its arithmetic
// with f32 FMAs (no tensor cores, no TMA), whose 67 TFLOP/s ceiling, not
// memory, is what limits it; K and V tiles are read again for every 64-row
// query tile, mostly from the 50 MB L2. Moving QK^T and PV to wgmma with
// TMA-fed K/V tiles is the next step.
//
// Interface: plain C, loaded with ctypes. Strides are in elements; the last
// dimension of q, k and v must be contiguous. o is a contiguous
// (B, Sq, H, hd) tensor, lse a contiguous (B, H, Sq) f32 tensor. The launch
// goes on the caller's stream; the return value is cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

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

template <int HD>
constexpr int smem_floats() {
  // Q and K rows padded by one float so column reads hit distinct banks.
  return kBlockQ * (HD + 1) + kBlockK * (HD + 1) + kBlockK * HD + kBlockQ * (kBlockK + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int H, int group, int Sq, int Sk,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 float sm_scale, int causal, int window) {
  constexpr int QP = HD + 1;
  constexpr int PP = kBlockK + 1;
  constexpr int DT = HD / 8;  // output dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // kBlockQ x QP
  float* Ks = Qs + kBlockQ * QP;  // kBlockK x QP
  float* Vs = Ks + kBlockK * QP;  // kBlockK x HD
  float* Ps = Vs + kBlockK * HD;  // kBlockQ x PP

  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // rows rg*4 .. rg*4+3 of the query tile
  const int cg = tid & 7;   // keys cg + 8*c of the key tile, dims cg + 8*j of the output
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / group;
  const int q0 = blockIdx.x * kBlockQ;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;

  for (int i = tid; i < kBlockQ * HD; i += kThreads) {
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
  if (causal) k_hi = min(Sk, q0 + kBlockQ);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int kt_lo = k_lo / kBlockK;
  const int kt_hi = (k_hi + kBlockK - 1) / kBlockK;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's Ks/Vs/Ps reads are done
    for (int i = tid; i < kBlockK * HD; i += kThreads) {
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
    for (int kk = 0; kk < kBlockK; ++kk) {
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

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
           int Hkv, int Sq, int Sk, const long long* qs, const long long* ks,
           const long long* vs, float sm_scale, int causal, int window, cudaStream_t stream) {
  constexpr int smem = smem_floats<HD>() * static_cast<int>(sizeof(float));
  // above 48 KB of shared memory a block needs the opt-in
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kBlockQ - 1) / kBlockQ, B * H);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), H, H / Hkv, Sq, Sk,
      qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      sm_scale, causal, window);
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
