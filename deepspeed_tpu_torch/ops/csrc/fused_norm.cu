// Fused LayerNorm / RMSNorm over the last dimension, forward (K7) and
// backward (K8), for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernels deepspeed_tpu/ops/pallas/fused_norm.py::_fwd_kernel
// (K7, launched by _run_fwd) and ::_bwd_kernel (K8, launched by _run_bwd). On
// x2 (N, D), per row, with all arithmetic in f32 as in the TPU kernels:
//   K7  LayerNorm: mu = mean(x), var = mean((x - mu)^2)   (two passes, population)
//       RMSNorm:   mu = 0,       var = mean(x^2)
//       rstd = rsqrt(var + eps); out = (x - mu) * rstd * scale (+ bias), in x's
//       dtype; mu and rstd stored as f32, one each per row.
//   K8  xhat = (x - mu) * rstd from the saved mu and rstd; dxhat = do * scale;
//       LayerNorm: dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
//       RMSNorm:   dx = rstd * (dxhat - xhat * mean(dxhat * xhat))
//       dx in x's dtype, and per-block f32 partial sums over the block's rows of
//       do * xhat (dscale) and do (dbias), (nb, D). As in the TPU kernel, the sum
//       of the partials over blocks is outside (_run_bwd sums its (nb, D)
//       partials after the pallas_call): the wrapper reduces them with torch.sum.
//
// Design. The TPU kernel's grid walks blocks of rows in order, the whole
// feature dimension resident in VMEM. Here rows are independent work for
// different warps or blocks:
//   - D <= 1024: one warp per row, 8 rows (warps) per block. Lane l holds the
//     row's elements l + 32 k (k < VPT, VPT = ceil(D / 32) rounded up to one of
//     1, 2, 4, 8, 12, 16, 24, 32) in registers, so K7's two passes and K8's two
//     means read x (and do) from device memory once. Row sums are xor shuffles.
//   - D > 1024: one block per row (K7) or per range of rows (K8), about 8
//     elements per thread, up to 1024 threads. K7 keeps the row in shared
//     memory as f32 (no second read from device memory) while it fits in
//     200 KB (D <= 51,136), else reads it again. K8 reads x and do a second
//     time for dx; that read comes from L1/L2, right after the first.
// K8's column partials: the rows are split into nb contiguous ranges, one block
// each (nb from dstorch_fused_norm_bwd_blocks: about two blocks per SM). In the warp
// kernel each warp sums its rows' do * xhat and do in registers, and the block
// adds its 8 warps' sums in warp order through shared memory; in the block
// kernel each thread owns its columns and sums them over the block's rows, in
// shared memory (or, above D = 25,568, in the block's own row of the partials).
// No float atomics anywhere: every sum has a fixed order, so two calls on the
// same inputs give the same bits. Reductions (xor shuffles, then the warps'
// sums in warp order) give every thread the same total.
//
// What bounds it on an H100. A few FLOPs per element against 2 (K7) or 3 (K8)
// element reads and writes: bytes. K7 moves x and out once (plus mu, rstd and
// scale/bias); K8 moves x, do and dx once, plus its (nb, D) f32 partials. The
// bound is those bytes over the H100 SXM's published 3.35 TB/s; for K8 at a
// large D the partials add a few percent. Loads here are one element per
// thread, coalesced across the warp; 16-byte vector loads are the next step.
//
// Interface: plain C, loaded with ctypes. x, do and dx are contiguous (N, D)
// tensors of one dtype; scale and bias contiguous (D,) tensors of any of the
// three dtypes (each with its own code); mu and rstd contiguous f32 (N,).
// Launches go on the caller's stream; the return value is cudaGetLastError(),
// or -1 for an unsupported argument.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRowWarps = 8;            // warp-per-row kernels: rows (warps) per block
constexpr int kWarpMaxD = 1024;         // warp per row while D <= 32 lanes x 32 values
constexpr int kMaxThreads = 1024;       // block-per-row kernels
constexpr int kRed = 64;                // floats of shared memory for block sums
constexpr int kSmemLimit = 200 * 1024;  // dynamic shared memory a block may ask for here
constexpr int kDefaultSmem = 48 * 1024; // above this a kernel needs cudaFuncSetAttribute

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

// Element i of scale or bias as f32; code 0 = float32, 1 = float16, 2 = bfloat16.
__device__ __forceinline__ float load_w(const void* p, int code, int i) {
  if (code == 0) return static_cast<const float*>(p)[i];
  if (code == 1) return __half2float(static_cast<const __half*>(p)[i]);
  return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// Sum over the warp by xor shuffles: every lane gets the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums a and b over the block (blockDim.x a multiple of 32): each warp's sum
// by shuffles, then the warps' sums in warp order; every thread gets the
// same two totals. red holds 2 x 32 floats.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  __syncthreads();  // every thread has read red in the previous call
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
  }
  __syncthreads();
  a = warp_sum(lane < nw ? red[lane] : 0.f);
  b = warp_sum(lane < nw ? red[32 + lane] : 0.f);
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  float unused = 0.f;
  block_sum2(v, unused, red);
  return v;
}

// ---- K7, one warp per row
template <typename T, int VPT>
__global__ void __launch_bounds__(kRowWarps * 32)
fused_norm_fwd_warp_kernel(const T* __restrict__ x, const void* __restrict__ scale, int scode,
                           const void* __restrict__ bias, int bcode, T* __restrict__ out,
                           float* __restrict__ mu_out, float* __restrict__ rstd_out, int N, int D,
                           float eps, int rms) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
  if (row >= N) return;  // the whole warp: no shuffle is left half-attended
  const T* xr = x + row * D;
  float v[VPT];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = lane + 32 * k;
    v[k] = c < D ? to_f32(xr[c]) : 0.f;
    s += v[k];
  }
  const float mu = rms ? 0.f : warp_sum(s) / D;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const float d = lane + 32 * k < D ? v[k] - mu : 0.f;
    q += d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) / D + eps);
  T* orow = out + row * D;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = lane + 32 * k;
    if (c < D) {
      float y = (v[k] - mu) * rstd * load_w(scale, scode, c);
      if (bias != nullptr) y += load_w(bias, bcode, c);
      orow[c] = from_f32<T>(y);
    }
  }
  if (lane == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

// ---- K7, one block per row; the row kept in shared memory when resident
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
fused_norm_fwd_block_kernel(const T* __restrict__ x, const void* __restrict__ scale, int scode,
                            const void* __restrict__ bias, int bcode, T* __restrict__ out,
                            float* __restrict__ mu_out, float* __restrict__ rstd_out, int D,
                            float eps, int rms, int resident) {
  extern __shared__ float smem[];
  float* red = smem;        // kRed
  float* buf = smem + kRed; // D, when resident
  const long long row = blockIdx.x;
  const T* xr = x + row * D;
  float s = 0.f;
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    const float v = to_f32(xr[c]);
    if (resident) buf[c] = v;  // each thread reads back only its own columns
    s += v;
  }
  const float mu = rms ? 0.f : block_sum(s, red) / D;
  float q = 0.f;
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    const float d = (resident ? buf[c] : to_f32(xr[c])) - mu;
    q += d * d;
  }
  const float rstd = rsqrtf(block_sum(q, red) / D + eps);
  T* orow = out + row * D;
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    const float v = resident ? buf[c] : to_f32(xr[c]);
    float y = (v - mu) * rstd * load_w(scale, scode, c);
    if (bias != nullptr) y += load_w(bias, bcode, c);
    orow[c] = from_f32<T>(y);
  }
  if (threadIdx.x == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

// ---- K8, one warp per row; block b takes rows [b * rows_per_block, ...)
template <typename T, int VPT>
__global__ void __launch_bounds__(kRowWarps * 32)
fused_norm_bwd_warp_kernel(const T* __restrict__ x, const void* __restrict__ scale, int scode,
                           const float* __restrict__ mu, const float* __restrict__ rstd,
                           const T* __restrict__ dout, T* __restrict__ dx,
                           float* __restrict__ dscale_p, float* __restrict__ dbias_p, int N, int D,
                           int rows_per_block, int rms) {
  extern __shared__ float part[];  // kRowWarps x D: the warps' column sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float w[VPT], acc_s[VPT], acc_b[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = lane + 32 * k;
    w[k] = c < D ? load_w(scale, scode, c) : 0.f;
    acc_s[k] = 0.f;
    acc_b[k] = 0.f;
  }
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(r0 + rows_per_block, static_cast<long long>(N));
  for (long long row = r0 + warp; row < r1; row += kRowWarps) {
    const float m = mu[row], rs = rstd[row];
    const T* xr = x + row * D;
    const T* gr = dout + row * D;
    float xh[VPT], dxh[VPT];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int c = lane + 32 * k;
      xh[k] = 0.f;
      dxh[k] = 0.f;
      if (c < D) {
        const float g = to_f32(gr[c]);
        xh[k] = (to_f32(xr[c]) - m) * rs;
        dxh[k] = g * w[k];
        acc_s[k] += g * xh[k];
        acc_b[k] += g;
        s1 += dxh[k];
        s2 += dxh[k] * xh[k];
      }
    }
    const float m1 = rms ? 0.f : warp_sum(s1) / D;
    const float m2 = warp_sum(s2) / D;
    T* dr = dx + row * D;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int c = lane + 32 * k;
      if (c < D) dr[c] = from_f32<T>(rs * (dxh[k] - m1 - xh[k] * m2));
    }
  }
  // the block's partials: its warps' column sums, added in warp order
#pragma unroll
  for (int round = 0; round < 2; ++round) {
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int c = lane + 32 * k;
      if (c < D) part[warp * D + c] = round == 0 ? acc_s[k] : acc_b[k];
    }
    __syncthreads();
    float* dst = (round == 0 ? dscale_p : dbias_p) + static_cast<long long>(blockIdx.x) * D;
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      float t = 0.f;
      for (int i = 0; i < kRowWarps; ++i) t += part[i * D + c];
      dst[c] = t;
    }
    __syncthreads();
  }
}

// ---- K8, one block per range of rows; each thread owns columns c = tid + k * blockDim
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
fused_norm_bwd_block_kernel(const T* __restrict__ x, const void* __restrict__ scale, int scode,
                            const float* __restrict__ mu, const float* __restrict__ rstd,
                            const T* __restrict__ dout, T* __restrict__ dx, float* dscale_p,
                            float* dbias_p, int N, int D, int rows_per_block, int rms,
                            int acc_in_smem) {
  extern __shared__ float smem[];
  float* red = smem;  // kRed, then the column sums (2 x D) when acc_in_smem
  const long long base = static_cast<long long>(blockIdx.x) * D;
  float* acc_s = acc_in_smem ? smem + kRed : dscale_p + base;
  float* acc_b = acc_in_smem ? smem + kRed + D : dbias_p + base;
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    acc_s[c] = 0.f;
    acc_b[c] = 0.f;
  }
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(r0 + rows_per_block, static_cast<long long>(N));
  for (long long row = r0; row < r1; ++row) {
    const float m = mu[row], rs = rstd[row];
    const T* xr = x + row * D;
    const T* gr = dout + row * D;
    float s1 = 0.f, s2 = 0.f;
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      const float xh = (to_f32(xr[c]) - m) * rs;
      const float dxh = to_f32(gr[c]) * load_w(scale, scode, c);
      s1 += dxh;
      s2 += dxh * xh;
    }
    block_sum2(s1, s2, red);
    const float m1 = rms ? 0.f : s1 / D;
    const float m2 = s2 / D;
    T* dr = dx + row * D;
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      const float g = to_f32(gr[c]);
      const float xh = (to_f32(xr[c]) - m) * rs;
      const float dxh = g * load_w(scale, scode, c);
      dr[c] = from_f32<T>(rs * (dxh - m1 - xh * m2));
      acc_s[c] += g * xh;
      acc_b[c] += g;
    }
  }
  if (acc_in_smem) {
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      dscale_p[base + c] = acc_s[c];
      dbias_p[base + c] = acc_b[c];
    }
  }
}

struct Args {
  const void* x;
  const void* scale;
  int scode;
  const void* bias;  // K7 only; may be null
  int bcode;
  void* out;         // K7: out; K8: dx
  float* mu;
  float* rstd;
  const void* dout;  // K8 only
  float* dscale_p;   // K8 only
  float* dbias_p;    // K8 only
  int N, D, nb;
  float eps;
  int rms;
  cudaStream_t stream;
};

// Threads of a block-per-row kernel: about 8 elements each, a multiple of 32.
int block_threads(int D) {
  const int t = ((D + 7) / 8 + 31) / 32 * 32;
  return t > kMaxThreads ? kMaxThreads : t;
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= static_cast<size_t>(kDefaultSmem)) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <typename T, int VPT>
int fwd_warp(const Args& a) {
  const unsigned grid = static_cast<unsigned>((a.N + kRowWarps - 1) / kRowWarps);
  fused_norm_fwd_warp_kernel<T, VPT><<<grid, kRowWarps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.x), a.scale, a.scode, a.bias, a.bcode, static_cast<T*>(a.out),
      a.mu, a.rstd, a.N, a.D, a.eps, a.rms);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd(const Args& a) {
  if (a.D <= kWarpMaxD) {
    const int need = (a.D + 31) / 32;
    if (need <= 1) return fwd_warp<T, 1>(a);
    if (need <= 2) return fwd_warp<T, 2>(a);
    if (need <= 4) return fwd_warp<T, 4>(a);
    if (need <= 8) return fwd_warp<T, 8>(a);
    if (need <= 12) return fwd_warp<T, 12>(a);
    if (need <= 16) return fwd_warp<T, 16>(a);
    if (need <= 24) return fwd_warp<T, 24>(a);
    return fwd_warp<T, 32>(a);
  }
  const size_t row_bytes = (kRed + static_cast<size_t>(a.D)) * sizeof(float);
  const int resident = row_bytes <= static_cast<size_t>(kSmemLimit);
  const size_t smem = resident ? row_bytes : kRed * sizeof(float);
  const int err = allow_smem(fused_norm_fwd_block_kernel<T>, smem);
  if (err != 0) return err;
  fused_norm_fwd_block_kernel<T><<<a.N, block_threads(a.D), smem, a.stream>>>(
      static_cast<const T*>(a.x), a.scale, a.scode, a.bias, a.bcode, static_cast<T*>(a.out),
      a.mu, a.rstd, a.D, a.eps, a.rms, resident);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VPT>
int bwd_warp(const Args& a, int rows_per_block) {
  const size_t smem = static_cast<size_t>(kRowWarps) * a.D * sizeof(float);  // <= 32 KB
  fused_norm_bwd_warp_kernel<T, VPT><<<a.nb, kRowWarps * 32, smem, a.stream>>>(
      static_cast<const T*>(a.x), a.scale, a.scode, a.mu, a.rstd, static_cast<const T*>(a.dout),
      static_cast<T*>(a.out), a.dscale_p, a.dbias_p, a.N, a.D, rows_per_block, a.rms);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const Args& a) {
  const int rpb = (a.N + a.nb - 1) / a.nb;
  if (a.D <= kWarpMaxD) {
    const int need = (a.D + 31) / 32;
    if (need <= 1) return bwd_warp<T, 1>(a, rpb);
    if (need <= 2) return bwd_warp<T, 2>(a, rpb);
    if (need <= 4) return bwd_warp<T, 4>(a, rpb);
    if (need <= 8) return bwd_warp<T, 8>(a, rpb);
    if (need <= 12) return bwd_warp<T, 12>(a, rpb);
    if (need <= 16) return bwd_warp<T, 16>(a, rpb);
    if (need <= 24) return bwd_warp<T, 24>(a, rpb);
    return bwd_warp<T, 32>(a, rpb);
  }
  const size_t acc_bytes = (kRed + 2 * static_cast<size_t>(a.D)) * sizeof(float);
  const int acc_in_smem = acc_bytes <= static_cast<size_t>(kSmemLimit);
  const size_t smem = acc_in_smem ? acc_bytes : kRed * sizeof(float);
  const int err = allow_smem(fused_norm_bwd_block_kernel<T>, smem);
  if (err != 0) return err;
  fused_norm_bwd_block_kernel<T><<<a.nb, block_threads(a.D), smem, a.stream>>>(
      static_cast<const T*>(a.x), a.scale, a.scode, a.mu, a.rstd, static_cast<const T*>(a.dout),
      static_cast<T*>(a.out), a.dscale_p, a.dbias_p, a.N, a.D, rpb, a.rms, acc_in_smem);
  return static_cast<int>(cudaGetLastError());
}

bool valid_code(int code) { return code >= 0 && code <= 2; }

}  // namespace

// K7. dtype (x and out) and the scale/bias codes: 0 = float32, 1 = float16,
// 2 = bfloat16. bias may be null (bias_dtype is then ignored). mu and rstd
// receive N floats each. rms: 0 LayerNorm, 1 RMSNorm.
extern "C" int dstorch_fused_norm_fwd(int dtype, const void* x, const void* scale,
                                      int scale_dtype, const void* bias, int bias_dtype,
                                      void* out, void* mu, void* rstd, int N, int D, float eps,
                                      int rms, void* stream) {
  if (N < 1 || D < 1 || !valid_code(scale_dtype) || (bias != nullptr && !valid_code(bias_dtype)))
    return -1;
  Args a{};
  a.x = x; a.scale = scale; a.scode = scale_dtype; a.bias = bias; a.bcode = bias_dtype;
  a.out = out; a.mu = static_cast<float*>(mu); a.rstd = static_cast<float*>(rstd);
  a.N = N; a.D = D; a.eps = eps; a.rms = rms;
  a.stream = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return fwd<float>(a);
    case 1: return fwd<__half>(a);
    case 2: return fwd<__nv_bfloat16>(a);
    default: return -1;
  }
}

// K8's block count nb, the rows of its partials, on a card with sm_count SMs:
// about two blocks per SM, each over a contiguous range of rows, and no more
// blocks than row units (a warp's 8 rows up to D = 1024, one row above).
extern "C" int dstorch_fused_norm_bwd_blocks(int N, int D, int sm_count) {
  if (N < 1 || D < 1 || sm_count < 1) return -1;
  const int unit = D <= kWarpMaxD ? kRowWarps : 1;
  const int units = (N + unit - 1) / unit;
  return units < 2 * sm_count ? units : 2 * sm_count;
}

// K8. dx has x's dtype; dscale_p and dbias_p receive nb x D f32 partial sums,
// one row per block, each over a contiguous range of ceil(N / nb) rows.
extern "C" int dstorch_fused_norm_bwd(int dtype, const void* x, const void* scale,
                                      int scale_dtype, const void* mu, const void* rstd,
                                      const void* dout, void* dx, void* dscale_p, void* dbias_p,
                                      int N, int D, int nb, int rms, void* stream) {
  if (N < 1 || D < 1 || nb < 1 || nb > N || !valid_code(scale_dtype)) return -1;
  Args a{};
  a.x = x; a.scale = scale; a.scode = scale_dtype;
  a.mu = static_cast<float*>(const_cast<void*>(mu));
  a.rstd = static_cast<float*>(const_cast<void*>(rstd));
  a.dout = dout; a.out = dx;
  a.dscale_p = static_cast<float*>(dscale_p); a.dbias_p = static_cast<float*>(dbias_p);
  a.N = N; a.D = D; a.nb = nb; a.rms = rms;
  a.stream = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return bwd<float>(a);
    case 1: return bwd<__half>(a);
    case 2: return bwd<__nv_bfloat16>(a);
    default: return -1;
  }
}
