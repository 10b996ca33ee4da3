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
//       dx in x's dtype, and the sums over all rows of do * xhat (dscale) and do
//       (dbias). As the TPU kernel writes per-block partial sums that _run_bwd
//       adds after its pallas_call, the main kernel writes one f32 partial row
//       per block, and a second kernel of the same call (fused_norm_colsum_kernel)
//       adds them in a fixed order and writes dscale and dbias in the dtypes the
//       caller asks for (under autograd, the weights' own). No torch.sum and no
//       cast after it.
//
// What bounds it on an H100: bytes. A few FLOPs per element against 2 (K7) or
// 3 (K8) element reads and writes; the bound is x and out (K7), x, do and dx
// (K8) over the H100 SXM's published 3.35 TB/s. The first design of these
// kernels ran 3.7x (K7) and 4.8x (K8) over it at GPT-2 125M's rows, about as
// fast from L2 as from device memory: a latency chain (2-byte loads, one row
// per warp in a single wave, weights read again per element), not memory, set
// its time.
//
// Design.
//   - Register kernels, for rows of up to 256 threads x 4 chunks of 16 bytes
//     (8192 16-bit values, 4096 f32): a row belongs to a group of tpr threads
//     (one warp up to 1024 16-bit / 512 f32 values, then 2, 4 or 8 warps),
//     max(tpr, 128) threads a block (small blocks: the SM's registers hold
//     more of them). Thread t holds the row's chunks k < nv, chunk k being
//     elements (k * tpr + t) * VEC .. + VEC - 1 (VEC = 8 for 16-bit dtypes, 4
//     for f32), packed in registers: K7's two passes and K8's two means read x
//     (and do) from device memory once. After each row sum the chunks are
//     hidden from the compiler (launder), so that it converts them again
//     rather than keep every f32 value alive across the sum.
//   - Two load paths, chosen by the wrapper from (dtype, D, alignment) alone:
//     the vector path reads and writes each chunk with one 16-byte access (D a
//     multiple of VEC, the row tensors 16-byte aligned); the scalar path reads
//     and writes its elements one by one, for any D and base address.
//   - Latency hidden: the grid is what the card holds at once (the wrapper's
//     plan, from each instantiation's occupancy), every row group walks rows
//     with the grid's stride, and a row's loads are issued before the previous
//     row's reductions, so one row's shuffles and stores overlap the next
//     row's memory latency.
//   - scale (and bias) are read once per thread into registers, packed in
//     their own dtype (hidden from the compiler once a row, so that it does not
//     hold them as f32), a template parameter (x's dtype or f32: the wrapper
//     casts any other mix to f32 first, exactly).
//   - Row sums: xor shuffles in each warp; across a row's warps, their sums in
//     warp order through shared memory (two buffers in turn: one barrier a sum).
//   - K8's column sums: each thread adds do * xhat and do over its group's rows
//     in registers; the block adds its groups' sums in group order into its
//     partial row (nb x D per sum, nb = the grid); the second kernel gives each
//     of 32 slices of a column's partial rows to one thread (rows slice, slice
//     + 32, ... in order), then adds the 32 slices in order.
//   - Wide kernels, for wider rows: one block per row (K7) or per range of rows
//     (K8), element loads, up to 1024 threads; K7 keeps the row in shared memory
//     as f32 while it fits in 200 KB (D <= 51,136), else reads it again; K8 sums
//     its columns in shared memory (or, above D = 25,568, in its partial row).
// No float atomics anywhere: every sum has a fixed order, so two calls on the
// same inputs (and the same plan) give the same bits.
//
// Interface: plain C, loaded with ctypes. Every call takes the wrapper's plan,
// an int array (PlanField below); the C side checks it before it launches. x, do
// and dx are contiguous (N, D) tensors of one dtype; scale and bias contiguous
// (D,) tensors of the plan's weight dtype; stats (K7's mu then rstd), mu and
// rstd contiguous f32. Launches go on the caller's stream; the return value is
// cudaGetLastError(), or -1 for a plan or argument the kernels do not take.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kBlockThreads = 256;      // register kernels: most threads a block,
constexpr int kMinBlockThreads = 128;   // and fewest (max(tpr, 128) a block)
constexpr int kMaxChunks = 4;           // 16-byte chunks of a row a thread holds
constexpr int kMaxRowWarps = kBlockThreads / 32;
constexpr int kColsumCols = 32;         // the partials' sum: columns per block,
constexpr int kColsumSlices = 32;       // and slices of each column's partial rows
constexpr int kMaxThreads = 1024;       // wide kernels
constexpr int kRed = 64;                // floats of shared memory for block sums
constexpr int kSmemLimit = 200 * 1024;  // dynamic shared memory a block may ask for here
constexpr int kDefaultSmem = 48 * 1024; // above this a kernel needs cudaFuncSetAttribute

// The plan, an int array the wrapper fills (fused_norm._Plan, the same fields
// in this order; it checks kPlanFields, kGrid and the limits above against its
// own when it loads the library, dstorch_fused_norm_layout).
enum PlanField {
  kDtype,     // x, out, do, dx: 0 float32, 1 float16, 2 bfloat16
  kWdtype,    // scale and bias: x's dtype or 0
  kVariant,   // 0 scalar, 1 vector, 2 wide
  kTpr,       // register kernels: threads per row, a multiple of 32
  kRpb,       //   rows per block (tpr * rpb = max(tpr, 128)); wide: 1
  kChunks,    //   16-byte chunks per thread, 1..4; wide: 0
  kGrid,      // blocks; K8: also the rows of its partials
  kN,
  kD,
  kRms,       // 0 LayerNorm, 1 RMSNorm
  kSdtype,    // K8: dscale's dtype
  kBdtype,    // K8: dbias's dtype
  kDevice,    // the CUDA device the tensors are on
  kPlanFields
};
enum Variant { kScalar = 0, kVector = 1, kWide = 2 };

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

// 16 bytes of a row: one vector access on the vector path.
template <typename T> struct alignas(16) Chunk {
  static constexpr int kVec = 16 / sizeof(T);
  T e[kVec];
};

// The chunk that starts at element `start` of a row; 0 past D.
template <typename T, bool VECTOR>
__device__ __forceinline__ Chunk<T> load_chunk(const T* __restrict__ row, int start, int D) {
  Chunk<T> c;
  if (VECTOR && start < D) return *reinterpret_cast<const Chunk<T>*>(row + start);
#pragma unroll
  for (int j = 0; j < Chunk<T>::kVec; ++j)
    c.e[j] = !VECTOR && start + j < D ? row[start + j] : from_f32<T>(0.f);
  return c;
}

template <typename T, bool VECTOR>
__device__ __forceinline__ void store_chunk(T* __restrict__ row, int start, int D,
                                            const Chunk<T>& c) {
  if (VECTOR) {
    if (start < D) *reinterpret_cast<Chunk<T>*>(row + start) = c;
    return;
  }
#pragma unroll
  for (int j = 0; j < Chunk<T>::kVec; ++j)
    if (start + j < D) row[start + j] = c.e[j];
}

// Hides a chunk's bits from the compiler: what was computed from them before
// is computed again after, not kept in registers across a row's sums.
template <typename T>
__device__ __forceinline__ void launder(Chunk<T>& c) {
  uint4 u;
  memcpy(&u, &c, sizeof(u));
  asm volatile("" : "+r"(u.x), "+r"(u.y), "+r"(u.z), "+r"(u.w));
  memcpy(&c, &u, sizeof(u));
}

// A thread's weights for its chunks of x, kept packed in W: chunk k of x
// (VEC elements) has VEC * sizeof(W) / 16 chunks of W, read once, element by
// element (no alignment asked of the weights).
template <typename T, typename W, int NV>
struct Weights {
  static constexpr int kVec = Chunk<T>::kVec, kWVec = Chunk<W>::kVec;
  static constexpr int kParts = kVec / kWVec;
  Chunk<W> c[NV][kParts];
  __device__ __forceinline__ void load(const W* __restrict__ w, int tpr, int t, int D) {
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int q = 0; q < kParts; ++q)
        c[k][q] = load_chunk<W, false>(w, (k * tpr + t) * kVec + q * kWVec, w != nullptr ? D : 0);
  }
  __device__ __forceinline__ float operator()(int k, int j) const {
    return to_f32(c[k][j / kWVec].e[j % kWVec]);
  }
  // once a row: the weights stay packed rather than held as f32 across rows
  __device__ __forceinline__ void launder_all() {
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int q = 0; q < kParts; ++q) launder(c[k][q]);
  }
};

// Sum over the warp by xor shuffles: every lane gets the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums v[0..K) over the row group (the blockDim.x threads of one threadIdx.y):
// each warp's sums by shuffles, then, for groups wider than a warp, the warps'
// sums in warp order through shared memory. red holds two buffers used in turn,
// so one barrier a call suffices: a buffer is written again only after the next
// call's barrier, which each thread reaches after reading it. Every thread of
// the group gets the same totals; every thread of the block must call it.
template <int K>
__device__ __forceinline__ void group_sum(float (&v)[K], float (*red)[kMaxRowWarps][2],
                                          int& parity) {
#pragma unroll
  for (int i = 0; i < K; ++i) v[i] = warp_sum(v[i]);
  const int wpr = blockDim.x >> 5;
  if (wpr == 1) return;  // the same for the whole block
  const int base = threadIdx.y * wpr, warp = threadIdx.x >> 5;
  float(*buf)[2] = red[parity];
  parity ^= 1;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < K; ++i) buf[base + warp][i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float t = 0.f;
    for (int w = 0; w < wpr; ++w) t += buf[base + w][i];
    v[i] = t;
  }
}

// Rows of a register kernel: group threadIdx.y of block b takes rows
// b * rpb + threadIdx.y + i * gridDim.x * rpb. Every group of the block loops
// as often as its first group, so that barriers line up; rows past N are idle.
struct RowWalk {
  long long row, stride, iters;
  __device__ __forceinline__ RowWalk(int N) {
    stride = static_cast<long long>(gridDim.x) * blockDim.y;
    const long long first = static_cast<long long>(blockIdx.x) * blockDim.y;
    iters = first < N ? (N - 1 - first) / stride + 1 : 0;
    row = first + threadIdx.y;
  }
};

// ---- K7, register kernel
template <typename T, typename W, int NV, bool VECTOR>
__global__ void __launch_bounds__(kBlockThreads, 1)
fused_norm_fwd_kernel(const T* __restrict__ x, const W* __restrict__ scale,
                      const W* __restrict__ bias, T* __restrict__ out,
                      float* __restrict__ stats, int N, int D, float eps, int rms) {
  constexpr int VEC = Chunk<T>::kVec;
  __shared__ float red[2][kMaxRowWarps][2];
  const int tpr = blockDim.x, t = threadIdx.x;
  Weights<T, W, NV> w, b;  // b is 0 without a bias
  w.load(scale, tpr, t, D);
  b.load(bias, tpr, t, D);
  RowWalk walk(N);
  int parity = 0;
  Chunk<T> cur[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k)
    cur[k] = load_chunk<T, VECTOR>(x + (walk.row < N ? walk.row : 0) * D, (k * tpr + t) * VEC,
                                   walk.row < N ? D : 0);
  for (long long it = 0; it < walk.iters; ++it, walk.row += walk.stride) {
    const long long row = walk.row, next = row + walk.stride;
    w.launder_all();
    b.launder_all();
    Chunk<T> nxt[NV];  // the next row's loads, issued before this row's sums
#pragma unroll
    for (int k = 0; k < NV; ++k)
      nxt[k] = load_chunk<T, VECTOR>(x + (next < N ? next : 0) * D, (k * tpr + t) * VEC,
                                     next < N ? D : 0);
    float s[1] = {0.f};
    if (!rms) {
#pragma unroll
      for (int k = 0; k < NV; ++k)
#pragma unroll
        for (int j = 0; j < VEC; ++j) s[0] += to_f32(cur[k].e[j]);  // 0 past D
      group_sum(s, red, parity);
#pragma unroll
      for (int k = 0; k < NV; ++k) launder(cur[k]);
    }
    const float mu = rms ? 0.f : s[0] / D;
    float q[1] = {0.f};
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int start = (k * tpr + t) * VEC;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const bool in = VECTOR ? start < D : start + j < D;
        const float d = in ? to_f32(cur[k].e[j]) - mu : 0.f;
        q[0] += d * d;
      }
    }
    group_sum(q, red, parity);
#pragma unroll
    for (int k = 0; k < NV; ++k) launder(cur[k]);
    const float rstd = rsqrtf(q[0] / D + eps);
    if (row < N) {
      T* orow = out + row * D;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        Chunk<T> o;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          o.e[j] = from_f32<T>((to_f32(cur[k].e[j]) - mu) * rstd * w(k, j) + b(k, j));
        store_chunk<T, VECTOR>(orow, (k * tpr + t) * VEC, D, o);
      }
      if (t == 0 && stats != nullptr) {
        stats[row] = mu;
        stats[N + row] = rstd;
      }
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) cur[k] = nxt[k];
  }
}

// ---- K8, register kernel: dx, and the block's partial row of each column sum
// (partials: gridDim.x dscale rows, then gridDim.x dbias rows)
template <typename T, typename W, int NV, bool VECTOR>
__global__ void __launch_bounds__(kBlockThreads, 1)
fused_norm_bwd_kernel(const T* __restrict__ x, const W* __restrict__ scale,
                      const float* __restrict__ mu, const float* __restrict__ rstd,
                      const T* __restrict__ dout, T* __restrict__ dx,
                      float* __restrict__ partials, int N, int D, int rms) {
  constexpr int VEC = Chunk<T>::kVec;
  extern __shared__ float part[];  // blockDim.y x D: the groups' column sums
  __shared__ float red[2][kMaxRowWarps][2];
  const int tpr = blockDim.x, t = threadIdx.x;
  Weights<T, W, NV> w;
  w.load(scale, tpr, t, D);
  float acc_s[NV][VEC], acc_b[NV][VEC];
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      acc_s[k][j] = 0.f;
      acc_b[k][j] = 0.f;
    }
  RowWalk walk(N);
  int parity = 0;
  Chunk<T> cx[NV], cg[NV];
  float cm = 0.f, cr = 0.f;
  {
    const bool in = walk.row < N;
    const long long r = in ? walk.row : 0;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      cx[k] = load_chunk<T, VECTOR>(x + r * D, (k * tpr + t) * VEC, in ? D : 0);
      cg[k] = load_chunk<T, VECTOR>(dout + r * D, (k * tpr + t) * VEC, in ? D : 0);
    }
    if (in) {
      cm = mu[r];
      cr = rstd[r];
    }
  }
  for (long long it = 0; it < walk.iters; ++it, walk.row += walk.stride) {
    const long long row = walk.row, next = row + walk.stride;
    w.launder_all();
    const bool in = next < N;
    const long long r = in ? next : 0;
    Chunk<T> nx[NV], ng[NV];  // the next row's loads, issued before this row's sums
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      nx[k] = load_chunk<T, VECTOR>(x + r * D, (k * tpr + t) * VEC, in ? D : 0);
      ng[k] = load_chunk<T, VECTOR>(dout + r * D, (k * tpr + t) * VEC, in ? D : 0);
    }
    const float nm = in ? mu[r] : 0.f, nr = in ? rstd[r] : 0.f;
    // past D, and in rows past N, the chunks are 0 (and so are cm and cr):
    // every term below is then 0, so no element needs a mask
    float v[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float g = to_f32(cg[k].e[j]);
        const float xh = (to_f32(cx[k].e[j]) - cm) * cr;
        const float dxh = __fmul_rn(g, w(k, j));  // the same rounding as in dx below
        v[0] += dxh;
        v[1] += dxh * xh;
        acc_s[k][j] += g * xh;
        acc_b[k][j] += g;
      }
    group_sum(v, red, parity);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      launder(cx[k]);
      launder(cg[k]);
    }
    const float m1 = rms ? 0.f : v[0] / D;
    const float m2 = v[1] / D;
    if (row < N) {
      T* drow = dx + row * D;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        Chunk<T> o;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xh = (to_f32(cx[k].e[j]) - cm) * cr;
          const float dxh = __fmul_rn(to_f32(cg[k].e[j]), w(k, j));
          o.e[j] = from_f32<T>(cr * (dxh - m1 - xh * m2));
        }
        store_chunk<T, VECTOR>(drow, (k * tpr + t) * VEC, D, o);
      }
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      cx[k] = nx[k];
      cg[k] = ng[k];
    }
    cm = nm;
    cr = nr;
  }
  // the block's partial rows: its groups' column sums, added in group order
  const long long nb = gridDim.x;
  float* dst_s = partials + blockIdx.x * static_cast<long long>(D);
  float* dst_b = partials + (nb + blockIdx.x) * static_cast<long long>(D);
  if (blockDim.y == 1) {
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int c = (k * tpr + t) * VEC + j;
        if (c < D) {
          dst_s[c] = acc_s[k][j];
          dst_b[c] = acc_b[k][j];
        }
      }
    return;
  }
  const int flat = threadIdx.y * tpr + t;
#pragma unroll
  for (int round = 0; round < 2; ++round) {
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int c = (k * tpr + t) * VEC + j;
        if (c < D) part[threadIdx.y * D + c] = round == 0 ? acc_s[k][j] : acc_b[k][j];
      }
    __syncthreads();
    float* dst = round == 0 ? dst_s : dst_b;
    for (int c = flat; c < D; c += tpr * blockDim.y) {
      float s = 0.f;
      for (int i = 0; i < static_cast<int>(blockDim.y); ++i) s += part[i * D + c];
      dst[c] = s;
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void store_as(void* p, int code, int i, float v) {
  if (code == 0) static_cast<float*>(p)[i] = v;
  else if (code == 1) static_cast<__half*>(p)[i] = __float2half_rn(v);
  else static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
}

// ---- K8's column sums: the nb partial rows of each sum added in a fixed order
// (slice i adds rows i, i + 32, ...; then the 32 slices in order), written once
// in the dtype asked for; dbias may be null.
__global__ void __launch_bounds__(kColsumCols * kColsumSlices)
fused_norm_colsum_kernel(const float* __restrict__ partials, int nb, int D, void* dscale,
                         int scode, void* dbias, int bcode) {
  __shared__ float part[2][kColsumSlices][kColsumCols + 1];
  const int c = blockIdx.x * kColsumCols + threadIdx.x;
  float s = 0.f, b = 0.f;
  if (c < D) {
    for (int r = threadIdx.y; r < nb; r += kColsumSlices) {
      s += partials[static_cast<long long>(r) * D + c];
      b += partials[(static_cast<long long>(nb) + r) * D + c];
    }
  }
  part[0][threadIdx.y][threadIdx.x] = s;
  part[1][threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y < 2 && c < D) {
    void* dst = threadIdx.y == 0 ? dscale : dbias;
    if (dst == nullptr) return;
    float total = 0.f;
    for (int i = 0; i < kColsumSlices; ++i) total += part[threadIdx.y][i][threadIdx.x];
    store_as(dst, threadIdx.y == 0 ? scode : bcode, c, total);
  }
}

// ---- wide kernels (rows wider than the register kernels hold)

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

// K7, one block per row; the row kept in shared memory when resident
template <typename T, typename W>
__global__ void __launch_bounds__(kMaxThreads)
fused_norm_fwd_wide_kernel(const T* __restrict__ x, const W* __restrict__ scale,
                           const W* __restrict__ bias, T* __restrict__ out,
                           float* __restrict__ stats, int N, int D, float eps, int rms,
                           int resident) {
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
    float y = (v - mu) * rstd * to_f32(scale[c]);
    if (bias != nullptr) y += to_f32(bias[c]);
    orow[c] = from_f32<T>(y);
  }
  if (threadIdx.x == 0 && stats != nullptr) {
    stats[row] = mu;
    stats[N + row] = rstd;
  }
}

// K8, one block per range of rows; each thread owns columns c = tid + k * blockDim
template <typename T, typename W>
__global__ void __launch_bounds__(kMaxThreads)
fused_norm_bwd_wide_kernel(const T* __restrict__ x, const W* __restrict__ scale,
                           const float* __restrict__ mu, const float* __restrict__ rstd,
                           const T* __restrict__ dout, T* __restrict__ dx, float* partials,
                           int N, int D, int rows_per_block, int rms, int acc_in_smem) {
  extern __shared__ float smem[];
  float* red = smem;  // kRed, then the column sums (2 x D) when acc_in_smem
  const long long nb = gridDim.x;
  float* dscale_p = partials + blockIdx.x * static_cast<long long>(D);
  float* dbias_p = partials + (nb + blockIdx.x) * static_cast<long long>(D);
  float* acc_s = acc_in_smem ? smem + kRed : dscale_p;
  float* acc_b = acc_in_smem ? smem + kRed + D : dbias_p;
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
      const float dxh = to_f32(gr[c]) * to_f32(scale[c]);
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
      const float dxh = g * to_f32(scale[c]);
      dr[c] = from_f32<T>(rs * (dxh - m1 - xh * m2));
      acc_s[c] += g * xh;
      acc_b[c] += g;
    }
  }
  if (acc_in_smem) {
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      dscale_p[c] = acc_s[c];
      dbias_p[c] = acc_b[c];
    }
  }
}

// Threads of a wide kernel: about 8 elements each, a multiple of 32.
int wide_threads(int D) {
  const int t = ((D + 7) / 8 + 31) / 32 * 32;
  return t > kMaxThreads ? kMaxThreads : t;
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= static_cast<size_t>(kDefaultSmem)) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

// ---- the plan's (dtype, weight dtype) and (chunks, path) as template arguments
template <typename T> struct Tag { using type = T; };
template <int V> using IntC = std::integral_constant<int, V>;
template <bool V> using BoolC = std::integral_constant<bool, V>;

template <typename F>
int with_types(const int* p, F&& f) {
  const int wd = p[kWdtype];
  switch (p[kDtype]) {
    case 0: return wd == 0 ? f(Tag<float>{}, Tag<float>{}) : -1;
    case 1: return wd == 1 ? f(Tag<__half>{}, Tag<__half>{})
                           : wd == 0 ? f(Tag<__half>{}, Tag<float>{}) : -1;
    case 2: return wd == 2 ? f(Tag<__nv_bfloat16>{}, Tag<__nv_bfloat16>{})
                           : wd == 0 ? f(Tag<__nv_bfloat16>{}, Tag<float>{}) : -1;
    default: return -1;
  }
}

template <typename F>
int with_shape(const int* p, F&& f) {
  const bool vec = p[kVariant] == kVector;
  switch (p[kChunks]) {
    case 1: return vec ? f(IntC<1>{}, BoolC<true>{}) : f(IntC<1>{}, BoolC<false>{});
    case 2: return vec ? f(IntC<2>{}, BoolC<true>{}) : f(IntC<2>{}, BoolC<false>{});
    case 3: return vec ? f(IntC<3>{}, BoolC<true>{}) : f(IntC<3>{}, BoolC<false>{});
    case 4: return vec ? f(IntC<4>{}, BoolC<true>{}) : f(IntC<4>{}, BoolC<false>{});
    default: return -1;
  }
}

int elem_bytes(int code) { return code == 0 ? 4 : 2; }

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Makes the plan's device current for a launch and restores the caller's after.
struct DeviceGuard {
  int prev = -1, dev;
  explicit DeviceGuard(int d) : dev(d) {
    cudaGetDevice(&prev);
    if (prev != dev) cudaSetDevice(dev);
  }
  ~DeviceGuard() {
    if (prev >= 0 && prev != dev) cudaSetDevice(prev);
  }
};

// The plan's own consistency: what the kernels assume of it.
bool valid_plan(const int* p, bool bwd) {
  const int N = p[kN], D = p[kD];
  if (N < 1 || D < 1 || p[kGrid] < 1 || p[kDtype] < 0 || p[kDtype] > 2 || p[kDevice] < 0)
    return false;
  if (bwd && (p[kSdtype] < 0 || p[kSdtype] > 2 || p[kBdtype] < 0 || p[kBdtype] > 2)) return false;
  if (p[kVariant] == kWide) return bwd ? p[kGrid] <= N : p[kGrid] == N;
  if (p[kVariant] != kScalar && p[kVariant] != kVector) return false;
  const int tpr = p[kTpr], rpb = p[kRpb], nv = p[kChunks];
  const int vec = 16 / elem_bytes(p[kDtype]);
  const int threads = tpr > kMinBlockThreads ? tpr : kMinBlockThreads;
  if (tpr < 32 || tpr % 32 != 0 || tpr > kBlockThreads || tpr * rpb != threads || nv < 1 ||
      nv > kMaxChunks)
    return false;
  if (static_cast<long long>(tpr) * nv * vec < D) return false;
  return p[kVariant] == kScalar || D % vec == 0;
}

}  // namespace

// The plan's layout and the register kernels' limits, for the wrapper to check
// against its own: fields, the grid's field, kBlockThreads, kMinBlockThreads,
// kMaxChunks.
extern "C" void dstorch_fused_norm_layout(int* out) {
  const int layout[5] = {kPlanFields, kGrid, kBlockThreads, kMinBlockThreads, kMaxChunks};
  memcpy(out, layout, sizeof(layout));
}

// K7 on the plan p: out (x's dtype), stats = mu (N floats) then rstd (N floats).
// bias may be null, and stats too (no backward reads them).
extern "C" int dstorch_fused_norm_fwd(const int* p, const void* x, const void* scale,
                                      const void* bias, void* out, void* stats, float eps,
                                      void* stream_ptr) {
  if (!valid_plan(p, false)) return -1;
  if (p[kVariant] == kVector && !(aligned16(x) && aligned16(out))) return -1;
  const DeviceGuard guard(p[kDevice]);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int N = p[kN], D = p[kD], rms = p[kRms];
  float* st = static_cast<float*>(stats);
  return with_types(p, [&](auto tt, auto wt) {
    using T = typename decltype(tt)::type;
    using W = typename decltype(wt)::type;
    const T* xt = static_cast<const T*>(x);
    const W* s = static_cast<const W*>(scale);
    const W* b = static_cast<const W*>(bias);
    T* o = static_cast<T*>(out);
    if (p[kVariant] == kWide) {
      const size_t row_bytes = (kRed + static_cast<size_t>(D)) * sizeof(float);
      const int resident = row_bytes <= static_cast<size_t>(kSmemLimit);
      const size_t smem = resident ? row_bytes : kRed * sizeof(float);
      const int err = allow_smem(fused_norm_fwd_wide_kernel<T, W>, smem);
      if (err != 0) return err;
      fused_norm_fwd_wide_kernel<T, W><<<N, wide_threads(D), smem, stream>>>(
          xt, s, b, o, st, N, D, eps, rms, resident);
      return static_cast<int>(cudaGetLastError());
    }
    return with_shape(p, [&](auto nv, auto vec) {
      fused_norm_fwd_kernel<T, W, decltype(nv)::value, decltype(vec)::value>
          <<<p[kGrid], dim3(p[kTpr], p[kRpb]), 0, stream>>>(xt, s, b, o, st, N, D, eps, rms);
      return static_cast<int>(cudaGetLastError());
    });
  });
}

// K8 on the plan p: dx (x's dtype); partials, 2 x grid x D f32 scratch; dscale
// and dbias (D values each, in the plan's sum dtypes; dbias may be null).
extern "C" int dstorch_fused_norm_bwd(const int* p, const void* x, const void* scale,
                                      const void* mu, const void* rstd, const void* dout,
                                      void* dx, void* partials, void* dscale, void* dbias,
                                      void* stream_ptr) {
  if (!valid_plan(p, true)) return -1;
  if (p[kVariant] == kVector && !(aligned16(x) && aligned16(dout) && aligned16(dx))) return -1;
  const DeviceGuard guard(p[kDevice]);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int N = p[kN], D = p[kD], nb = p[kGrid], rms = p[kRms];
  const float* m = static_cast<const float*>(mu);
  const float* r = static_cast<const float*>(rstd);
  float* part = static_cast<float*>(partials);
  const int err = with_types(p, [&](auto tt, auto wt) {
    using T = typename decltype(tt)::type;
    using W = typename decltype(wt)::type;
    const T* xt = static_cast<const T*>(x);
    const W* s = static_cast<const W*>(scale);
    const T* g = static_cast<const T*>(dout);
    T* d = static_cast<T*>(dx);
    if (p[kVariant] == kWide) {
      const int rpb = (N + nb - 1) / nb;
      const size_t acc_bytes = (kRed + 2 * static_cast<size_t>(D)) * sizeof(float);
      const int acc_in_smem = acc_bytes <= static_cast<size_t>(kSmemLimit);
      const size_t smem = acc_in_smem ? acc_bytes : kRed * sizeof(float);
      const int e = allow_smem(fused_norm_bwd_wide_kernel<T, W>, smem);
      if (e != 0) return e;
      fused_norm_bwd_wide_kernel<T, W><<<nb, wide_threads(D), smem, stream>>>(
          xt, s, m, r, g, d, part, N, D, rpb, rms, acc_in_smem);
      return static_cast<int>(cudaGetLastError());
    }
    const size_t smem = p[kRpb] > 1 ? static_cast<size_t>(p[kRpb]) * D * sizeof(float) : 0;
    return with_shape(p, [&](auto nv, auto vec) {
      fused_norm_bwd_kernel<T, W, decltype(nv)::value, decltype(vec)::value>
          <<<nb, dim3(p[kTpr], p[kRpb]), smem, stream>>>(xt, s, m, r, g, d, part, N, D, rms);
      return static_cast<int>(cudaGetLastError());
    });
  });
  if (err != 0) return err;
  fused_norm_colsum_kernel<<<(D + kColsumCols - 1) / kColsumCols,
                             dim3(kColsumCols, kColsumSlices), 0, stream>>>(
      part, nb, D, dscale, p[kSdtype], dbias, p[kBdtype]);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the plan's register kernel (bwd: 0 K7, 1 K8) that one SM holds at
// once, from the instantiation's registers and shared memory: the wrapper's
// grid is this times the SM count (or fewer, when there are fewer row groups).
// -1 for a plan the kernels do not take or a wide plan.
extern "C" int dstorch_fused_norm_blocks_per_sm(const int* p, int bwd) {
  if (!valid_plan(p, bwd != 0) || p[kVariant] == kWide) return -1;
  const DeviceGuard guard(p[kDevice]);
  const size_t smem =
      bwd && p[kRpb] > 1 ? static_cast<size_t>(p[kRpb]) * p[kD] * sizeof(float) : 0;
  return with_types(p, [&](auto tt, auto wt) {
    using T = typename decltype(tt)::type;
    using W = typename decltype(wt)::type;
    return with_shape(p, [&](auto nv, auto vec) {
      int blocks = 0;
      const int threads = p[kTpr] * p[kRpb];
      const cudaError_t e =
          bwd ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, fused_norm_bwd_kernel<T, W, decltype(nv)::value, decltype(vec)::value>,
                    threads, smem)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, fused_norm_fwd_kernel<T, W, decltype(nv)::value, decltype(vec)::value>,
                    threads, smem);
      return e == cudaSuccess ? blocks : -1;
    });
  });
}
