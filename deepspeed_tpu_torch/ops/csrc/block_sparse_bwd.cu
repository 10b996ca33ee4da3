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
// before every dot (:78-81, :109-112): p and ds are never rounded (unlike
// the flash backward K2/K3, whose TPU kernels round them), and dq, dk and dv
// are rounded to the input dtype once, at the store. There is no GQA in the
// kernels: the model repeats the kv heads before the call, as the JAX
// package does (models/transformer.py:541-543), and autograd sums the group.
//
// Design. 128 threads per block; tiles, tile lists and the thread layout as
// in block_sparse.cuh. The TPU grids walk every tile of a row (K5) or a
// column (K6) and test the layout at each (:76, :107); here a block walks
// only its list, in ascending order:
//  - K5: one block per (query tile, batch * head), over the live k-tiles of
//    its row; dq stays in registers and is written once.
//  - K6: one block per (key tile, batch * head), over the live q-tiles of its
//    column (the transposed lists); dk and dv stay in registers and are
//    written once.
// Nothing is carried between blocks: no atomics and no second pass. Under
// causal the lists hold no tile above the diagonal (those add p = 0).
//
// What bounds it on an H100. K5 does 6 * hd FLOPs per pair the layout and
// the mask let through (q k^T, do v^T, ds k), K6 8 * hd (q k^T, do v^T,
// p^T do, ds^T q); each reads q, k, v and do once, plus lse and delta, and
// writes its gradients once. At the training shape (B2 S4096 H12 hd64 bf16,
// fixed layout, causal) that is 23 and 31 GFLOP over 64 and 76 MB: just
// above the bf16 ridge, so the bound is the tensor-core rate, 23 and 31 us.
// At the f32 CUDA-core rate (the TPU kernels' f32 math) it is 0.34 and
// 0.46 ms. This version does f32 FMAs from shared memory: that ceiling and
// the shared-memory traffic limit it. K6's columns differ in length (a
// global column of the fixed layout is live in every row below it), so its
// blocks are uneven; wgmma products and splitting long columns come next.
//
// Interface: plain C, loaded with ctypes. Strides are in elements, the last
// dimension of q, k, v and do must be contiguous; lse and delta are
// contiguous (B, H, Sq) f32; dq is a contiguous (B, Sq, H, hd) tensor, dk
// and dv contiguous (B, Sk, H, hd). Launches go on the caller's stream; the
// return value is cudaGetLastError().

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

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  const int *ptr, *idx;  // the row lists (K5) or the column lists (K6)
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

template <typename T, int HD, bool DQ>
int dispatch_tile(int tile, const Args& a) {
  switch (tile) {
    case 16: return DQ ? launch_dq<T, HD, 16>(a) : launch_dkv<T, HD, 16>(a);
    case 32: return DQ ? launch_dq<T, HD, 32>(a) : launch_dkv<T, HD, 32>(a);
    case 64: return DQ ? launch_dq<T, HD, 64>(a) : launch_dkv<T, HD, 64>(a);
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
               const void* delta, const void* ptr, const void* idx, int B, int H, int Sq,
               int Sk, int n, const long long* strides, float sm_scale, int causal,
               void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.ptr = static_cast<const int*>(ptr);
  a.idx = static_cast<const int*>(idx);
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
// offsets), col_ptr/rows the column lists (H * nk + 1 offsets). Return
// cudaGetLastError() after the launch, or -1 for an unsupported dtype, head
// size or tile.
extern "C" int dstorch_block_sparse_bwd_dq(int dtype, int hd, int tile, const void* q,
                                           const void* k, const void* v, const void* dout,
                                           const void* lse, const void* delta, void* dq,
                                           const void* row_ptr, const void* cols, int B, int H,
                                           int Sq, int Sk, int nq, const long long* strides,
                                           float sm_scale, int causal, void* stream) {
  Args a = make_args(q, k, v, dout, lse, delta, row_ptr, cols, B, H, Sq, Sk, nq, strides,
                     sm_scale, causal, stream);
  a.dq = dq;
  return dispatch<true>(dtype, hd, tile, a);
}

extern "C" int dstorch_block_sparse_bwd_dkv(int dtype, int hd, int tile, const void* q,
                                            const void* k, const void* v, const void* dout,
                                            const void* lse, const void* delta, void* dk,
                                            void* dv, const void* col_ptr, const void* rows,
                                            int B, int H, int Sq, int Sk, int nk,
                                            const long long* strides, float sm_scale,
                                            int causal, void* stream) {
  Args a = make_args(q, k, v, dout, lse, delta, col_ptr, rows, B, H, Sq, Sk, nk, strides,
                     sm_scale, causal, stream);
  a.dk = dk;
  a.dv = dv;
  return dispatch<false>(dtype, hd, tile, a);
}
