// Block-sparse attention forward (K4) for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel
// deepspeed_tpu/ops/pallas/block_sparse_attention.py::_sparse_fwd_kernel (driven
// by _fwd). Per (batch, head, query row), over the keys of the tiles whose
// layout entry is nonzero (and, when causal, kpos <= qpos):
//     o   = softmax(q k^T * sm_scale) v
//     lse = m + log(max(l, 1e-20))      (f32, laid out (B, H, Sq))
// All arithmetic is f32, as in the TPU kernel, which upcasts q, k and v before
// its dots (:44-47): products of input-dtype values are exact in f32, p is
// never rounded, and o is rounded to the input dtype once, at the store.
// A row whose layout row is all zero gets o = 0 and lse = -1e30 + log(1e-20),
// as the TPU kernel gives (acc 0 / max(l, 1e-20)).
//
// A row that only fully masked tiles reach (live tiles all above the
// diagonal) gets garbage from the TPU kernel: its first tile sees m = -1e30
// and p = exp(0) = 1. The tile lists drop those tiles under causal (see
// block_sparse.cuh), so here such a row is an all-zero row: o = 0, the
// answer of the dense reference (sparse_attention_reference). None of the
// five sparsity configs makes such a row: each keeps its diagonal tile.
//
// Design. One block of 128 threads per (TILE-row query tile, batch * head).
// The TPU grid walks all nk key tiles and tests layout[h, qi, ki] at each
// (:40); here the block walks only its row of the tile list, in ascending
// order as the TPU grid does. The running max m, sum l and the accumulator
// stay in f32 registers and o and lse are written once: nothing is carried
// between blocks, so no atomics and no second pass. Q, K and V tiles are
// staged in shared memory as f32; scores are f32 FMAs from shared memory.
//
// What bounds it on an H100. 4 * hd FLOPs per (query, key) pair that the
// layout and the causal mask let through, over q, k, v, o and lse each moved
// once. At the training shape (B2 S4096 H12 hd64 bf16, fixed layout, causal)
// that is 15.3 GFLOP over 51 MB, ~300 FLOPs per byte: at the bf16 tensor
// cores' ridge (~295), where both bounds are ~15 us. The TPU kernel's math
// is f32, and at the f32 CUDA-core rate (67 TFLOP/s) the same work takes
// 0.23 ms: this version does f32 FMAs from shared memory, so that ceiling and
// the shared-memory operand traffic limit it. Moving QK^T and PV to wgmma
// fed by TMA is the next step.
//
// Interface: plain C, loaded with ctypes. Strides are in elements; the last
// dimension of q, k and v must be contiguous. o is a contiguous
// (B, Sq, H, hd) tensor, lse a contiguous (B, H, Sq) f32 tensor; row_ptr and
// cols are the int32 tile lists on the card. The launch goes on the caller's
// stream; the return value is cudaGetLastError().

#include "block_sparse.cuh"

namespace {

using namespace bsa;

template <int HD, int TILE>
constexpr int fwd_smem_floats() {
  return 3 * TILE * (HD + 1) + TILE * Geom<TILE>::SP;
}

template <typename T, int HD, int TILE>
__global__ void __launch_bounds__(kThreads)
block_sparse_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                        const int* __restrict__ row_ptr, const int* __restrict__ cols, int H,
                        int Sq, int nq, Strides st, float sm_scale, int causal) {
  constexpr int P = HD + 1;
  constexpr int R = Geom<TILE>::R, C = Geom<TILE>::C, SP = Geom<TILE>::SP;
  constexpr int DT = HD / 8;
  extern __shared__ float smem[];
  float* Qs = smem;             // TILE x P
  float* Ks = Qs + TILE * P;    // TILE x P
  float* Vs = Ks + TILE * P;    // TILE x P
  float* Ps = Vs + TILE * P;    // TILE x SP

  const int tid = threadIdx.x;
  const int rg = tid >> 3;
  const int cg = tid & 7;
  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = qt * TILE;

  load_tile<T, HD, TILE>(Qs, q + b * st.q[0] + h * st.q[2], st.q[1], q0);
  const T* kb = k + b * st.k[0] + h * st.k[2];
  const T* vb = v + b * st.v[0] + h * st.v[2];

  float m[R], l[R], acc[R][DT];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DT; ++j) acc[i][j] = 0.f;
  }

  const int e_end = row_ptr[h * nq + qt + 1];
  for (int e = row_ptr[h * nq + qt]; e < e_end; ++e) {
    const int k0 = cols[e] * TILE;
    const bool diag = causal && k0 == q0;  // the one tile of the row that needs the mask
    __syncthreads();  // the previous tile's Ks / Vs / Ps reads are done (and Qs is loaded)
    load_tile<T, HD, TILE>(Ks, kb, st.k[1], k0);
    load_tile<T, HD, TILE>(Vs, vb, st.v[1], k0);
    __syncthreads();

    float sc[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) sc[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[R], kv[C];
#pragma unroll
      for (int i = 0; i < R; ++i) qv[i] = Qs[(rg * R + i) * P + d];
#pragma unroll
      for (int c = 0; c < C; ++c) kv[c] = Ks[(cg + 8 * c) * P + d];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) sc[i][c] = fmaf(qv[i], kv[c], sc[i][c]);
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = rg * R + i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float s = (diag && cg + 8 * c > r) ? kNegInf : sc[i][c] * sm_scale;
        sc[i][c] = s;
        mx = fmaxf(mx, s);
      }
      const float m_new = fmaxf(m[i], row_max8(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        // every row of a listed tile has a key it may see, so m_new is finite
        // and a masked score adds exp(-1e30 - m_new) = 0, as in the TPU kernel
        const float p = sc[i][c] == kNegInf ? 0.f : expf(sc[i][c] - m_new);
        rs += p;
        Ps[r * SP + cg + 8 * c] = p;
      }
      l[i] = l[i] * corr + row_sum8(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DT; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < TILE; ++kk) {
      float pv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) pv[i] = Ps[(rg * R + i) * SP + kk];
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const float vv = Vs[kk * P + cg + 8 * j];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qpos = q0 + rg * R + i;
    const float lc = fmaxf(l[i], 1e-20f);
    T* orow = o + ((static_cast<long long>(b) * Sq + qpos) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < DT; ++j) orow[cg + 8 * j] = from_f32<T>(acc[i][j] / lc);
    if (cg == 0) lse[static_cast<long long>(bh) * Sq + qpos] = m[i] + logf(lc);
  }
}

struct Args {
  const void *q, *k, *v;
  void *o, *lse;
  const int *row_ptr, *cols;
  int B, H, Sq, nq;
  Strides st;
  float sm_scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int HD, int TILE>
int launch(const Args& a) {
  constexpr int smem = fwd_smem_floats<HD, TILE>() * static_cast<int>(sizeof(float));
  // above 48 KB of shared memory a block needs the opt-in
  cudaError_t err = cudaFuncSetAttribute(block_sparse_fwd_kernel<T, HD, TILE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.nq, a.B * a.H);
  block_sparse_fwd_kernel<T, HD, TILE><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), static_cast<float*>(a.lse), a.row_ptr, a.cols, a.H, a.Sq, a.nq,
      a.st, a.sm_scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int dispatch_tile(int tile, const Args& a) {
  switch (tile) {
    case 16: return launch<T, HD, 16>(a);
    case 32: return launch<T, HD, 32>(a);
    case 64: return launch<T, HD, 64>(a);
    default: return -1;
  }
}

template <typename T>
int dispatch_hd(int hd, int tile, const Args& a) {
  switch (hd) {
    case 16: return dispatch_tile<T, 16>(tile, a);
    case 32: return dispatch_tile<T, 32>(tile, a);
    case 64: return dispatch_tile<T, 64>(tile, a);
    case 128: return dispatch_tile<T, 128>(tile, a);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16; tile: 16, 32 or 64 rows.
// strides: 9 values, the (batch, seq, head) strides of q, k and v in that
// order, in elements. row_ptr has H * nq + 1 entries. Returns
// cudaGetLastError() after the launch, or -1 for an unsupported dtype, head
// size or tile.
extern "C" int dstorch_block_sparse_fwd(int dtype, int hd, int tile, const void* q,
                                        const void* k, const void* v, void* o, void* lse,
                                        const void* row_ptr, const void* cols, int B, int H,
                                        int Sq, int nq, const long long* strides,
                                        float sm_scale, int causal, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse = lse;
  a.row_ptr = static_cast<const int*>(row_ptr);
  a.cols = static_cast<const int*>(cols);
  a.B = B; a.H = H; a.Sq = Sq; a.nq = nq;
  for (int i = 0; i < 3; ++i) {
    a.st.q[i] = strides[i];
    a.st.k[i] = strides[3 + i];
    a.st.v[i] = strides[6 + i];
    a.st.o[i] = 0;
  }
  a.sm_scale = sm_scale; a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_hd<float>(hd, tile, a);
    case 1: return dispatch_hd<__half>(hd, tile, a);
    case 2: return dispatch_hd<__nv_bfloat16>(hd, tile, a);
    default: return -1;
  }
}
