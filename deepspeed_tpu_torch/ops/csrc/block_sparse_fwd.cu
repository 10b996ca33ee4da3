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
// never rounded to the input dtype, the running max m, sum l and the
// accumulator stay in f32 (acc = acc * corr + p v, in that order), and o is
// rounded to the input dtype once, at the store (acc / max(l, 1e-20)).
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
// Two variants, chosen from (dtype, tile) alone, as
// block_sparse_attention.kernel_variant reports them (K5/K6 choose the same
// way); never a fallback: a launch that fails is an error and the caller
// raises.
//  - float16 / bfloat16 at tile 64 (layout blocks 64 and 128): the
//    tensor-core kernel block_sparse_fwd_kernel_wgmma;
//  - float32 (TF32 on the tensor cores), and tiles 16 and 32 (a wgmma needs
//    64 rows): the FMA kernel block_sparse_fwd_kernel.
// Both walk, per block, only the live tiles of one (head, query tile) row of
// the tile list, in ascending order, where the TPU grid walks all nk key
// tiles and tests layout[h, qi, ki] at each (:40). Nothing is carried
// between blocks: no atomics and no second pass, so two calls give the same
// bits.
//
// Tensor-core design (flash_sm90.cuh's pieces, as in K1-K3, and
// block_sparse.cuh's, as in K5/K6). One warpgroup (128 threads) per
// (64-row query tile, batch, head): block i takes the (head, tile) list
// order[i / B], the host's row_order (longest list first, so the longest rows
// start first), and batch row i % B. Q is loaded once by cp.async into
// 128-byte-swizzled panels; K and V tiles are double buffered over the list,
// the next tile in flight during this one's products. Per tile:
//  - S = Q K^T on K-major wgmma m64n64k16 (exact products, f32 sums); at head
//    dim 128 each 64-column panel is summed from zero and the two are added
//    in f32 (scores), as in K5/K6.
//  - The online softmax on the accumulator layout, as in K1: a thread holds 16
//    scores of each of rows r0 and r0 + 8, the 4 lanes of its quad the rest,
//    and each row max and row sum takes two shuffles. Scores are s * sm_scale
//    and p = exp(s - m_new), as the TPU kernel computes them; the causal mask
//    is applied in registers on the diagonal tile only, and a masked score
//    adds exactly 0.
//  - O += P V with p kept in f32: p is split into kParts 16-bit parts (three
//    in bfloat16; two in float16, p scaled by 2^14), packed from the
//    accumulator straight into the A fragments (split_rows) and multiplied by
//    V read MN-major from its one copy. Each tile's product is summed from
//    zero and added in f32 after the rescale (acc = acc * corr + t,
//    add_product), so the sum over the list is an f32 sum, as the plain
//    version's: a sum left to the tensor cores over a list truncates towards
//    zero (measured on K5/K6, PERF.md).
//  - The epilogue writes o = acc / max(l, 1e-20), rounded once, and lse in
//    the natural log.
// Tiles must have 16-byte aligned rows (the wrapper copies any that are not).
//
// FMA design (float32, tiles 16 and 32). One block of 128 threads per
// (TILE-row query tile, batch * head), in plain grid order; Q, K and V tiles
// are staged in shared memory as f32 and scores are f32 FMAs from shared
// memory; thread layout as in block_sparse.cuh.
//
// What bounds it on an H100. 4 * hd FLOPs per (query, key) pair that the
// layout and the causal mask let through, over q, k, v, o and lse each moved
// once. At the training shape (B2 S4096 H12 hd64 bf16, fixed layout, causal)
// that is 15.3 GFLOP over 51 MB, ~300 FLOPs per byte: at the bf16 tensor
// cores' ridge (~295), where both bounds are ~15 us. With p in three bf16
// parts the tensor cores do 2x that work (2 * hd a pair for S, 3 x 2 * hd for
// P V; 1.5x with two float16 parts), ~31 us at their peak. One warpgroup per
// block waits for each product before the softmax and the next product, so
// the kernel runs well under that peak. The FMA kernel is held by the f32
// CUDA cores: the same work takes 0.23 ms at 67 TFLOP/s.
//
// Interface: plain C, loaded with ctypes. Strides are in elements; the last
// dimension of q, k and v must be contiguous (for the tensor-core variant
// also 16-byte aligned rows: base addresses a multiple of 16 bytes, strides
// of 8 elements). o is a contiguous (B, Sq, H, hd) tensor, lse a contiguous
// (B, H, Sq) f32 tensor; row_ptr, cols and row_order are the int32 tile lists
// and launch order on the card. The launch goes on the caller's stream; the
// return value is cudaGetLastError().

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

template <int HD>
constexpr int fwd_wgmma_smem() {
  return 1024 + 5 * Tile<HD>::bytes;  // alignment slack, Q, 2 x (K, V)
}

// K4 (tensor cores, float16 / bfloat16, tile 64): o and lse for one 64-row
// query tile of one (batch, head): batch row blockIdx.x % B of the (head,
// tile) that order[blockIdx.x / B] names. Up to head dim 64 the launch bound
// holds a thread to 128 registers (without spilling), so that four blocks
// share an SM instead of three: one warpgroup waits on each product, and a
// fourth block hides more of those waits.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 4 : 1)
block_sparse_fwd_kernel_wgmma(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, T* __restrict__ o,
                              float* __restrict__ lse, const int* __restrict__ row_ptr,
                              const int* __restrict__ cols, const int* __restrict__ order, int B,
                              int H, int Sq, int Sk, int nq, Strides st, float sm_scale,
                              int causal) {
  constexpr int NP = Tile<HD>::panels;
  constexpr int TB = Tile<HD>::bytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sKV = sQ + TB;  // buffer i: K at sKV + 2 i TB, V after it

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
  const int e0 = row_ptr[h * nq + qt];
  const int n = row_ptr[h * nq + qt + 1] - e0;
  if (n > 0) {
    load_tile_async<T, HD>(sKV, kb, st.k[1], cols[e0] * kBlock, Sk);
    load_tile_async<T, HD>(sKV + TB, vb, st.v[1], cols[e0] * kBlock, Sk);
  }
  cp_async_commit();

  // rows r0, r0 + 8: the running max of the scaled scores and sum of p
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[NP][32], s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = 0.f;
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
    cp_async_wait<1>();  // all but the prefetch: Q and this tile are here
    fence_async_smem();
    __syncthreads();

    scores<T, HD>(s, sQ, sK);  // S = Q K^T

    // scaled scores, masked ones -1e30 (the diagonal tile under causal
    // only); each row's new max and the factor that carries the old sums
    // over to it
    const bool diag = causal && k0 == q0;
    float corr[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int i = 4 * j + 2 * e + t;
          s[i] = (diag && 8 * j + c0 + t > r0 + 8 * e) ? kNegInf : s[i] * sm_scale;
          mx = fmaxf(mx, s[i]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));  // the row's quad
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // every row of a listed tile has a key it may see, so m_new is finite
      const float m_new = fmaxf(m[e], mx);
      corr[e] = expf(m[e] - m_new);
      m[e] = m_new;
    }

    // p = exp(s - m) in f32 (a masked score adds exactly 0, as the TPU
    // kernel's exp(-1e30 - m)); the row sums; p (times p_scale) in place of
    // s, whose parts are the A fragments of P V
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int e = (i >> 1) & 1;
      const float p = s[i] == kNegInf ? 0.f : expf(s[i] - m[e]);
      rs[e] += p;
      s[i] = p * p_scale<T>();
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      rs[e] += __shfl_xor_sync(0xffffffffu, rs[e], 1);
      rs[e] += __shfl_xor_sync(0xffffffffu, rs[e], 2);
      l[e] = l[e] * corr[e] + rs[e];
    }
    // acc = acc * corr + (this tile's P V, summed from zero), in f32
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] *= corr[(i >> 1) & 1];
    uint32_t pa[kParts<T>][4][4];
    split_rows<T>(s, pa);
    add_product<T, NP>(acc, pa, sK + TB);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qpos = q0 + r0 + 8 * e;
    const float lc = fmaxf(l[e], 1e-20f);
    const float den = lc * p_scale<T>();  // exact: p_scale is a power of two
    T* row = o + ((static_cast<long long>(b) * Sq + qpos) * H + h) * HD;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = p * kPanel + 8 * j + c0;
        if (col < HD)
          *reinterpret_cast<uint32_t*>(row + col) =
              pack2<T>(acc[p][4 * j + 2 * e] / den, acc[p][4 * j + 2 * e + 1] / den);
      }
    if ((tid & 3) == 0) lse[static_cast<long long>(bh) * Sq + qpos] = m[e] + logf(lc);
  }
}

struct Args {
  const void *q, *k, *v;
  void *o, *lse;
  const int *row_ptr, *cols;
  const int* order;  // the tensor-core kernel's launch order of (head, tile)
  int B, H, Sq, Sk, nq;
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
int launch_wgmma(const Args& a) {
  constexpr int smem = fwd_wgmma_smem<HD>();
  cudaError_t err = cudaFuncSetAttribute(block_sparse_fwd_kernel_wgmma<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  block_sparse_fwd_kernel_wgmma<T, HD><<<a.B * a.H * a.nq, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), static_cast<float*>(a.lse), a.row_ptr, a.cols, a.order, a.B, a.H,
      a.Sq, a.Sk, a.nq, a.st, a.sm_scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

// the variant by (dtype, tile), as block_sparse_attention.kernel_variant:
// the tensor-core kernel for 16-bit inputs at tile 64, the FMA kernel for
// float32 and for tiles 16 and 32
template <typename T, int HD>
int dispatch_tile(int tile, const Args& a) {
  switch (tile) {
    case 16: return launch<T, HD, 16>(a);
    case 32: return launch<T, HD, 32>(a);
    case 64:
      if constexpr (std::is_same<T, float>::value)
        return launch<T, HD, 64>(a);
      else
        return launch_wgmma<T, HD>(a);
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
// order, in elements. row_ptr has H * nq + 1 entries; row_order, the launch
// order of the (head, tile) lists (H * nq entries h * nq + tile), is read by
// the tensor-core kernel alone. Returns cudaGetLastError() after the launch,
// or -1 for an unsupported dtype, head size or tile.
extern "C" int dstorch_block_sparse_fwd(int dtype, int hd, int tile, const void* q,
                                        const void* k, const void* v, void* o, void* lse,
                                        const void* row_ptr, const void* cols,
                                        const void* row_order, int B, int H, int Sq, int Sk,
                                        int nq, const long long* strides, float sm_scale,
                                        int causal, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse = lse;
  a.row_ptr = static_cast<const int*>(row_ptr);
  a.cols = static_cast<const int*>(cols);
  a.order = static_cast<const int*>(row_order);
  a.B = B; a.H = H; a.Sq = Sq; a.Sk = Sk; a.nq = nq;
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
