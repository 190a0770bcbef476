// Ring-attention chunk kernels: fold one K/V chunk into the carried
// online-softmax state (K6), and the per-hop backward partials dq (K7a) and
// dk, dv (K7b), with the chunk's global position given at run time.
//
// Replaces: distributed_tensorflow_tpu/ops/pallas/flash_attention.py,
// _chunk_kernel (K6, launched by flash_attention_chunk), _chunk_dq_kernel
// (K7a) and _chunk_dkv_kernel (K7b), both launched by _chunk_bwd_call.
// There the TPU walks the streamed blocks as the last, sequential grid axis
// and carries (m, l, acc) or the fp32 gradient sums in VMEM scratch, and
// the two offsets arrive by scalar prefetch.  Hopper blocks run in parallel
// and in no order, so here one thread block owns one 64-row tile and loops
// over the streamed tiles itself, as the K1/K2 kernels do
// (flash_attention.cu, flash_attention_bwd.cu):
//   K6:  a block per (batch*head, Q tile) reads the incoming (m, l, acc)
//        rows of its tile, folds in the K/V tiles its rows can see and
//        writes the updated rows (no division: the ring finalises);
//   K7a: a block per (batch*head, Q tile) walks the K tiles it can see and
//        writes the fp32 dq partial of its rows;
//   K7b: a block per (batch*head, K tile) walks the Q tiles that can see it
//        and writes the fp32 dk, dv partials of its rows.
// Causal and window masks use the global positions q_off + i and k_off + j;
// the offsets are plain int arguments, so one compiled kernel serves every
// hop.  A tile is visited only when some pair in it can be valid (the guard
// of _chunk_tile_guard with the offsets folded in); a chunk wholly in the
// future visits no tile, and its block still writes its outputs: K6 the
// incoming carries unchanged, K7 zeros (the wrapper's outputs come from
// torch.empty).  delta = rowsum(dO * out) is an input: the ring computes it
// once per step from the finished output, as the JAX ring does.
//
// Bound on the H100: at the ring path's per-hop shape (q, k, v
// [8, 256, 16, 128] bf16, 128 heads of 256 x 256 pairs) a hop is ~1 GFLOP
// per product for a visible chunk, while K6 moves the fp32 carries in and
// out (~34 MB of its ~46 MB): K6 is bound by bytes, K7a/K7b by bytes for a
// visible chunk too (their fp32 outputs); both spend their time far above
// the bound in this simple form.  A chunk wholly in the future costs only
// the carries' copy (K6) or the zero fill (K7).
//
// Design, simple first: the K1/K2 designs with two counts of rows (Sq, Sk)
// instead of one.  Four warps per block, each owning 16 rows of the tile;
// S = Q K^T, P V, dP, dQ, dK and dV on the tensor cores through WMMA bf16
// fragments with fp32 accumulation (fp32 inputs take a scalar FMA path at
// full precision); P and dS rounded to bf16 as tensor-core operands, as in
// K1/K2.  The scale multiplies the fp32 scores after the product (the
// Pallas kernel scales q in fp32 before it): a difference of rounding only.
// q, k, v and dO are read through their [B, S, H, D] strides (views of the
// global tensor's shard); the carries, lse, delta and every output are
// contiguous [B, H, S(, D)] fp32.  wgmma, TMA, and a ring that accumulates
// dq in place across hops are left for later work.
//
// Masked scores are -1e30 and masked probabilities exactly 0 (never
// exp(0) = 1 for a row whose keys so far are all masked): a row with no
// valid key keeps m = -1e30, l = 0, acc = 0, and in the backward (lse ~
// -1e30) gets exact zero gradients, never inf * 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BT = 64;         // rows of a tile, own or streamed
constexpr int kWarps = 4;      // 16 rows each
constexpr int kThreads = kWarps * 32;
constexpr float kNeg = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;     // K7 only
  const int* kv_mask;   // [B, Sk] int32, nonzero = attend; may be null
  const float* m_in;    // K6: [B*H, Sq]
  const float* l_in;    // K6: [B*H, Sq]
  const float* acc_in;  // K6: [B*H, Sq, D]
  const float* lse;     // K7: [B*H, Sq]
  const float* delta;   // K7: [B*H, Sq]
  float* out_a;         // K6: m; K7a: dq [B*H, Sq, D]; K7b: dk [B*H, Sk, D]
  float* out_b;         // K6: l; K7b: dv
  float* out_c;         // K6: acc
  int B, Sq, Sk, H;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh;
  int q_off, k_off, causal, window;
  float scale;
};

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// Shared-memory geometry.  bf16 rows are padded by 8 elements (16 bytes)
// so WMMA fragment pointers stay 32-byte aligned and rows fall on other
// banks; fp32 rows by one element (operand tiles) or four (score tiles).
template <typename T, int D> struct Geo {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int LD = D + (kBf16 ? 8 : 1);      // operand tiles
  static constexpr int LDS = BT + 4;                  // fp32 scores
  static constexpr int LDP = BT + (kBf16 ? 8 : 4);    // P and dS (type T)
  static constexpr int LDO = D + 4;                   // K6's fp32 acc
  static constexpr size_t kTile = sizeof(T) * (size_t)BT * LD;
  static constexpr size_t kS = sizeof(float) * (size_t)BT * LDS;
  static constexpr size_t kP = sizeof(T) * (size_t)BT * LDP;
  static constexpr size_t kO = sizeof(float) * (size_t)BT * LDO;
  // K6: Q, K, V, scores, P, acc, m, l, key validity.
  static constexpr size_t kFwdBytes =
      3 * kTile + kS + kP + kO + 2 * sizeof(float) * BT + sizeof(int) * BT;
  // K7: two own and two streamed tiles, P, dS, the fp32 S / dP scratch
  // (aliasing dS in the fp32 path), lse/delta of both tiles, validity.
  static constexpr size_t kSc = kBf16 ? kS : 0;
  static constexpr size_t kInfo = (4 * sizeof(float) + 2 * sizeof(int)) * BT;
  static constexpr size_t kBwdBytes = 4 * kTile + 2 * kP + kSc + kInfo;
};

// Rows [row0, row0 + 64) of one head into shared memory, 16 bytes per
// load; rows at or past S read as zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* base,
                                          long long row_stride, int row0,
                                          int S) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kChunks = D / V;
  constexpr int LD = Geo<T, D>::LD;
  for (int c = threadIdx.x; c < BT * kChunks; c += kThreads) {
    const int r = c / kChunks, d = (c % kChunks) * V;
    const int s = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S)
      val = *reinterpret_cast<const uint4*>(base + s * row_stride + d);
    const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
    for (int i = 0; i < V; ++i) dst[r * LD + d + i] = e[i];
  }
}

// Causal and sliding-window validity of one (query, key) pair in global
// positions (the padding mask is tested apart).
__device__ __forceinline__ bool pair_valid(int causal, int window, int qpos,
                                           int kpos) {
  if (!causal) return true;
  return qpos >= kpos && (window <= 0 || qpos - kpos < window);
}

// ---- C[16 x 64] = A[16 x D] . B[64 x D]^T for one warp's rows -----------

template <int D>
__device__ __forceinline__ void mm_nt(const bf16* A, const bf16* Bm, float* C,
                                      int /*lane*/) {
  using G = Geo<bf16, D>;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
#pragma unroll
  for (int n = 0; n < BT / 16; ++n) {
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::load_matrix_sync(a, A + kk * 16, G::LD);
      // B^T(k, n) = B[n][k]: column-major with leading dimension LD.
      wmma::load_matrix_sync(b, Bm + (n * 16) * G::LD + kk * 16, G::LD);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(C + n * 16, acc, G::LDS, wmma::mem_row_major);
  }
}

template <int D>
__device__ __forceinline__ void mm_nt(const float* A, const float* Bm,
                                      float* C, int lane) {
  using G = Geo<float, D>;
  float c0[16], c1[16];
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) c0[rr] = c1[rr] = 0.f;
  for (int d = 0; d < D; ++d) {
    const float b0 = Bm[lane * G::LD + d];
    const float b1 = Bm[(lane + 32) * G::LD + d];
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const float a = A[rr * G::LD + d];
      c0[rr] = fmaf(a, b0, c0[rr]);
      c1[rr] = fmaf(a, b1, c1[rr]);
    }
  }
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    C[rr * G::LDS + lane] = c0[rr];
    C[rr * G::LDS + lane + 32] = c1[rr];
  }
}

// ---- K6's O += P V for one warp's 16 rows (acc in shared memory) ----------

template <int D>
__device__ __forceinline__ void pv(const bf16* Ps, const bf16* Vs, float* Os,
                                   int warp, int /*lane*/) {
  using G = Geo<bf16, D>;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
      pa[BT / 16];
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk)
    wmma::load_matrix_sync(pa[kk], Ps + (warp * 16) * G::LDP + kk * 16,
                           G::LDP);
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    float* o = Os + (warp * 16) * G::LDO + n * 16;
    wmma::load_matrix_sync(acc, o, G::LDO, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      wmma::load_matrix_sync(vb, Vs + (kk * 16) * G::LD + n * 16, G::LD);
      wmma::mma_sync(acc, pa[kk], vb, acc);
    }
    wmma::store_matrix_sync(o, acc, G::LDO, wmma::mem_row_major);
  }
}

template <int D>
__device__ __forceinline__ void pv(const float* Ps, const float* Vs,
                                   float* Os, int warp, int lane) {
  using G = Geo<float, D>;
  constexpr int J = D / 32;
  float acc[16][J];
#pragma unroll
  for (int rr = 0; rr < 16; ++rr)
#pragma unroll
    for (int j = 0; j < J; ++j)
      acc[rr][j] = Os[(warp * 16 + rr) * G::LDO + lane + 32 * j];
  for (int kk = 0; kk < BT; ++kk) {
    float vv[J];
#pragma unroll
    for (int j = 0; j < J; ++j) vv[j] = Vs[kk * G::LD + lane + 32 * j];
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const float pp = Ps[(warp * 16 + rr) * G::LDP + kk];
#pragma unroll
      for (int j = 0; j < J; ++j) acc[rr][j] = fmaf(pp, vv[j], acc[rr][j]);
    }
  }
#pragma unroll
  for (int rr = 0; rr < 16; ++rr)
#pragma unroll
    for (int j = 0; j < J; ++j)
      Os[(warp * 16 + rr) * G::LDO + lane + 32 * j] = acc[rr][j];
}

// ---- K6 -------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) chunk_fwd_kernel(Params p) {
  using G = Geo<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = reinterpret_cast<T*>(smem + G::kTile);
  T* Vs = reinterpret_cast<T*>(smem + 2 * G::kTile);
  float* Ss = reinterpret_cast<float*>(smem + 3 * G::kTile);
  T* Ps = reinterpret_cast<T*>(smem + 3 * G::kTile + G::kS);
  float* Os = reinterpret_cast<float*>(smem + 3 * G::kTile + G::kS + G::kP);
  float* m_s = Os + BT * G::LDO;
  float* l_s = m_s + BT;
  int* mask_s = reinterpret_cast<int*>(l_s + BT);

  const int Sq = p.Sq, Sk = p.Sk, H = p.H;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row0 = (long long)bh * Sq;     // carry row base
  const T* qb = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* kb = static_cast<const T*>(p.k) + b * p.ksb + h * p.ksh;
  const T* vb = static_cast<const T*>(p.v) + b * p.vsb + h * p.vsh;

  // Seed from the incoming state (not neutral values): the chunk continues
  // an online softmax already in flight.  Rows past Sq stay neutral.
  load_tile<T, D>(Qs, qb, p.qss, q0, Sq);
  for (int i = tid; i < BT * D; i += kThreads) {
    const int r = i / D, d = i % D;
    Os[r * G::LDO + d] =
        q0 + r < Sq ? p.acc_in[(row0 + q0 + r) * D + d] : 0.f;
  }
  for (int i = tid; i < BT; i += kThreads) {
    const bool in = q0 + i < Sq;
    m_s[i] = in ? p.m_in[row0 + q0 + i] : kNeg;
    l_s[i] = in ? p.l_in[row0 + q0 + i] : 0.f;
  }
  __syncthreads();

  // K tiles that can hold a valid key for some row of this Q tile, with the
  // chunk's global offsets: key k_off + j is visible to query q_off + i iff
  // k_off + j <= q_off + i (and, with a window, q_off + i - window <
  // k_off + j).
  const int q_last = min(Sq - 1, q0 + BT - 1);
  const int n_kt = (Sk + BT - 1) / BT;
  int kt_begin = 0, kt_end = n_kt;
  if (p.causal) {
    const int hi = p.q_off + q_last - p.k_off;      // newest visible key
    kt_end = hi < 0 ? 0 : min(n_kt, hi / BT + 1);
    if (p.window > 0) {
      const int lo = p.q_off + q0 - p.window + 1 - p.k_off;  // oldest
      if (lo > 0) kt_begin = lo / BT;
    }
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();   // every warp is done with the previous K/V tile
    load_tile<T, D>(Ks, kb, p.kss, k0, Sk);
    load_tile<T, D>(Vs, vb, p.vss, k0, Sk);
    if (tid < BT) {
      const int s = k0 + tid;
      mask_s[tid] =
          s < Sk && (p.kv_mask == nullptr || p.kv_mask[b * Sk + s]);
    }
    __syncthreads();

    mm_nt<D>(Qs + (warp * 16) * G::LD, Ks, Ss + (warp * 16) * G::LDS, lane);
    __syncwarp();

    // Online softmax: lanes 2i and 2i + 1 of warp w own row 16w + i, 32 of
    // the tile's 64 columns each; the row reductions run in registers with
    // one shuffle between the pair.
    {
      const int r = warp * 16 + (lane >> 1);
      const int half = lane & 1;
      const int qpos = p.q_off + q0 + r;
      float sv[32];
      unsigned ok = 0u;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = half * 32 + ((j + lane) & 31);
        const bool valid = mask_s[c] != 0 &&
                           pair_valid(p.causal, p.window, qpos,
                                      p.k_off + k0 + c);
        ok |= (unsigned)valid << j;
        sv[j] = valid ? Ss[r * G::LDS + c] * p.scale : kNeg;
        mx = fmaxf(mx, sv[j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        // The validity test, not underflow, zeroes masked entries: with
        // m_new still at -1e30, exp(sv - m_new) would be exp(0) = 1.
        const float pr = (ok >> j) & 1u ? expf(sv[j] - m_new) : 0.f;
        sum += pr;
        Ps[r * G::LDP + half * 32 + ((j + lane) & 31)] = from_f<T>(pr);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float corr = expf(m_prev - m_new);
      __syncwarp();   // both lanes of the row have read m_s[r]
      if (half == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
      }
      float* o = Os + r * G::LDO + half * (D / 2);
#pragma unroll 8
      for (int i = 0; i < D / 2; ++i) o[(i + lane) & (D / 2 - 1)] *= corr;
    }
    __syncwarp();

    pv<D>(Ps, Vs, Os, warp, lane);
  }
  __syncthreads();

  // The updated state, written whether or not a tile was visited.
  for (int i = tid; i < BT * D; i += kThreads) {
    const int r = i / D, d = i % D;
    if (q0 + r < Sq) p.out_c[(row0 + q0 + r) * D + d] = Os[r * G::LDO + d];
  }
  for (int i = tid; i < BT; i += kThreads) {
    if (q0 + i < Sq) {
      p.out_a[row0 + q0 + i] = m_s[i];
      p.out_b[row0 + q0 + i] = l_s[i];
    }
  }
}

// ---- K7: a warp's 16 x D fp32 accumulator, acc += A[16 x 64] . B[64 x D] --

template <typename T, int D> struct Acc;

template <int D> struct Acc<bf16, D> {
  using G = Geo<bf16, D>;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[D / 16];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(f[n], 0.f);
  }

  __device__ __forceinline__ void mma(const bf16* A, const bf16* Bm,
                                      int /*lane*/) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      wmma::load_matrix_sync(a, A + kk * 16, G::LDP);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        wmma::load_matrix_sync(b, Bm + (kk * 16) * G::LD + n * 16, G::LD);
        wmma::mma_sync(f[n], a, b, f[n]);
      }
    }
  }

  // scale * acc -> fp32 rows [pos0, pos0 + 16) of out (row pitch D), staged
  // through the warp's fp32 scratch 64 columns at a time.
  __device__ __forceinline__ void store(float* stage, float* out, int pos0,
                                        int S, float scale, int lane) {
#pragma unroll
    for (int c0 = 0; c0 < D; c0 += BT) {
#pragma unroll
      for (int n = 0; n < BT / 16; ++n)
        wmma::store_matrix_sync(stage + n * 16, f[c0 / 16 + n], G::LDS,
                                wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 16 * BT; e += 32) {
        const int r = e / BT, c = e % BT;
        if (pos0 + r < S)
          out[(long long)(pos0 + r) * D + c0 + c] =
              stage[r * G::LDS + c] * scale;
      }
      __syncwarp();
    }
  }
};

template <int D> struct Acc<float, D> {
  using G = Geo<float, D>;
  static constexpr int J = D / 32;   // lane owns columns lane + 32 j
  float f[16][J];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int rr = 0; rr < 16; ++rr)
#pragma unroll
      for (int j = 0; j < J; ++j) f[rr][j] = 0.f;
  }

  __device__ __forceinline__ void mma(const float* A, const float* Bm,
                                      int lane) {
    for (int kk = 0; kk < BT; ++kk) {
      float bv[J];
#pragma unroll
      for (int j = 0; j < J; ++j) bv[j] = Bm[kk * G::LD + lane + 32 * j];
#pragma unroll
      for (int rr = 0; rr < 16; ++rr) {
        const float a = A[rr * G::LDP + kk];
#pragma unroll
        for (int j = 0; j < J; ++j) f[rr][j] = fmaf(a, bv[j], f[rr][j]);
      }
    }
  }

  __device__ __forceinline__ void store(float* /*stage*/, float* out,
                                        int pos0, int S, float scale,
                                        int lane) {
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      if (pos0 + rr >= S) break;
#pragma unroll
      for (int j = 0; j < J; ++j)
        out[(long long)(pos0 + rr) * D + lane + 32 * j] = f[rr][j] * scale;
    }
  }
};

// ---- K7 -------------------------------------------------------------------
// kDKV = true: K7b (own tile = keys, streamed = queries) -> dk, dv.
// kDKV = false: K7a (own tile = queries, streamed = keys) -> dq.

template <typename T, int D, bool kDKV>
__global__ void __launch_bounds__(kThreads) chunk_bwd_kernel(Params p) {
  using G = Geo<T, D>;
  constexpr bool kBf16 = G::kBf16;
  extern __shared__ __align__(128) unsigned char smem[];
  T* own1 = reinterpret_cast<T*>(smem);
  T* own2 = reinterpret_cast<T*>(smem + G::kTile);
  T* str1 = reinterpret_cast<T*>(smem + 2 * G::kTile);
  T* str2 = reinterpret_cast<T*>(smem + 3 * G::kTile);
  T* Ps = reinterpret_cast<T*>(smem + 4 * G::kTile);
  T* dSs = reinterpret_cast<T*>(smem + 4 * G::kTile + G::kP);
  float* Sc = kBf16 ? reinterpret_cast<float*>(smem + 4 * G::kTile +
                                               2 * G::kP)
                    : reinterpret_cast<float*>(dSs);
  float* own_lse = reinterpret_cast<float*>(smem + 4 * G::kTile +
                                            2 * G::kP + G::kSc);
  float* own_delta = own_lse + BT;
  float* str_lse = own_delta + BT;
  float* str_delta = str_lse + BT;
  int* own_ok = reinterpret_cast<int*>(str_delta + BT);
  int* str_ok = own_ok + BT;

  const int Sq = p.Sq, Sk = p.Sk, H = p.H;
  const int S_own = kDKV ? Sk : Sq, S_str = kDKV ? Sq : Sk;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int own0 = blockIdx.x * BT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long qrow0 = (long long)bh * Sq;   // lse / delta row base
  const T* qb = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* kb = static_cast<const T*>(p.k) + b * p.ksb + h * p.ksh;
  const T* vb = static_cast<const T*>(p.v) + b * p.vsb + h * p.vsh;
  const T* db = static_cast<const T*>(p.dout) + b * p.dsb + h * p.dsh;

  if (kDKV) {
    load_tile<T, D>(own1, kb, p.kss, own0, Sk);
    load_tile<T, D>(own2, vb, p.vss, own0, Sk);
  } else {
    load_tile<T, D>(own1, qb, p.qss, own0, Sq);
    load_tile<T, D>(own2, db, p.dss, own0, Sq);
  }
  for (int i = tid; i < BT; i += kThreads) {
    const int pos = own0 + i;
    const bool in = pos < S_own;
    if (kDKV) {
      own_ok[i] = in && (p.kv_mask == nullptr || p.kv_mask[b * Sk + pos]);
    } else {
      own_ok[i] = in;
      own_lse[i] = in ? p.lse[qrow0 + pos] : 0.f;
      own_delta[i] = in ? p.delta[qrow0 + pos] : 0.f;
    }
  }
  __syncthreads();

  // Streamed tiles that can hold a valid pair for some own row, in global
  // positions (query q_off + i sees key k_off + j iff k_off + j <= q_off + i
  // and, with a window, q_off + i - (k_off + j) < window).
  const int own_last = min(S_own - 1, own0 + BT - 1);
  const int n_tiles = (S_str + BT - 1) / BT;
  int st_begin = 0, st_end = n_tiles;
  if (p.causal) {
    if (kDKV) {
      const int lo = p.k_off + own0 - p.q_off;   // oldest query that sees
      if (lo > 0) st_begin = lo / BT;
      if (p.window > 0) {
        const int hi = p.k_off + own_last + p.window - 1 - p.q_off;
        st_end = hi < 0 ? 0 : min(n_tiles, hi / BT + 1);
      }
    } else {
      const int hi = p.q_off + own_last - p.k_off;   // newest visible key
      st_end = hi < 0 ? 0 : min(n_tiles, hi / BT + 1);
      if (p.window > 0) {
        const int lo = p.q_off + own0 - p.window + 1 - p.k_off;
        if (lo > 0) st_begin = lo / BT;
      }
    }
  }

  Acc<T, D> acc_a, acc_b;   // dq | dk, and dv
  acc_a.zero();
  if (kDKV) acc_b.zero();

  const T* own1_w = own1 + (warp * 16) * G::LD;
  const T* own2_w = own2 + (warp * 16) * G::LD;
  T* P_w = Ps + (warp * 16) * G::LDP;
  T* dS_w = dSs + (warp * 16) * G::LDP;
  float* Sc_w = Sc + (warp * 16) * G::LDS;

  for (int st = st_begin; st < st_end; ++st) {
    const int str0 = st * BT;
    __syncthreads();   // every warp is done with the previous streamed tile
    if (kDKV) {
      load_tile<T, D>(str1, qb, p.qss, str0, Sq);
      load_tile<T, D>(str2, db, p.dss, str0, Sq);
    } else {
      load_tile<T, D>(str1, kb, p.kss, str0, Sk);
      load_tile<T, D>(str2, vb, p.vss, str0, Sk);
    }
    if (tid < BT) {
      const int pos = str0 + tid;
      const bool in = pos < S_str;
      if (kDKV) {
        str_ok[tid] = in;
        str_lse[tid] = in ? p.lse[qrow0 + pos] : 0.f;
        str_delta[tid] = in ? p.delta[qrow0 + pos] : 0.f;
      } else {
        str_ok[tid] =
            in && (p.kv_mask == nullptr || p.kv_mask[b * Sk + pos]);
      }
    }
    __syncthreads();

    // S slice, then P = exp(scale S - lse) on valid pairs (exactly 0
    // elsewhere, without evaluating exp).  Lane handles columns lane and
    // lane + 32 of every row of the slice.
    mm_nt<D>(own1_w, str1, Sc_w, lane);
    __syncwarp();
    float pr[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = i >> 1, c = (i & 1) * 32 + lane;
      const int orow = warp * 16 + r;
      const int opos = own0 + orow, spos = str0 + c;
      const int qpos = p.q_off + (kDKV ? spos : opos);
      const int kpos = p.k_off + (kDKV ? opos : spos);
      const bool valid = own_ok[orow] && str_ok[c] &&
                         pair_valid(p.causal, p.window, qpos, kpos);
      const float lse = kDKV ? str_lse[c] : own_lse[orow];
      const float pv =
          valid ? expf(Sc_w[r * G::LDS + c] * p.scale - lse) : 0.f;
      pr[i] = pv;
      P_w[r * G::LDP + c] = from_f<T>(pv);
    }
    __syncwarp();

    // dP slice, then dS = P (dP - delta).
    mm_nt<D>(own2_w, str2, Sc_w, lane);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = i >> 1, c = (i & 1) * 32 + lane;
      const float dl = kDKV ? str_delta[c] : own_delta[warp * 16 + r];
      dS_w[r * G::LDP + c] = from_f<T>(pr[i] * (Sc_w[r * G::LDS + c] - dl));
    }
    __syncwarp();

    acc_a.mma(dS_w, str1, lane);            // dq += dS K  |  dk += dS^T Q
    if (kDKV) acc_b.mma(P_w, str2, lane);   // dv += P^T dO
  }

  // dq = scale dS K and dk = dS^T (scale q): the scale folds in here.
  const int pos0 = own0 + warp * 16;
  float* out_a = p.out_a + (long long)bh * S_own * D;
  acc_a.store(Sc_w, out_a, pos0, S_own, p.scale, lane);
  if (kDKV) {
    float* out_b = p.out_b + (long long)bh * S_own * D;
    acc_b.store(Sc_w, out_b, pos0, S_own, 1.f, lane);
  }
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem, bool& configured) {
  if (configured) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) configured = true;
  return e;
}

template <typename T, int D>
cudaError_t launch_fwd(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Geo<T, D>::kFwdBytes;
  static bool configured = false;
  const cudaError_t e = opt_in(chunk_fwd_kernel<T, D>, smem, configured);
  if (e != cudaSuccess) return e;
  dim3 grid((p.Sq + BT - 1) / BT, p.B * p.H);
  chunk_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D, bool kDKV>
cudaError_t launch_bwd(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Geo<T, D>::kBwdBytes;
  static bool configured = false;
  const cudaError_t e =
      opt_in(chunk_bwd_kernel<T, D, kDKV>, smem, configured);
  if (e != cudaSuccess) return e;
  dim3 grid(((kDKV ? p.Sk : p.Sq) + BT - 1) / BT, p.B * p.H);
  chunk_bwd_kernel<T, D, kDKV><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// kind: 0 = K6, 1 = K7a, 2 = K7b.
int dispatch(const Params& p, int kind, int D, int dtype, cudaStream_t s) {
#define DTT_CHUNK_CASE(T, DD)                                       \
  if (D == DD) {                                                    \
    if (kind == 0) return (int)launch_fwd<T, DD>(p, s);             \
    if (kind == 1) return (int)launch_bwd<T, DD, false>(p, s);      \
    if (kind == 2) return (int)launch_bwd<T, DD, true>(p, s);       \
  }
  if (dtype == 1) {
    DTT_CHUNK_CASE(bf16, 128)
    DTT_CHUNK_CASE(bf16, 64)
  } else if (dtype == 0) {
    DTT_CHUNK_CASE(float, 128)
    DTT_CHUNK_CASE(float, 64)
  }
#undef DTT_CHUNK_CASE
  return (int)cudaErrorInvalidValue;
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* kv_mask, int B, int Sq, int Sk, int H,
                   const long long* st, int q_off, int k_off, int causal,
                   int window, float scale) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.kv_mask = static_cast<const int*>(kv_mask);
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.qsb = st[0]; p.qss = st[1]; p.qsh = st[2];
  p.ksb = st[3]; p.kss = st[4]; p.ksh = st[5];
  p.vsb = st[6]; p.vss = st[7]; p.vsh = st[8];
  p.dsb = st[9]; p.dss = st[10]; p.dsh = st[11];
  p.q_off = q_off;
  p.k_off = k_off;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  return p;
}

}  // namespace

// K6.  q [B, Sq, H, D], k, v [B, Sk, H, D] (strides in elements; last dim
// contiguous, rows 16-byte aligned), kv_mask int32 [B, Sk] or null;
// m_in, l_in [B*H, Sq] and acc_in [B*H, Sq, D] fp32 contiguous; writes
// m_out, l_out, acc_out of the same shapes (distinct buffers).  dtype:
// 0 = fp32, 1 = bf16; D in {64, 128}.  Returns cudaGetLastError().
extern "C" int dtt_flash_attention_chunk(
    const void* q, const void* k, const void* v, const void* kv_mask,
    const void* m_in, const void* l_in, const void* acc_in, void* m_out,
    void* l_out, void* acc_out, int B, int Sq, int Sk, int H, int D,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, int q_off,
    int k_off, int causal, int window, float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return (int)cudaSuccess;
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, 0,   0,   0};
  Params p = make_params(q, k, v, kv_mask, B, Sq, Sk, H, st, q_off, k_off,
                         causal, window, scale);
  p.m_in = static_cast<const float*>(m_in);
  p.l_in = static_cast<const float*>(l_in);
  p.acc_in = static_cast<const float*>(acc_in);
  p.out_a = static_cast<float*>(m_out);
  p.out_b = static_cast<float*>(l_out);
  p.out_c = static_cast<float*>(acc_out);
  return dispatch(p, 0, D, dtype, static_cast<cudaStream_t>(stream));
}

// K7a (dkv = 0) and K7b (dkv = 1).  q, dout [B, Sq, H, D] and k, v
// [B, Sk, H, D] (strides in elements, as K6), kv_mask int32 [B, Sk] or
// null, lse and delta fp32 [B*H, Sq].  K7a writes out_a = dq fp32
// [B*H, Sq, D]; K7b writes out_a = dk and out_b = dv fp32 [B*H, Sk, D].
// Returns cudaGetLastError().
extern "C" int dtt_flash_attention_chunk_bwd(
    const void* q, const void* k, const void* v, const void* kv_mask,
    const void* dout, const void* lse, const void* delta, void* out_a,
    void* out_b, int B, int Sq, int Sk, int H, int D, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long dsb, long long dss,
    long long dsh, int q_off, int k_off, int causal, int window, float scale,
    int dtype, int dkv, void* stream) {
  // An empty chunk (Sk = 0) still gets its dq partial written: zeros.
  if (B <= 0 || H <= 0 || (dkv ? Sk : Sq) <= 0) return (int)cudaSuccess;
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, dsb, dss, dsh};
  Params p = make_params(q, k, v, kv_mask, B, Sq, Sk, H, st, q_off, k_off,
                         causal, window, scale);
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out_a = static_cast<float*>(out_a);
  p.out_b = static_cast<float*>(out_b);
  return dispatch(p, dkv ? 2 : 1, D, dtype,
                  static_cast<cudaStream_t>(stream));
}
