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
// and in no order, so here one thread block owns one Q (or K) tile and
// loops over the streamed tiles itself, as K1/K2 do:
//   K6:  a block per (batch*head, Q tile) takes the incoming (m, l, acc)
//        rows of its tile, folds in the K/V tiles its rows can see and
//        writes the updated rows (no division: the ring finalises);
//   K7a: a block per (batch*head, Q tile) walks the K tiles it can see and
//        writes, or adds into the ring's buffer, the fp32 dq partial of its
//        rows;
//   K7b: a block per (batch*head, K tile) walks the Q tiles that can see it
//        and writes, or adds, the fp32 dk, dv partials of its rows.
// Causal and window masks use the global positions q_off + i and k_off + j;
// the offsets are plain int arguments, so one compiled kernel serves every
// hop.  A tile is visited only when some pair in it can be valid (the guard
// of _chunk_tile_guard with the offsets folded in).  delta = rowsum(dO *
// out) is an input: the ring computes it once per step from the finished
// output, as the JAX ring does.
//
// Bound on the H100: at the ring path's per-hop shape (q, k, v
// [8, 256, 16, 128] bf16, 128 heads of 256 x 256 pairs) a visible chunk is
// ~2.1 GFLOP per product, while K6 moves the fp32 carries in and out (34 MB
// of its ~59 MB): K6 is bound by bytes, and so are K7a/K7b (below).  A
// chunk wholly in the future needs no byte moved at all when K6 updates
// the carries in place and K7 adds into the ring's sums.
//
// K6, bf16 (chunk_fwd_wgmma): K1's design (flash_attention.cu) with the
// carries in and out.
//   - A block is a TMA producer warpgroup and kFwdConsumers wgmma consumer
//     warpgroups of 64 rows each.  The producer loads the Q tile once, then
//     streams kFwdBK-row K/V tiles through kFwdStages mbarrier stages; the
//     consumers run S = Q K^T (m64nBK) and O += P V (register-A P,
//     MN-major V, m64nD) with S and O in fp32 registers, the online
//     softmax on the registers (exp2 with the scale folded in).
//   - Carry in: each consumer reads its 64 acc rows with 16-byte loads,
//     coalesced over the contiguous [B*H, Sq, D] fp32 carry, into its own
//     shared staging tile (16-byte chunks XOR-swizzled by row, so both the
//     row-wise writes and the accumulator-layout reads are free of bank
//     conflicts), and from there into the m64nD accumulator registers; m
//     to every lane of a row, l to one lane of the row's quad (the quad's
//     partial sums add up to it at the end).  Carry out: the same way
//     back, in place when the outputs are the inputs.  Each block owns its
//     rows, so aliasing is safe.
//   - Run-time offsets in the tile guard and the masks; masks only on the
//     tiles where a pair of the consumer's rows can be invalid.  A block
//     whose rows see no pair of the chunk returns at once, touching no
//     memory when it works in place (out of place it copies its carries).
//   - q, k and v are read through their [B, S, H, D] strides (TMA tensor
//     maps over the 4-D views of the ring's shards).
//   - Tiles at the ring shape (256 query rows a head): a 128-row Q tile
//     (two consumers), 64-row K/V tiles in two stages; see kFwdConsumers
//     below and PERF.md for the same-call A/B.
//
// K7a and K7b, bf16 (chunk_dq_wgmma, chunk_dkv_wgmma, in place of
// _chunk_dq_kernel and _chunk_dkv_kernel): K2's design
// (flash_attention_bwd.cu) with K6's run-time offsets, delta as an input
// and fp32 partials added in place.  On a visible hop of the ring shape
// they are bound by bytes: the fp32 sums' read and write are half of
// K7a's ~67 MB and two thirds of K7b's ~101 MB, against 6.4 and 8.6 GFLOP
// of products (~0.007-0.009 ms at the tensor cores' peak).  So no
// intermediate leaves the registers, the sums are read and written once
// in the epilogue (no partial tensor, no separate add_ pass), a hop that
// no query sees moves no byte, and two blocks share an SM so that one's
// memory phases overlap the other's products.
//   - A block is a TMA producer warpgroup and a wgmma consumer warpgroup
//     of 64 own rows; two blocks share an SM, so one block's epilogue and
//     tile loads run beside the other's products (with one block an SM
//     the phases ran one after the other).  The producer loads the own tiles
//     once (K7a: Q, dO; K7b: K, V) and streams 64-row tile pairs (K7a: K,
//     V; K7b: Q, dO) through mbarrier stages.  K7a: S = Q K^T and dP =
//     dO V^T on wgmma (both K-major), dQ += dS K with dS as a register-A
//     fragment and K MN-major.  K7b, transposed (own rows are keys): S^T =
//     K Q^T, dP^T = V dO^T, dV += P^T dO and dK += dS^T Q from registers;
//     its streamed queries' lse (log2 units) and delta come by column,
//     staged by a second producer warp into the stage.  No score tile
//     touches shared memory; the accumulators (dq, or dk and dv) stay in
//     the consumers' registers.
//   - P = exp2(S scale log2(e) - lse log2(e)), dS = P (dP - delta); masks
//     only on the tiles where a pair of the consumer's rows can be invalid
//     (global positions); heaviest tiles launch first.
//   - The epilogue scales (dq and dk by 1/sqrt(D)) and, with `accumulate`,
//     reads the block's own rows of the ring's fp32 buffer once, adds the
//     partial with one rounded fp32 addition (no FMA: bit for bit what
//     out-of-place + add_ gives) and writes them back; each block owns its
//     rows, so aliasing is safe.  A block whose rows see no pair of the
//     chunk returns at once: in accumulate form a future hop touches no
//     memory; out of place it writes its zeros.
//   - No atomics: repeated calls are bit for bit the same.  Tiles: see
//     kDqConsumers / kDkvConsumers below and PERF.md for the same-call
//     A/B (tools/chunk_tile_ablation.py).
//
// fp32 inputs (on no main path) take the scalar kernels chunk_fwd_f32 and
// chunk_bwd_f32: four warps per 64-row tile, fp32 scores staged in shared
// memory, full fp32 precision, the same offsets, guard and accumulate form.
//
// Head dims 32, 64 and 128 (D = 32 takes the 64-byte swizzle in the wgmma
// kernels, as K1 does).  Masked probabilities are exactly 0 (never exp(0) =
// 1 for a row whose keys so far are all masked): a row with no valid key
// keeps m = -1e30, l = 0, acc = 0, and in the backward (lse ~ -1e30) gets
// exact zero gradients, never inf * 0.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"
#include "launch.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BT = 64;         // fp32 kernels: rows of a tile
constexpr int kWarps = 4;      // 16 rows each
constexpr int kThreads = kWarps * 32;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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
  float* out_c;         // K6: acc (K6's outputs may be its inputs: in place)
  int B, Sq, Sk, H;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh;
  int q_off, k_off, causal, window;
  int accumulate;       // K7: add the partials into out_a (, out_b)
  float scale;
};

// Shared-memory geometry of the fp32 kernels: rows padded by one element
// (operand tiles) or four (score tiles).
template <int D> struct Geo {
  static constexpr int LD = D + 1;       // operand tiles
  static constexpr int LDS = BT + 4;     // fp32 scores
  static constexpr int LDP = BT + 4;     // P and dS
  static constexpr int LDO = D + 4;      // K6's fp32 acc
  static constexpr size_t kTile = sizeof(float) * (size_t)BT * LD;
  static constexpr size_t kS = sizeof(float) * (size_t)BT * LDS;
  static constexpr size_t kP = sizeof(float) * (size_t)BT * LDP;
  static constexpr size_t kO = sizeof(float) * (size_t)BT * LDO;
  // K6: Q, K, V, scores, P, acc, m, l, key validity.
  static constexpr size_t kFwdBytes =
      3 * kTile + kS + kP + kO + 2 * sizeof(float) * BT + sizeof(int) * BT;
  // K7: two own and two streamed tiles, P, dS (the S / dP scratch aliases
  // it), lse/delta of both tiles, validity.
  static constexpr size_t kInfo = (4 * sizeof(float) + 2 * sizeof(int)) * BT;
  static constexpr size_t kBwdBytes = 4 * kTile + 2 * kP + kInfo;
};

// Rows [row0, row0 + 64) of one head into shared memory, 16 bytes per
// load; rows at or past S read as zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          long long row_stride, int row0,
                                          int S) {
  constexpr int kChunks = D / 4;
  constexpr int LD = Geo<D>::LD;
  for (int c = threadIdx.x; c < BT * kChunks; c += kThreads) {
    const int r = c / kChunks, d = (c % kChunks) * 4;
    const int s = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < S) val = *reinterpret_cast<const float4*>(base + s * row_stride + d);
    dst[r * LD + d] = val.x;
    dst[r * LD + d + 1] = val.y;
    dst[r * LD + d + 2] = val.z;
    dst[r * LD + d + 3] = val.w;
  }
}

// Causal and sliding-window validity of one (query, key) pair in global
// positions (the padding mask is tested apart).
__device__ __forceinline__ bool pair_valid(int causal, int window, int qpos,
                                           int kpos) {
  if (!causal) return true;
  return qpos >= kpos && (window <= 0 || qpos - kpos < window);
}

// C[16 x 64] = A[16 x D] . B[64 x D]^T for one warp's rows.
template <int D>
__device__ __forceinline__ void mm_nt(const float* A, const float* Bm,
                                      float* C, int lane) {
  using G = Geo<D>;
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

// ---- K6 fp32: O += P V for one warp's 16 rows (acc in shared memory) ----

template <int D>
__device__ __forceinline__ void pv(const float* Ps, const float* Vs,
                                   float* Os, int warp, int lane) {
  using G = Geo<D>;
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

// ---- tile guards ---------------------------------------------------------

// The K tiles [kt_begin, kt_end) of Sk that can hold a key visible to some
// query of local rows [q0, q_last], with the chunk's global offsets: key
// k_off + j is visible to query q_off + i iff k_off + j <= q_off + i (and,
// with a window, q_off + i - window < k_off + j).  Empty when none is.
__device__ __forceinline__ void chunk_key_tiles(const Params& p, int q0,
                                                int q_last, int tile,
                                                int& kt_begin, int& kt_end) {
  const int n_kt = (p.Sk + tile - 1) / tile;
  kt_begin = 0;
  kt_end = n_kt;
  if (p.causal) {
    const int hi = p.q_off + q_last - p.k_off;      // newest visible key
    kt_end = hi < 0 ? 0 : min(n_kt, hi / tile + 1);
    if (p.window > 0) {
      const int lo = p.q_off + q0 - p.window + 1 - p.k_off;  // oldest
      if (lo > 0) kt_begin = min(kt_end, lo / tile);
    }
  }
}

// The Q tiles [qt_begin, qt_end) of Sq holding a query that sees some key
// of local rows [k0, k_last]: the oldest such query is k_off + k0 (local
// k_off + k0 - q_off), the newest, with a window, k_off + k_last +
// window - 1.  Empty when none is.
__device__ __forceinline__ void chunk_query_tiles(const Params& p, int k0,
                                                  int k_last, int tile,
                                                  int& qt_begin,
                                                  int& qt_end) {
  const int n_qt = (p.Sq + tile - 1) / tile;
  qt_begin = 0;
  qt_end = n_qt;
  if (p.causal) {
    if (p.window > 0) {
      const int hi = p.k_off + k_last + p.window - 1 - p.q_off;
      qt_end = hi < 0 ? 0 : min(n_qt, hi / tile + 1);
    }
    const int lo = p.k_off + k0 - p.q_off;
    if (lo > 0) qt_begin = min(qt_end, lo / tile);
  }
}

// ---- K6 fp32 -----------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads) chunk_fwd_f32(Params p) {
  using G = Geo<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = reinterpret_cast<float*>(smem + G::kTile);
  float* Vs = reinterpret_cast<float*>(smem + 2 * G::kTile);
  float* Ss = reinterpret_cast<float*>(smem + 3 * G::kTile);
  float* Ps = reinterpret_cast<float*>(smem + 3 * G::kTile + G::kS);
  float* Os = reinterpret_cast<float*>(smem + 3 * G::kTile + G::kS + G::kP);
  float* m_s = Os + BT * G::LDO;
  float* l_s = m_s + BT;
  int* mask_s = reinterpret_cast<int*>(l_s + BT);

  const int Sq = p.Sq, Sk = p.Sk, H = p.H;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row0 = (long long)bh * Sq;     // carry row base
  const float* qb = static_cast<const float*>(p.q) + b * p.qsb + h * p.qsh;
  const float* kb = static_cast<const float*>(p.k) + b * p.ksb + h * p.ksh;
  const float* vb = static_cast<const float*>(p.v) + b * p.vsb + h * p.vsh;

  int kt_begin, kt_end;
  chunk_key_tiles(p, q0, min(Sq - 1, q0 + BT - 1), BT, kt_begin, kt_end);
  // Nothing visible and the carries updated in place: nothing to do.
  if (kt_begin == kt_end && p.out_a == p.m_in) return;

  // Seed from the incoming state (not neutral values): the chunk continues
  // an online softmax already in flight.  Rows past Sq stay neutral.
  load_tile<D>(Qs, qb, p.qss, q0, Sq);
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

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();   // every warp is done with the previous K/V tile
    load_tile<D>(Ks, kb, p.kss, k0, Sk);
    load_tile<D>(Vs, vb, p.vss, k0, Sk);
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
        Ps[r * G::LDP + half * 32 + ((j + lane) & 31)] = pr;
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

// ---- K6 bf16: wgmma + TMA -------------------------------------------------

// Tiles for the ring's hop (256 query rows a head): two 64-row consumers
// and 64-row K/V tiles in two stages.  The same-call A/B of
// tools/chunk_tile_ablation.py (PERF.md) put this first; 128-row K/V
// tiles do the same work on a visible hop but more masked work on the
// diagonal, one consumer a block loses a third.
constexpr int kFwdConsumers = 2;              // 64 query rows each
constexpr int kFwdBQ = 64 * kFwdConsumers;    // Q rows per block
constexpr int kFwdBK = 64;                    // K/V rows per tile
constexpr int kFwdStages = 2;
constexpr int kFwdThreads = 128 * (1 + kFwdConsumers);

template <int D> struct FwdSmem {
  static constexpr int kQ = kFwdBQ * D * 2;          // the Q tile
  static constexpr int kKV = kFwdBK * D * 2;         // a K or V tile
  static constexpr int kStage = 2 * kKV;
  static constexpr int kCarry = 64 * D * 4;          // a consumer's acc rows
  static constexpr int kCarries = kQ + kFwdStages * kStage;
  static constexpr int kBarriers = kCarries + kFwdConsumers * kCarry;
  // + 1 KB so the tiles can start on a 1024-byte boundary.
  static constexpr size_t kBytes =
      1024 + kBarriers + (1 + 2 * kFwdStages) * sizeof(uint64_t);
};

// Float index of element (r, n) in a consumer's [64, D] fp32 staging tile:
// the 16-byte chunk n / 4 of row r is XOR-swizzled with 2 (r % 4), so a
// warp's accumulator-layout float2 reads (8 rows x 4 column pairs) and its
// row-wise 16-byte writes both touch every bank once per phase.
template <int D>
__device__ __forceinline__ int stage_at(int r, int n) {
  return r * D + 4 * ((n >> 2) ^ (2 * (r & 3))) + (n & 3);
}

// Named barrier over one consumer warpgroup (id 1 + c; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int c) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
    chunk_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, Params p) {
  using G = FwdSmem<D>;
  const int Sq = p.Sq, Sk = p.Sk, H = p.H;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdBQ;   // heaviest first
  const int tid = threadIdx.x;
  const int rows = min(kFwdBQ, Sq - q0);
  const long long crow = (long long)bh * Sq + q0;          // carry row base

  int kt_begin, kt_end;
  chunk_key_tiles(p, q0, q0 + rows - 1, kFwdBK, kt_begin, kt_end);
  const int n_tiles = kt_end - kt_begin;
  if (n_tiles == 0) {
    // No pair of the chunk is visible to these rows: the carries stand.
    // In place that is no work at all; out of place, a copy.
    if (p.out_a != p.m_in) {
      for (int i = tid; i < rows; i += kFwdThreads) {
        p.out_a[crow + i] = p.m_in[crow + i];
        p.out_b[crow + i] = p.l_in[crow + i];
      }
      const float4* src = reinterpret_cast<const float4*>(p.acc_in + crow * D);
      float4* dst = reinterpret_cast<float4*>(p.out_c + crow * D);
      for (int i = tid; i < rows * D / 4; i += kFwdThreads) dst[i] = src[i];
    }
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = smem;
  uint8_t* KVs = smem + G::kQ;   // stage s: K at s * kStage, V after it
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + G::kBarriers);
  uint64_t* bar_q = bar;
  uint64_t* full = bar + 1;
  uint64_t* empty = bar + 1 + kFwdStages;

  if (tid == 0) {
    dtt::mbar_init(bar_q, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      dtt::mbar_init(&full[s], 1);
      dtt::mbar_init(&empty[s], 4 * kFwdConsumers);   // one arrival a warp
    }
    dtt::mbar_fence_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 0) {
    // ---- producer ----
    dtt::regs_dec<40>();
    if (tid == 0) {
      dtt::mbar_expect_tx(bar_q, G::kQ);
      dtt::tma_load_tile<D, kFwdBQ>(Qs, &tq, bar_q, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kFwdStages;
        dtt::mbar_wait(&empty[s], ((it / kFwdStages) & 1) ^ 1);
        dtt::mbar_expect_tx(&full[s], G::kStage);
        const int k0 = (kt_begin + it) * kFwdBK;
        uint8_t* st = KVs + s * G::kStage;
        dtt::tma_load_tile<D, kFwdBK>(st, &tk, &full[s], h, k0, b);
        dtt::tma_load_tile<D, kFwdBK>(st + G::kKV, &tv, &full[s], h, k0, b);
      }
    }
    return;
  }

  // ---- consumers ----
  dtt::regs_inc<232>();
  const int c = wg - 1;                   // 64-row part of the Q tile
  const int t = tid % 128, warp = t / 32, lane = t % 32;
  const int q_lo = q0 + 64 * c;           // first local row of this part
  const int n_own = max(0, min(64, Sq - q_lo));   // its rows inside Sq
  const long long orow = crow + 64 * c;   // its carry rows
  const int r_lo = 16 * warp + lane / 4;  // its rows r_lo, r_lo + 8
  const int col0 = 2 * (lane % 4);
  const float cs = p.scale * kLog2e;      // raw score -> log2 units
  const int* kvm = p.kv_mask ? p.kv_mask + (long long)b * Sk : nullptr;
  float* stage = reinterpret_cast<float*>(smem + G::kCarries + c * G::kCarry);

  // Carry in: acc rows (16-byte loads) -> staging -> accumulator registers.
  {
    const float4* src = reinterpret_cast<const float4*>(p.acc_in + orow * D);
    for (int i = t; i < 64 * D / 4; i += 128) {
      const int r = i / (D / 4), n = 4 * (i % (D / 4));
      const float4 v = r < n_own ? src[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(stage + stage_at<D>(r, n)) = v;
    }
  }
  wg_sync(c);
  float o[D / 2];
  float m[2], l[2];   // m: scaled units, the row's; l: this lane's part
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + 8 * r;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(
          stage + stage_at<D>(row, 8 * j + col0));
      o[4 * j + 2 * r] = v.x;
      o[4 * j + 2 * r + 1] = v.y;
    }
    const bool in = row < n_own;
    m[r] = in ? p.m_in[orow + row] : kNeg;
    l[r] = in && lane % 4 == 0 ? p.l_in[orow + row] : 0.f;
  }

  dtt::mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kFwdStages;
    const int k0 = (kt_begin + it) * kFwdBK;
    const uint8_t* Ks = KVs + s * G::kStage;
    const uint8_t* Vs = Ks + G::kKV;
    dtt::mbar_wait(&full[s], (it / kFwdStages) & 1);

    float sc[kFwdBK / 2];
    dtt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      dtt::wgmma_ss<kFwdBK>(sc, dtt::tile_kmajor<D, kFwdBQ>(Qs, 64 * c, kk),
                            dtt::tile_kmajor<D, kFwdBK>(Ks, 0, kk), kk > 0);
    dtt::wgmma_commit();
    dtt::wgmma_wait_all();
    dtt::fence_regs(sc);

    // Masks, only where some pair of this warpgroup's rows can be invalid
    // (global positions q_off + local row, k_off + local key).
    const int gq = p.q_off + q_lo, gk = p.k_off + k0;
    const bool need_mask =
        kvm != nullptr || k0 + kFwdBK > Sk ||
        (p.causal && (gk + kFwdBK - 1 > gq ||
                      (p.window > 0 && gq + 63 - gk >= p.window)));
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < kFwdBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * j + col0 + e;
          bool kv_ok = kpos < Sk;
          if (kvm != nullptr && kv_ok) kv_ok = kvm[kpos] != 0;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const bool ok = kv_ok && pair_valid(p.causal, p.window,
                                                gq + r_lo + 8 * r,
                                                p.k_off + kpos);
            if (!ok) sc[4 * j + 2 * r + e] = -INFINITY;
          }
        }
      }
    }

    // Online softmax on the registers (row r of this thread: the values
    // with (i / 2) % 2 == r).  m stays in scaled units and never below
    // -1e30, as the plain version's: a row whose keys so far are all
    // masked keeps m = -1e30, and exp2(-inf) = 0 for every masked score.
    float corr[2], mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kFwdBK / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], fmaxf(mx * p.scale, kNeg));
      corr[r] = dtt::fast_exp2((m[r] - m_new) * kLog2e);
      mc[r] = m_new * kLog2e;
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kFwdBK / 2; ++i) {
      const int r = (i / 2) % 2;
      sc[i] = dtt::fast_exp2(fmaf(sc[i], cs, -mc[r]));
      rs[r] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i / 2) % 2];

    uint32_t pa[kFwdBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kFwdBK / 16; ++kk) dtt::to_a_frag(sc, kk, pa[kk]);
    dtt::fence_frags(pa);
    dtt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kFwdBK / 16; ++kk)
      dtt::wgmma_rs<D>(o, pa[kk], dtt::tile_mnmajor<D, kFwdBK>(Vs, kk), 1);
    dtt::wgmma_commit();
    dtt::wgmma_wait_all();
    dtt::fence_regs(o);
    dtt::fence_frags(pa);
    __syncwarp();
    if (lane == 0) dtt::mbar_arrive(&empty[s]);
  }

  // Carry out (no division: the ring finalises): the quad's partial sums
  // of l, acc registers -> staging -> 16-byte stores of the rows.
  wg_sync(c);   // every warp of this consumer has read the staged carry
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + 8 * r;
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(stage + stage_at<D>(row, 8 * j + col0)) =
          make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
    if (lane % 4 == 0 && row < n_own) {
      p.out_a[orow + row] = m[r];
      p.out_b[orow + row] = l[r];
    }
  }
  wg_sync(c);
  float4* dst = reinterpret_cast<float4*>(p.out_c + orow * D);
  for (int i = t; i < n_own * D / 4; i += 128) {
    const int r = i / (D / 4), n = 4 * (i % (D / 4));
    dst[i] = *reinterpret_cast<const float4*>(stage + stage_at<D>(r, n));
  }
}

template <int D>
cudaError_t launch_fwd_wgmma(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  // An empty chunk (Sk = 0) loads nothing; its maps only need to encode.
  const int Sk = p.Sk > 0 ? p.Sk : 1;
  cudaError_t e;
  if ((e = dtt::make_tile_map(&tq, p.q, p.B, p.Sq, p.H, D, p.qsb, p.qss,
                              p.qsh, kFwdBQ)) != cudaSuccess ||
      (e = dtt::make_tile_map(&tk, p.k, p.B, Sk, p.H, D, p.ksb, p.kss,
                              p.ksh, kFwdBK)) != cudaSuccess ||
      (e = dtt::make_tile_map(&tv, p.v, p.B, Sk, p.H, D, p.vsb, p.vss,
                              p.vsh, kFwdBK)) != cudaSuccess)
    return e;
  constexpr size_t smem = FwdSmem<D>::kBytes;
  static bool done[dtt::kMaxDevices];
  if ((e = dtt::opt_in_smem(chunk_fwd_wgmma<D>, smem, done)) != cudaSuccess)
    return e;
  dim3 grid(p.B * p.H, (p.Sq + kFwdBQ - 1) / kFwdBQ);
  chunk_fwd_wgmma<D><<<grid, kFwdThreads, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

// ---- K7a / K7b bf16: wgmma + TMA ----------------------------------------

// Tiles for the ring's hop (256 rows a head): one consumer of 64 own rows
// a block, so that two blocks share an SM (BwdRegs below), and two stages
// of 64-row streamed tiles.  The same-call A/B of
// tools/chunk_tile_ablation.py (PERF.md) chose them: two consumers a block
// (one block an SM) lose 6% (K7a) and 3% (K7b) of the hop mean, a third
// stage leaves room for one block an SM and loses a third.
constexpr int kDqConsumers = 1;
constexpr int kDqStages = 2;
constexpr int kDkvConsumers = 1;
constexpr int kDkvStages = 2;
constexpr int kBwdStr = 64;                   // rows of a streamed tile

// Registers a thread of a block with C consumers: the producer warpgroup
// gives its own back, the consumers take them.  One consumer's block is
// small enough (128 x 24 + 128 x 232 = 32K registers) for two blocks to
// share an SM, so that one's epilogue runs beside the other's products.
template <int C> struct BwdRegs {
  static constexpr int kBlocksPerSm = C == 1 ? 2 : 1;
  static constexpr int kProducer = C == 1 ? 24 : 40;   // consumers: 232
};

template <int D, int C, int ST, bool kStats> struct BwdSmem {
  static constexpr int kOwn = 64 * C;                 // own rows a block
  static constexpr int kOwnTile = kOwn * D * 2;
  static constexpr int kStrTile = kBwdStr * D * 2;
  static constexpr int kStage = 2 * kStrTile;
  static constexpr int kStatBytes = kStats ? ST * 2 * kBwdStr * 4 : 0;
  static constexpr int kStages = 2 * kOwnTile;        // offset of stage 0
  static constexpr int kStatsAt = kStages + ST * kStage;
  static constexpr int kBarriers = kStatsAt + kStatBytes;
  // + 1 KB so the tiles can start on a 1024-byte boundary.
  static constexpr size_t kBytes =
      1024 + kBarriers + (1 + 2 * ST) * sizeof(uint64_t);
};
template <int D>
using DqSmem = BwdSmem<D, kDqConsumers, kDqStages, false>;
template <int D>
using DkvSmem = BwdSmem<D, kDkvConsumers, kDkvStages, true>;

// The producer warpgroup: lane 0 of warp 0 TMA-loads the block's two own
// tiles (rows own0..) once, then streams tile pairs from row
// (st_begin + it) * 64 through ST stages; with kStats (K7b) warp 1 stages
// the streamed queries' lse (log2 units; +inf past Sq, so P = 0 there) and
// delta beside them and arrives on the same full barrier.
template <int D, int C, int ST, bool kStats>
__device__ __forceinline__ void produce_bwd(
    const CUtensorMap* own_a, const CUtensorMap* own_b,
    const CUtensorMap* str_a, const CUtensorMap* str_b, uint8_t* smem,
    uint64_t* bar_own, uint64_t* full, uint64_t* empty, const Params& p,
    int bh, int b, int h, int own0, int st_begin, int n_tiles) {
  using G = BwdSmem<D, C, ST, kStats>;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (warp == 0 && lane == 0) {
    dtt::mbar_expect_tx(bar_own, 2 * G::kOwnTile);
    dtt::tma_load_tile<D, G::kOwn>(smem, own_a, bar_own, h, own0, b);
    dtt::tma_load_tile<D, G::kOwn>(smem + G::kOwnTile, own_b, bar_own, h,
                                   own0, b);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % ST;
      dtt::mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
      dtt::mbar_expect_tx(&full[s], G::kStage);
      const int r0 = (st_begin + it) * kBwdStr;
      uint8_t* st = smem + G::kStages + s * G::kStage;
      dtt::tma_load_tile<D, kBwdStr>(st, str_a, &full[s], h, r0, b);
      dtt::tma_load_tile<D, kBwdStr>(st + G::kStrTile, str_b, &full[s], h,
                                     r0, b);
    }
  } else if (kStats && warp == 1) {
    const long long row = (long long)bh * p.Sq;
    float* stats = reinterpret_cast<float*>(smem + G::kStatsAt);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % ST;
      dtt::mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
      float* lse2 = stats + s * 2 * kBwdStr;
      float* del = lse2 + kBwdStr;
#pragma unroll
      for (int e = 0; e < kBwdStr / 32; ++e) {
        const int i = lane + 32 * e;
        const int qpos = (st_begin + it) * kBwdStr + i;
        const bool in = qpos < p.Sq;
        lse2[i] = in ? p.lse[row + qpos] * kLog2e : INFINITY;
        del[i] = in ? p.delta[row + qpos] : 0.f;
      }
      dtt::mbar_arrive(&full[s]);   // one arrival a lane, after its stores
    }
  }
}

// Rows [0, n) x D of a contiguous fp32 block of rows set to zero (an
// out-of-place partial of a block that sees no pair).
__device__ __forceinline__ void zero_rows(float* dst, int n, int threads) {
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < n / 4; i += threads)
    d4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// A consumer thread's two accumulator rows (local rows row, row + 8 of
// the [S, D] fp32 partial at `base`) times `scale`, written, or added to
// what the rows hold: each value one rounded product and, in accumulate
// form, one rounded sum (no FMA), as out-of-place + add_ computes it.
template <int D>
__device__ __forceinline__ void store_partial(const float (&acc)[D / 2],
                                              float* base, int row, int S,
                                              float scale, int col0,
                                              bool accumulate) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = row + 8 * r;
    if (pos >= S) continue;
    float2* dst = reinterpret_cast<float2*>(base + (long long)pos * D + col0);
    float2 old[D / 8];
    if (accumulate) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) old[j] = dst[4 * j];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      float2 v = make_float2(__fmul_rn(acc[4 * j + 2 * r], scale),
                             __fmul_rn(acc[4 * j + 2 * r + 1], scale));
      if (accumulate) {
        v.x = __fadd_rn(old[j].x, v.x);
        v.y = __fadd_rn(old[j].y, v.y);
      }
      dst[4 * j] = v;
    }
  }
}

// K7a: the dq partial.  Own: Q, dO; streamed: K, V.
template <int D>
__global__ void __launch_bounds__(128 * (1 + kDqConsumers),
                                  BwdRegs<kDqConsumers>::kBlocksPerSm)
    chunk_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo, Params p) {
  using G = DqSmem<D>;
  constexpr int kOwn = G::kOwn, ST = kDqStages;
  const int Sq = p.Sq, Sk = p.Sk, H = p.H;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kOwn;   // heaviest first
  const int tid = threadIdx.x;
  const int rows = min(kOwn, Sq - q0);
  float* out = p.out_a + (long long)bh * Sq * D;

  int kt_begin, kt_end;
  chunk_key_tiles(p, q0, q0 + rows - 1, kBwdStr, kt_begin, kt_end);
  const int n_tiles = kt_end - kt_begin;
  if (n_tiles == 0) {
    // No key of the chunk is visible to these rows: the partial is zero.
    // Added in place that is no work at all.
    if (!p.accumulate)
      zero_rows(out + (long long)q0 * D, rows * D, blockDim.x);
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint8_t* Qs = smem;
  const uint8_t* dOs = smem + G::kOwnTile;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + G::kBarriers);
  uint64_t* bar_own = bar;
  uint64_t* full = bar + 1;
  uint64_t* empty = bar + 1 + ST;

  if (tid == 0) {
    dtt::mbar_init(bar_own, 1);
    for (int s = 0; s < ST; ++s) {
      dtt::mbar_init(&full[s], 1);
      dtt::mbar_init(&empty[s], 4 * kDqConsumers);   // one arrival a warp
    }
    dtt::mbar_fence_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 0) {
    dtt::regs_dec<BwdRegs<kDqConsumers>::kProducer>();
    produce_bwd<D, kDqConsumers, ST, false>(&tq, &tdo, &tk, &tv, smem,
                                            bar_own, full, empty, p, bh, b,
                                            h, q0, kt_begin, n_tiles);
    return;
  }

  dtt::regs_inc<232>();
  const int c = wg - 1;
  const int t = tid % 128, warp = t / 32, lane = t % 32;
  const int q_lo = q0 + 64 * c;
  const int row0 = q_lo + 16 * warp + lane / 4;   // and row0 + 8
  const int col0 = 2 * (lane % 4);
  const float cs = p.scale * kLog2e;
  const long long srow = (long long)bh * Sq;
  const int* kvm = p.kv_mask ? p.kv_mask + (long long)b * Sk : nullptr;
  const uint8_t* stages = smem + G::kStages;

  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = row0 + 8 * r;
    lse2[r] = pos < Sq ? p.lse[srow + pos] * kLog2e : INFINITY;
    dl[r] = pos < Sq ? p.delta[srow + pos] : 0.f;
  }

  float dq[D / 2];
  dtt::zero(dq);
  dtt::mbar_wait(bar_own, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % ST;
    const int k0 = (kt_begin + it) * kBwdStr;
    const uint8_t* Ks = stages + s * G::kStage;
    const uint8_t* Vs = Ks + G::kStrTile;
    dtt::mbar_wait(&full[s], (it / ST) & 1);

    float sc[kBwdStr / 2], dp[kBwdStr / 2];
    dtt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      dtt::wgmma_ss<kBwdStr>(sc, dtt::tile_kmajor<D, kOwn>(Qs, 64 * c, kk),
                             dtt::tile_kmajor<D, kBwdStr>(Ks, 0, kk),
                             kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      dtt::wgmma_ss<kBwdStr>(dp, dtt::tile_kmajor<D, kOwn>(dOs, 64 * c, kk),
                             dtt::tile_kmajor<D, kBwdStr>(Vs, 0, kk),
                             kk > 0);
    dtt::wgmma_commit();
    dtt::wgmma_wait_all();
    dtt::fence_regs(sc);
    dtt::fence_regs(dp);

    // Masks, only where some pair of this warpgroup's rows can be invalid
    // (global positions q_off + local row, k_off + local key; keys past Sk
    // are zeros from TMA and masked too).
    const int gq = p.q_off + q_lo, gk = p.k_off + k0;
    const bool need_mask =
        kvm != nullptr || k0 + kBwdStr > Sk ||
        (p.causal && (gk + kBwdStr - 1 > gq ||
                      (p.window > 0 && gq + 63 - gk >= p.window)));
#pragma unroll
    for (int i = 0; i < kBwdStr / 2; ++i) {
      const int r = (i / 2) % 2;
      bool ok = true;
      if (need_mask) {
        const int kpos = k0 + 8 * (i / 4) + col0 + i % 2;
        ok = kpos < Sk && (kvm == nullptr || kvm[kpos] != 0) &&
             pair_valid(p.causal, p.window, p.q_off + row0 + 8 * r,
                        p.k_off + kpos);
      }
      const float pr = ok ? dtt::fast_exp2(fmaf(sc[i], cs, -lse2[r])) : 0.f;
      sc[i] = pr * (dp[i] - dl[r]);   // dS
    }

    uint32_t ds[kBwdStr / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBwdStr / 16; ++kk) dtt::to_a_frag(sc, kk, ds[kk]);
    dtt::fence_frags(ds);
    dtt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBwdStr / 16; ++kk)
      dtt::wgmma_rs<D>(dq, ds[kk], dtt::tile_mnmajor<D, kBwdStr>(Ks, kk), 1);
    dtt::wgmma_commit();
    dtt::wgmma_wait_all();
    dtt::fence_regs(dq);
    dtt::fence_frags(ds);
    __syncwarp();
    if (lane == 0) dtt::mbar_arrive(&empty[s]);
  }

  // dq = scale dS K: the scale folds in here.
  store_partial<D>(dq, out, row0, Sq, p.scale, col0, p.accumulate != 0);
}

// K7b: the dk and dv partials.  Own: K, V; streamed: Q, dO (and their lse,
// delta).
template <int D>
__global__ void __launch_bounds__(128 * (1 + kDkvConsumers),
                                  BwdRegs<kDkvConsumers>::kBlocksPerSm)
    chunk_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo, Params p) {
  using G = DkvSmem<D>;
  constexpr int kOwn = G::kOwn, ST = kDkvStages;
  const int Sk = p.Sk, H = p.H;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kOwn;      // causal: the first are heaviest
  const int tid = threadIdx.x;
  const int rows = min(kOwn, Sk - k0);
  float* out_k = p.out_a + (long long)bh * Sk * D;
  float* out_v = p.out_b + (long long)bh * Sk * D;

  int qt_begin, qt_end;
  chunk_query_tiles(p, k0, k0 + rows - 1, kBwdStr, qt_begin, qt_end);
  const int n_tiles = qt_end - qt_begin;
  if (n_tiles == 0) {
    // No query of the chunk sees these keys: the partials are zero.
    if (!p.accumulate) {
      zero_rows(out_k + (long long)k0 * D, rows * D, blockDim.x);
      zero_rows(out_v + (long long)k0 * D, rows * D, blockDim.x);
    }
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint8_t* Ks = smem;
  const uint8_t* Vs = smem + G::kOwnTile;
  const uint8_t* stages = smem + G::kStages;
  const float* stats = reinterpret_cast<const float*>(smem + G::kStatsAt);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + G::kBarriers);
  uint64_t* bar_own = bar;
  uint64_t* full = bar + 1;
  uint64_t* empty = bar + 1 + ST;

  if (tid == 0) {
    dtt::mbar_init(bar_own, 1);
    for (int s = 0; s < ST; ++s) {
      dtt::mbar_init(&full[s], 1 + 32);   // TMA thread + the stats warp
      dtt::mbar_init(&empty[s], 4 * kDkvConsumers);
    }
    dtt::mbar_fence_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 0) {
    dtt::regs_dec<BwdRegs<kDkvConsumers>::kProducer>();
    produce_bwd<D, kDkvConsumers, ST, true>(&tk, &tv, &tq, &tdo, smem,
                                            bar_own, full, empty, p, bh, b,
                                            h, k0, qt_begin, n_tiles);
    return;
  }

  dtt::regs_inc<232>();
  const int c = wg - 1;
  const int t = tid % 128, warp = t / 32, lane = t % 32;
  const int k_lo = k0 + 64 * c;
  const int row0 = k_lo + 16 * warp + lane / 4;   // key rows row0, row0 + 8
  const int col0 = 2 * (lane % 4);
  const float cs = p.scale * kLog2e;
  const int* kvm = p.kv_mask ? p.kv_mask + (long long)b * Sk : nullptr;
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    key_ok[r] = kvm == nullptr ||
                (row0 + 8 * r < Sk && kvm[row0 + 8 * r] != 0);

  float dk[D / 2], dv[D / 2];
  dtt::zero(dk);
  dtt::zero(dv);
  dtt::mbar_wait(bar_own, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % ST;
    const int qs0 = (qt_begin + it) * kBwdStr;
    const uint8_t* Qt = stages + s * G::kStage;
    const uint8_t* dOt = Qt + G::kStrTile;
    const float* lse2 = stats + s * 2 * kBwdStr;
    const float* del = lse2 + kBwdStr;
    dtt::mbar_wait(&full[s], (it / ST) & 1);

    float st[kBwdStr / 2], dpt[kBwdStr / 2];
    dtt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      dtt::wgmma_ss<kBwdStr>(st, dtt::tile_kmajor<D, kOwn>(Ks, 64 * c, kk),
                             dtt::tile_kmajor<D, kBwdStr>(Qt, 0, kk),
                             kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      dtt::wgmma_ss<kBwdStr>(dpt, dtt::tile_kmajor<D, kOwn>(Vs, 64 * c, kk),
                             dtt::tile_kmajor<D, kBwdStr>(dOt, 0, kk),
                             kk > 0);
    dtt::wgmma_commit();
    dtt::wgmma_wait_all();
    dtt::fence_regs(st);
    dtt::fence_regs(dpt);

    // Masks where some pair of this warpgroup's keys and the tile's
    // queries can be invalid (queries past Sq have lse +inf: P = 0).
    const int gk = p.k_off + k_lo, gq = p.q_off + qs0;
    const bool need_mask =
        kvm != nullptr ||
        (p.causal && (gk + 63 > gq ||
                      (p.window > 0 && gq + kBwdStr - 1 - gk >= p.window)));
#pragma unroll
    for (int i = 0; i < kBwdStr / 2; ++i) {
      const int r = (i / 2) % 2;
      const int col = 8 * (i / 4) + col0 + i % 2;
      bool ok = true;
      if (need_mask)
        ok = key_ok[r] && pair_valid(p.causal, p.window, gq + col,
                                     p.k_off + row0 + 8 * r);
      const float pr = ok ? dtt::fast_exp2(fmaf(st[i], cs, -lse2[col])) : 0.f;
      st[i] = pr;                          // P^T
      dpt[i] = pr * (dpt[i] - del[col]);   // dS^T
    }

    uint32_t pa[kBwdStr / 16][4], da[kBwdStr / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBwdStr / 16; ++kk) {
      dtt::to_a_frag(st, kk, pa[kk]);
      dtt::to_a_frag(dpt, kk, da[kk]);
    }
    dtt::fence_frags(pa);
    dtt::fence_frags(da);
    dtt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBwdStr / 16; ++kk)
      dtt::wgmma_rs<D>(dv, pa[kk], dtt::tile_mnmajor<D, kBwdStr>(dOt, kk), 1);
#pragma unroll
    for (int kk = 0; kk < kBwdStr / 16; ++kk)
      dtt::wgmma_rs<D>(dk, da[kk], dtt::tile_mnmajor<D, kBwdStr>(Qt, kk), 1);
    dtt::wgmma_commit();
    dtt::wgmma_wait_all();
    dtt::fence_regs(dk);
    dtt::fence_regs(dv);
    dtt::fence_frags(pa);
    dtt::fence_frags(da);
    __syncwarp();
    if (lane == 0) dtt::mbar_arrive(&empty[s]);
  }

  // dk = dS^T (scale q): the scale folds in here.
  const bool acc = p.accumulate != 0;
  store_partial<D>(dk, out_k, row0, Sk, p.scale, col0, acc);
  store_partial<D>(dv, out_v, row0, Sk, 1.f, col0, acc);
}

// ---- K7 fp32: the scalar kernel --------------------------------------------

// A warp's 16 x D fp32 accumulator: acc += A[16 x 64] . B[64 x D].
template <int D> struct Acc {
  using G = Geo<D>;
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

  // scale * acc into rows [pos0, pos0 + 16) of out (row pitch D): written,
  // or added with one rounded fp32 sum, as store_partial does.
  __device__ __forceinline__ void store(float* out, int pos0, int S,
                                        float scale, bool accumulate,
                                        int lane) {
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      if (pos0 + rr >= S) break;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        float* o = out + (long long)(pos0 + rr) * D + lane + 32 * j;
        const float v = __fmul_rn(f[rr][j], scale);
        *o = accumulate ? __fadd_rn(*o, v) : v;
      }
    }
  }
};

// kDKV = true: K7b (own tile = keys, streamed = queries) -> dk, dv.
// kDKV = false: K7a (own tile = queries, streamed = keys) -> dq.
template <int D, bool kDKV>
__global__ void __launch_bounds__(kThreads) chunk_bwd_f32(Params p) {
  using G = Geo<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* own1 = reinterpret_cast<float*>(smem);
  float* own2 = reinterpret_cast<float*>(smem + G::kTile);
  float* str1 = reinterpret_cast<float*>(smem + 2 * G::kTile);
  float* str2 = reinterpret_cast<float*>(smem + 3 * G::kTile);
  float* Ps = reinterpret_cast<float*>(smem + 4 * G::kTile);
  float* dSs = reinterpret_cast<float*>(smem + 4 * G::kTile + G::kP);
  float* Sc = dSs;   // the S / dP scratch, consumed before dS is written
  float* own_lse = reinterpret_cast<float*>(smem + 4 * G::kTile + 2 * G::kP);
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
  const float* qb = static_cast<const float*>(p.q) + b * p.qsb + h * p.qsh;
  const float* kb = static_cast<const float*>(p.k) + b * p.ksb + h * p.ksh;
  const float* vb = static_cast<const float*>(p.v) + b * p.vsb + h * p.vsh;
  const float* db =
      static_cast<const float*>(p.dout) + b * p.dsb + h * p.dsh;

  // Streamed tiles that can hold a valid pair for some own row.
  const int own_last = min(S_own - 1, own0 + BT - 1);
  int st_begin, st_end;
  if (kDKV)
    chunk_query_tiles(p, own0, own_last, BT, st_begin, st_end);
  else
    chunk_key_tiles(p, own0, own_last, BT, st_begin, st_end);
  // Nothing visible and the partials added in place: nothing to do.
  if (st_begin == st_end && p.accumulate) return;

  if (kDKV) {
    load_tile<D>(own1, kb, p.kss, own0, Sk);
    load_tile<D>(own2, vb, p.vss, own0, Sk);
  } else {
    load_tile<D>(own1, qb, p.qss, own0, Sq);
    load_tile<D>(own2, db, p.dss, own0, Sq);
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

  Acc<D> acc_a, acc_b;   // dq | dk, and dv
  acc_a.zero();
  if (kDKV) acc_b.zero();

  const float* own1_w = own1 + (warp * 16) * G::LD;
  const float* own2_w = own2 + (warp * 16) * G::LD;
  float* P_w = Ps + (warp * 16) * G::LDP;
  float* dS_w = dSs + (warp * 16) * G::LDP;
  float* Sc_w = Sc + (warp * 16) * G::LDS;

  for (int st = st_begin; st < st_end; ++st) {
    const int str0 = st * BT;
    __syncthreads();   // every warp is done with the previous streamed tile
    if (kDKV) {
      load_tile<D>(str1, qb, p.qss, str0, Sq);
      load_tile<D>(str2, db, p.dss, str0, Sq);
    } else {
      load_tile<D>(str1, kb, p.kss, str0, Sk);
      load_tile<D>(str2, vb, p.vss, str0, Sk);
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
      P_w[r * G::LDP + c] = pv;
    }
    __syncwarp();

    // dP slice, then dS = P (dP - delta).
    mm_nt<D>(own2_w, str2, Sc_w, lane);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = i >> 1, c = (i & 1) * 32 + lane;
      const float dl = kDKV ? str_delta[c] : own_delta[warp * 16 + r];
      dS_w[r * G::LDP + c] = pr[i] * (Sc_w[r * G::LDS + c] - dl);
    }
    __syncwarp();

    acc_a.mma(dS_w, str1, lane);            // dq += dS K  |  dk += dS^T Q
    if (kDKV) acc_b.mma(P_w, str2, lane);   // dv += P^T dO
  }

  // dq = scale dS K and dk = dS^T (scale q): the scale folds in here.
  const int pos0 = own0 + warp * 16;
  const bool accumulate = p.accumulate != 0;
  acc_a.store(p.out_a + (long long)bh * S_own * D, pos0, S_own, p.scale,
              accumulate, lane);
  if (kDKV)
    acc_b.store(p.out_b + (long long)bh * S_own * D, pos0, S_own, 1.f,
                accumulate, lane);
}

// ---- launchers --------------------------------------------------------------

template <int D>
cudaError_t launch_fwd_f32(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Geo<D>::kFwdBytes;
  static bool done[dtt::kMaxDevices];
  const cudaError_t e = dtt::opt_in_smem(chunk_fwd_f32<D>, smem, done);
  if (e != cudaSuccess) return e;
  dim3 grid((p.Sq + BT - 1) / BT, p.B * p.H);
  chunk_fwd_f32<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool kDKV>
cudaError_t launch_bwd_f32(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Geo<D>::kBwdBytes;
  static bool done[dtt::kMaxDevices];
  const cudaError_t e = dtt::opt_in_smem(chunk_bwd_f32<D, kDKV>, smem, done);
  if (e != cudaSuccess) return e;
  dim3 grid(((kDKV ? p.Sk : p.Sq) + BT - 1) / BT, p.B * p.H);
  chunk_bwd_f32<D, kDKV><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool kDKV>
cudaError_t launch_bwd_wgmma(const Params& p, cudaStream_t stream) {
  constexpr int kOwn = kDKV ? DkvSmem<D>::kOwn : DqSmem<D>::kOwn;
  constexpr size_t smem = kDKV ? DkvSmem<D>::kBytes : DqSmem<D>::kBytes;
  constexpr int threads =
      128 * (1 + (kDKV ? kDkvConsumers : kDqConsumers));
  // The own tiles are kOwn-row boxes, the streamed ones 64-row boxes; an
  // empty side (Sq or Sk = 0) loads nothing, its maps need only encode.
  const int rq = kDKV ? kBwdStr : kOwn, rk = kDKV ? kOwn : kBwdStr;
  const int Sq = p.Sq > 0 ? p.Sq : 1, Sk = p.Sk > 0 ? p.Sk : 1;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t e;
  if ((e = dtt::make_tile_map(&tq, p.q, p.B, Sq, p.H, D, p.qsb, p.qss,
                              p.qsh, rq)) != cudaSuccess ||
      (e = dtt::make_tile_map(&tk, p.k, p.B, Sk, p.H, D, p.ksb, p.kss,
                              p.ksh, rk)) != cudaSuccess ||
      (e = dtt::make_tile_map(&tv, p.v, p.B, Sk, p.H, D, p.vsb, p.vss,
                              p.vsh, rk)) != cudaSuccess ||
      (e = dtt::make_tile_map(&tdo, p.dout, p.B, Sq, p.H, D, p.dsb, p.dss,
                              p.dsh, rq)) != cudaSuccess)
    return e;
  auto kernel = kDKV ? chunk_dkv_wgmma<D> : chunk_dq_wgmma<D>;
  static bool done[dtt::kMaxDevices];
  if ((e = dtt::opt_in_smem(kernel, smem, done)) != cudaSuccess) return e;
  dim3 grid(p.B * p.H, ((kDKV ? p.Sk : p.Sq) + kOwn - 1) / kOwn);
  kernel<<<grid, threads, smem, stream>>>(tq, tk, tv, tdo, p);
  return cudaGetLastError();
}

// kind: 0 = K6, 1 = K7a, 2 = K7b.
int dispatch(const Params& p, int kind, int D, int dtype, cudaStream_t s) {
#define DTT_CHUNK_CASE(DD, FWD, BWD)                                \
  if (D == DD) {                                                    \
    if (kind == 0) return (int)FWD<DD>(p, s);                       \
    if (kind == 1) return (int)BWD<DD, false>(p, s);                \
    if (kind == 2) return (int)BWD<DD, true>(p, s);                 \
  }
  if (dtype == 1) {
    DTT_CHUNK_CASE(128, launch_fwd_wgmma, launch_bwd_wgmma)
    DTT_CHUNK_CASE(64, launch_fwd_wgmma, launch_bwd_wgmma)
    DTT_CHUNK_CASE(32, launch_fwd_wgmma, launch_bwd_wgmma)
  } else if (dtype == 0) {
    DTT_CHUNK_CASE(128, launch_fwd_f32, launch_bwd_f32)
    DTT_CHUNK_CASE(64, launch_fwd_f32, launch_bwd_f32)
    DTT_CHUNK_CASE(32, launch_fwd_f32, launch_bwd_f32)
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

// Dynamic shared memory of the bf16 K6 kernel at head_dim D (for reports).
extern "C" long long dtt_flash_attention_chunk_smem(int D) {
  return D == 32   ? (long long)FwdSmem<32>::kBytes
         : D == 64 ? (long long)FwdSmem<64>::kBytes
                   : (long long)FwdSmem<128>::kBytes;
}

// The same for the bf16 K7a (dkv = 0) and K7b (dkv = 1) kernels.
extern "C" long long dtt_flash_attention_chunk_bwd_smem(int D, int dkv) {
  if (dkv)
    return D == 32   ? (long long)DkvSmem<32>::kBytes
           : D == 64 ? (long long)DkvSmem<64>::kBytes
                     : (long long)DkvSmem<128>::kBytes;
  return D == 32   ? (long long)DqSmem<32>::kBytes
         : D == 64 ? (long long)DqSmem<64>::kBytes
                   : (long long)DqSmem<128>::kBytes;
}

// K6.  q [B, Sq, H, D], k, v [B, Sk, H, D] (strides in elements; last dim
// contiguous, rows 16-byte aligned), kv_mask int32 [B, Sk] or null;
// m_in, l_in [B*H, Sq] and acc_in [B*H, Sq, D] fp32 contiguous (acc
// 16-byte aligned); writes m_out, l_out, acc_out of the same shapes:
// distinct buffers, or the inputs themselves (all three: in place).
// dtype: 0 = fp32, 1 = bf16; D in {32, 64, 128}.  Returns
// cudaGetLastError().
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
// null, lse and delta fp32 [B*H, Sq].  K7a's out_a is dq fp32
// [B*H, Sq, D]; K7b's out_a and out_b are dk and dv fp32 [B*H, Sk, D]
// (contiguous, 16-byte aligned).  accumulate = 0: the partials are
// written there; 1: added to what they hold (old + partial, one fp32
// rounding), and rows that see no pair are not touched.  D in {32, 64,
// 128}.  Returns cudaGetLastError().
extern "C" int dtt_flash_attention_chunk_bwd(
    const void* q, const void* k, const void* v, const void* kv_mask,
    const void* dout, const void* lse, const void* delta, void* out_a,
    void* out_b, int B, int Sq, int Sk, int H, int D, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long dsb, long long dss,
    long long dsh, int q_off, int k_off, int causal, int window, float scale,
    int dtype, int dkv, int accumulate, void* stream) {
  // An empty chunk (Sk = 0) still gets its dq partial: zeros, or nothing
  // to add.
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
  p.accumulate = accumulate;
  return dispatch(p, dkv ? 2 : 1, D, dtype,
                  static_cast<cudaStream_t>(stream));
}
