// Flash-attention forward: blockwise online softmax, fp32 statistics,
// output in the input dtype plus the per-row logsumexp (natural log).
//
// Replaces: distributed_tensorflow_tpu/ops/pallas/flash_attention.py,
// _kernel (launched by _flash_forward).  There the TPU walks the K blocks
// as the last, sequential grid axis and carries (m, l, acc) in VMEM
// scratch between grid steps.  Hopper blocks run in parallel and in no
// order, so here one thread block owns one (batch*head, Q tile) and loops
// over the K/V tiles itself.
//
// Bound on the H100: at the train shape (B=8, S=1024, H=16, D=128,
// causal) the work is 4 D flops per valid (q, k) pair (two products), ~2
// S^2 D per head, against 8 S D bytes of q/k/v/o per head: ~S/4 flops per
// byte, just under the ~295 flop/byte bf16 ridge at S = 1024 and far under
// it for the serving prompts, so bytes set the bound, with the tensor-core
// time close behind at the train shape.  Reaching either needs
// the products on wgmma (the only path to the full tensor-core rate), the
// operands streamed in while the previous tile is multiplied, and nothing
// of the running sums spilled to shared memory.
//
// Design, bf16 (flash_fwd_wgmma):
//   - A block is three warpgroups: a producer and two consumers, each
//     consumer owning 64 rows of the block's 128-row Q tile.  The producer
//     gives registers back (setmaxnreg) and one of its threads issues TMA
//     copies: the Q tile once, then each 128-row K and V tile into a ring
//     of two stages, each stage's arrival signalled on a "full" mbarrier;
//     the consumers release a stage on its "empty" mbarrier once their
//     products have read it.  So tile j + 1 is in flight while tile j is
//     multiplied, and the two consumers run unsynchronised, one's softmax
//     overlapping the other's products.
//   - S = Q K^T is wgmma m64n128k16 with Q and K K-major in shared memory
//     (128-byte swizzle, 64-byte at D = 32, see hopper.cuh), into 64 fp32
//     registers a thread.
//   - The online softmax runs on those registers: a row's 32 values of a
//     thread are reduced locally, then across the row's 4 lanes with two
//     shuffles; exp2 with scale * log2(e) folded into one FMA; the running
//     max and sum stay in registers; lse is converted back to natural log.
//   - O += P V takes P from registers as the A operand (the accumulator
//     rounded to bf16 pairs is already the A fragment) and V MN-major from
//     shared memory (transpose-B), into a D-wide fp32 accumulator in
//     registers.  No score, probability or output tile lives in shared
//     memory.
//   - Masks (causal diagonal, ragged tail, kv_mask, window edge) are
//     evaluated only on the tiles where some pair can be invalid; causal
//     tiles above the diagonal and window tiles below the band are never
//     loaded.  TMA reads rows past S as zeros, so any S needs no load
//     predicate.
//   - Scheduling: the Q tile is 128 rows for every shape (one block fills
//     an SM's shared memory: Q 32 KB + two 64 KB K/V stages at D = 128).
//     Grid (B*H, tiles), and the tile index runs backwards, so the first
//     wave launches every head's heaviest (last, causal) tile.  At the
//     serving prefill (B=1, S=784: 112 blocks on 132 SMs) a 64-row tile
//     would give 208 blocks of one consumer each, but the critical path,
//     one warpgroup's 64 rows against all keys, is the same, and a second
//     wave would lengthen it.
//   - q, k and v are read through their [B, S, H, D] strides (TMA tensor
//     maps over the 4-D view), so the fused qkv projection's slices need
//     no copy.
//
// Head dims 32, 64 and 128.  At D = 32 a bf16 row is 64 bytes, too narrow
// for the 128-byte swizzle: the tiles take the 64-byte one (a TMA map with
// SWIZZLE_64B and the wgmma descriptor's 64-byte layout, hopper.cuh), so
// QK^T runs two k-steps of 16 and PV is m64n32k16.  The other route, a
// 64-column box over the 32-column tensor, would double every product.
//
// fp32 inputs (on no main path) take the scalar kernel flash_fwd_f32,
// which keeps full fp32 precision: one block of four warps per 64-row Q
// tile, (m, l, acc) in shared memory.
//
// Masked probabilities are exactly 0.  A row with no valid key ends with
// l = 0 and writes zeros, with lse = -1e30, as the plain version gives.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"
#include "launch.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_mask;   // [B, S] int32, nonzero = attend; may be null
  void* out;            // [B, S, H, D] contiguous, input dtype
  float* lse;           // [B*H, S]
  int B, S, H;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;   // elements
  int causal, window;
  float scale;
};

// ==== bf16: wgmma + TMA ======================================================

constexpr int kBQ = 128;           // Q rows per block (two consumers)
constexpr int kBK = 128;           // K/V rows per tile
constexpr int kStages = 2;
constexpr int kConsumers = 2;
constexpr int kThreadsW = 128 * (1 + kConsumers);

template <int D> struct FwdSmem {
  static constexpr int kQ = kBQ * D * 2;          // bytes of the Q tile
  static constexpr int kKV = kBK * D * 2;         // bytes of a K or V tile
  static constexpr int kStage = 2 * kKV;
  static constexpr int kBarriers = kQ + kStages * kStage;
  // + 1 KB so the tiles can start on a 1024-byte boundary.
  static constexpr size_t kBytes =
      1024 + kBarriers + (1 + 2 * kStages) * sizeof(uint64_t);
};

template <int D>
__global__ void __launch_bounds__(kThreadsW, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, Params p) {
  using G = FwdSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = smem;
  uint8_t* KVs = smem + G::kQ;   // stage s: K at s * kStage, V after it
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + G::kBarriers);
  uint64_t* bar_q = bar;
  uint64_t* full = bar + 1;
  uint64_t* empty = bar + 1 + kStages;

  const int S = p.S, H = p.H;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heaviest first
  const int tid = threadIdx.x;

  // K tiles that can hold a valid key for some row of this Q tile.
  const int q_last = min(S - 1, q0 + kBQ - 1);
  int kt_begin = 0, kt_end = (S + kBK - 1) / kBK;
  if (p.causal) {
    kt_end = min(kt_end, q_last / kBK + 1);
    if (p.window > 0 && q0 - p.window + 1 > 0)
      kt_begin = (q0 - p.window + 1) / kBK;
  }
  const int n_tiles = kt_end - kt_begin;

  if (tid == 0) {
    dtt::mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      dtt::mbar_init(&full[s], 1);
      dtt::mbar_init(&empty[s], 4 * kConsumers);   // one arrival a warp
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
      dtt::tma_load_tile<D, kBQ>(Qs, &tq, bar_q, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        dtt::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        dtt::mbar_expect_tx(&full[s], G::kStage);
        const int k0 = (kt_begin + it) * kBK;
        uint8_t* st = KVs + s * G::kStage;
        dtt::tma_load_tile<D, kBK>(st, &tk, &full[s], h, k0, b);
        dtt::tma_load_tile<D, kBK>(st + G::kKV, &tv, &full[s], h, k0, b);
      }
    }
    return;
  }

  // ---- consumers ----
  dtt::regs_inc<232>();
  const int c = wg - 1;                   // 64-row half of the Q tile
  const int t = tid % 128, warp = t / 32, lane = t % 32;
  const int q_lo = q0 + 64 * c;
  const int row0 = q_lo + 16 * warp + lane / 4;   // and row0 + 8
  const int col0 = 2 * (lane % 4);
  const float cs = p.scale * kLog2e;      // raw score -> log2 units
  const int* kvm = p.kv_mask ? p.kv_mask + (long long)b * S : nullptr;

  float o[D / 2];
  dtt::zero(o);
  float m[2] = {-INFINITY, -INFINITY};    // running max, raw units
  float l[2] = {0.f, 0.f};                // this thread's partial sums

  dtt::mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int k0 = (kt_begin + it) * kBK;
    const uint8_t* Ks = KVs + s * G::kStage;
    const uint8_t* Vs = Ks + G::kKV;
    dtt::mbar_wait(&full[s], (it / kStages) & 1);

    float sc[kBK / 2];
    dtt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      dtt::wgmma_ss<kBK>(sc, dtt::tile_kmajor<D, kBQ>(Qs, 64 * c, kk),
                         dtt::tile_kmajor<D, kBK>(Ks, 0, kk), kk > 0);
    dtt::wgmma_commit();
    dtt::wgmma_wait_all();
    dtt::fence_regs(sc);

    // Masks, only where some pair of this warpgroup's rows can be invalid.
    const bool need_mask =
        kvm != nullptr || k0 + kBK > S ||
        (p.causal && (k0 + kBK - 1 > q_lo ||
                      (p.window > 0 && q_lo + 63 - k0 >= p.window)));
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * j + col0 + e;
          bool kv_ok = kpos < S;
          if (kvm != nullptr && kv_ok) kv_ok = kvm[kpos] != 0;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int qpos = row0 + 8 * r;
            bool ok = kv_ok;
            if (p.causal) {
              ok = ok && qpos >= kpos;
              if (p.window > 0) ok = ok && qpos - kpos < p.window;
            }
            if (!ok) sc[4 * j + 2 * r + e] = -INFINITY;
          }
        }
      }
    }

    // Online softmax on the registers (row r of this thread: the values
    // with (i / 2) % 2 == r).
    float corr[2], mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // A row with no valid key so far keeps max -inf: nothing to rescale,
      // and every probability is exp2(-inf) = 0.
      corr[r] = mx == -INFINITY ? 1.f : dtt::fast_exp2((m[r] - mx) * cs);
      mc[r] = mx == -INFINITY ? 0.f : mx * cs;
      m[r] = mx;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const int r = (i / 2) % 2;
      sc[i] = dtt::fast_exp2(fmaf(sc[i], cs, -mc[r]));
      rs[r] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i / 2) % 2];

    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) dtt::to_a_frag(sc, kk, pa[kk]);
    dtt::fence_frags(pa);
    dtt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      dtt::wgmma_rs<D>(o, pa[kk], dtt::tile_mnmajor<D, kBK>(Vs, kk), 1);
    dtt::wgmma_commit();
    dtt::wgmma_wait_all();
    dtt::fence_regs(o);
    dtt::fence_frags(pa);
    __syncwarp();
    if (lane == 0) dtt::mbar_arrive(&empty[s]);
  }

  // Epilogue: the row sums across the row's 4 lanes, then out = o / l.
  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qpos = row0 + 8 * r;
    if (qpos >= S) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    bf16* orow = out + (((long long)b * S + qpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col0) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                o[4 * j + 2 * r + 1] * inv);
    if (lane % 4 == 0)
      p.lse[(long long)bh * S + qpos] =
          l[r] > 0.f ? m[r] * p.scale + log2f(l[r]) * kLn2 : kNeg;
  }
}

template <int D>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t e;
  if ((e = dtt::make_tile_map(&tq, p.q, p.B, p.S, p.H, D, p.qsb, p.qss,
                              p.qsh, kBQ)) != cudaSuccess ||
      (e = dtt::make_tile_map(&tk, p.k, p.B, p.S, p.H, D, p.ksb, p.kss,
                              p.ksh, kBK)) != cudaSuccess ||
      (e = dtt::make_tile_map(&tv, p.v, p.B, p.S, p.H, D, p.vsb, p.vss,
                              p.vsh, kBK)) != cudaSuccess)
    return e;
  constexpr size_t smem = FwdSmem<D>::kBytes;
  static bool done[dtt::kMaxDevices];
  if ((e = dtt::opt_in_smem(flash_fwd_wgmma<D>, smem, done)) != cudaSuccess)
    return e;
  dim3 grid(p.B * p.H, (p.S + kBQ - 1) / kBQ);
  flash_fwd_wgmma<D><<<grid, kThreadsW, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

// ==== fp32: the scalar kernel ================================================

constexpr int BQ = 64;         // Q rows per block
constexpr int BK = 64;         // K/V rows per tile
constexpr int kWarps = 4;      // 16 Q rows each
constexpr int kThreads = kWarps * 32;

// Shared-memory geometry; rows padded by one element for conflict-free
// column reads.
template <int D> struct Geo {
  static constexpr int LD = D + 1;       // Q, K, V tiles
  static constexpr int LDS = BK + 4;     // scores
  static constexpr int LDP = BK + 4;     // probabilities
  static constexpr int LDO = D + 4;      // accumulator
  static constexpr size_t kQKV = sizeof(float) * (size_t)BQ * LD;
  static constexpr size_t kS = sizeof(float) * (size_t)BQ * LDS;
  static constexpr size_t kP = sizeof(float) * (size_t)BQ * LDP;
  static constexpr size_t kO = sizeof(float) * (size_t)BQ * LDO;
  static constexpr size_t kBytes =
      3 * kQKV + kS + kP + kO + 2 * sizeof(float) * BQ + sizeof(int) * BK;
};

// Rows [row0, row0 + 64) of one head into shared memory, 16 bytes per
// load; rows at or past S read as zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          long long row_stride, int row0,
                                          int S) {
  constexpr int kChunks = D / 4;
  constexpr int LD = Geo<D>::LD;
  for (int c = threadIdx.x; c < BQ * kChunks; c += kThreads) {
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

// S = Q K^T for this warp's 16 rows.
template <int D>
__device__ __forceinline__ void scores_f32(const float* Qs, const float* Ks,
                                           float* Ss, int warp, int lane) {
  using G = Geo<D>;
  float a0[16], a1[16];
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) a0[rr] = a1[rr] = 0.f;
  const float* q = Qs + (warp * 16) * G::LD;
  for (int d = 0; d < D; ++d) {
    const float k0 = Ks[lane * G::LD + d];
    const float k1 = Ks[(lane + 32) * G::LD + d];
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const float qv = q[rr * G::LD + d];
      a0[rr] = fmaf(qv, k0, a0[rr]);
      a1[rr] = fmaf(qv, k1, a1[rr]);
    }
  }
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    Ss[(warp * 16 + rr) * G::LDS + lane] = a0[rr];
    Ss[(warp * 16 + rr) * G::LDS + lane + 32] = a1[rr];
  }
}

// O += P V for this warp's 16 rows.
template <int D>
__device__ __forceinline__ void pv_f32(const float* Ps, const float* Vs,
                                       float* Os, int warp, int lane) {
  using G = Geo<D>;
  constexpr int J = D / 32;
  float acc[16][J];
#pragma unroll
  for (int rr = 0; rr < 16; ++rr)
#pragma unroll
    for (int j = 0; j < J; ++j)
      acc[rr][j] = Os[(warp * 16 + rr) * G::LDO + lane + 32 * j];
  for (int kk = 0; kk < BK; ++kk) {
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

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(Params p) {
  using G = Geo<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = reinterpret_cast<float*>(smem + G::kQKV);
  float* Vs = reinterpret_cast<float*>(smem + 2 * G::kQKV);
  float* Ss = reinterpret_cast<float*>(smem + 3 * G::kQKV);
  float* Ps = reinterpret_cast<float*>(smem + 3 * G::kQKV + G::kS);
  float* Os = reinterpret_cast<float*>(smem + 3 * G::kQKV + G::kS + G::kP);
  float* m_s = Os + BQ * G::LDO;
  float* l_s = m_s + BQ;
  int* mask_s = reinterpret_cast<int*>(l_s + BQ);

  const int S = p.S, H = p.H;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* qb = static_cast<const float*>(p.q) + b * p.qsb + h * p.qsh;
  const float* kb = static_cast<const float*>(p.k) + b * p.ksb + h * p.ksh;
  const float* vb = static_cast<const float*>(p.v) + b * p.vsb + h * p.vsh;

  load_tile<D>(Qs, qb, p.qss, q0, S);
  for (int i = tid; i < BQ * G::LDO; i += kThreads) Os[i] = 0.f;
  for (int i = tid; i < BQ; i += kThreads) {
    m_s[i] = kNeg;
    l_s[i] = 0.f;
  }

  // K tiles that can hold a valid key for some row of this Q tile.
  const int q_last = min(S - 1, q0 + BQ - 1);
  int kt_begin = 0, kt_end = (S + BK - 1) / BK;
  if (p.causal) {
    kt_end = min(kt_end, q_last / BK + 1);
    if (p.window > 0) {
      const int lo = q0 - p.window + 1;   // oldest key the first row sees
      if (lo > 0) kt_begin = lo / BK;
    }
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // every warp is done with the previous K/V tile
    load_tile<D>(Ks, kb, p.kss, k0, S);
    load_tile<D>(Vs, vb, p.vss, k0, S);
    if (tid < BK) {
      const int s = k0 + tid;
      mask_s[tid] = s < S && (p.kv_mask == nullptr || p.kv_mask[b * S + s]);
    }
    __syncthreads();

    scores_f32<D>(Qs, Ks, Ss, warp, lane);
    __syncwarp();

    // Online softmax: lanes 2i and 2i + 1 of warp w own row 16w + i, 32 of
    // the tile's 64 columns each.
    {
      const int r = warp * 16 + (lane >> 1);
      const int half = lane & 1;
      const int qpos = q0 + r;
      float sv[32];
      unsigned ok = 0u;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = half * 32 + ((j + lane) & 31), kpos = k0 + c;
        bool valid = mask_s[c] != 0;
        if (p.causal) {
          valid = valid && qpos >= kpos;
          if (p.window > 0) valid = valid && qpos - kpos < p.window;
        }
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
    pv_f32<D>(Ps, Vs, Os, warp, lane);
  }
  __syncthreads();

  float* out = static_cast<float*>(p.out);
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
    const int qpos = q0 + r;
    if (qpos >= S) break;
    const float l = fmaxf(l_s[r], 1e-30f);
    float* orow = out + (((long long)b * S + qpos) * H + h) * D;
    for (int d = lane; d < D; d += 32) orow[d] = Os[r * G::LDO + d] / l;
    if (lane == 0) p.lse[(long long)bh * S + qpos] = m_s[r] + logf(l);
  }
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Geo<D>::kBytes;
  static bool done[dtt::kMaxDevices];
  const cudaError_t e = dtt::opt_in_smem(flash_fwd_f32<D>, smem, done);
  if (e != cudaSuccess) return e;
  dim3 grid((p.S + BQ - 1) / BQ, p.B * p.H);
  flash_fwd_f32<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of the bf16 kernel at head_dim D (for reports).
extern "C" long long dtt_flash_attention_fwd_smem(int D) {
  return D == 32   ? (long long)FwdSmem<32>::kBytes
         : D == 64 ? (long long)FwdSmem<64>::kBytes
                   : (long long)FwdSmem<128>::kBytes;
}

// dtype: 0 = fp32, 1 = bf16.  D in {32, 64, 128}.  Strides in elements; the
// last dim must be contiguous and the base and every stride 16-byte
// aligned (the Python wrapper checks).  Launches on the current device;
// returns cudaGetLastError().
extern "C" int dtt_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* kv_mask,
    void* out, void* lse, int B, int S, int H, int D, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int causal, int window,
    float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaSuccess;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.kv_mask = static_cast<const int*>(kv_mask);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.S = S;
  p.H = H;
  p.qsb = qsb; p.qss = qss; p.qsh = qsh;
  p.ksb = ksb; p.kss = kss; p.ksh = ksh;
  p.vsb = vsb; p.vss = vss; p.vsh = vsh;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 128) return (int)launch_wgmma<128>(p, s);
  if (dtype == 1 && D == 64) return (int)launch_wgmma<64>(p, s);
  if (dtype == 1 && D == 32) return (int)launch_wgmma<32>(p, s);
  if (dtype == 0 && D == 128) return (int)launch_f32<128>(p, s);
  if (dtype == 0 && D == 64) return (int)launch_f32<64>(p, s);
  if (dtype == 0 && D == 32) return (int)launch_f32<32>(p, s);
  return (int)cudaErrorInvalidValue;
}
