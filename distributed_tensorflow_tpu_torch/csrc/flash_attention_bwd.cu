// Flash-attention backward (FlashAttention-2): dq, dk and dv from the saved
// per-row logsumexp, fp32 accumulation, gradients in the input dtype.
//
// Replaces: distributed_tensorflow_tpu/ops/pallas/flash_attention.py,
// _dkv_kernel (K2a) and _dq_kernel (K2b), both launched by _flash_backward.
// There the TPU walks the streamed blocks as the last, sequential grid axis
// and carries the fp32 dk/dv (or dq) accumulators in VMEM scratch.  Hopper
// blocks run in parallel and in no order, so here one thread block owns one
// tile and loops over the streamed tiles itself:
//   K2b (dq):  a block per (batch*head, Q tile) walks the K/V tiles it can
//              see, accumulating dQ;
//   K2a (dkv): a block per (batch*head, K tile) walks the Q/dO tiles that
//              can see it, accumulating dK and dV.
// The TPU's two-call split is kept: neither kernel needs atomics, so the
// gradients are deterministic, bit for bit from call to call.  K2b also
// computes delta = rowsum(dO * o) for its Q tile (the JAX code does it in
// XLA before both calls) and writes it out for K2a, so the dq call runs
// first.  The pair runs 7 products (K2b: S, dP, dQ; K2a: S, dP, dV, dK)
// where one fused pass would run 5.
//
// Bound on the H100: at the train shape (S = 1024, D = 128, causal) each
// product is 2 D flops per valid (q, k) pair against ~10 S D bytes of
// operands per head: the tensor cores bound K2a, K2b sits at the ridge.
//
// Design, bf16 (flash_bwd_dq_wgmma, flash_bwd_dkv_wgmma), K1's:
//   - A block is three warpgroups: a producer and two consumers, each
//     consumer owning 64 rows of the block's 128-row tile.  The producer
//     TMA-loads the block's own two tiles once (K2b: Q, dO; K2a: K, V),
//     then streams 64-row tile pairs (K2b: K, V; K2a: Q, dO) through a
//     ring of two stages on full/empty mbarriers, so the next pair is in
//     flight while the current one is multiplied.
//   - The products run on wgmma with fp32 accumulators in registers:
//     K2b: S = Q K^T and dP = dO V^T (m64n64k16, both operands K-major in
//          shared memory; at D = 32 the tiles take the 64-byte swizzle,
//          hopper.cuh), then dQ += dS K with dS from registers and K
//          MN-major (transpose-B);
//     K2a: the transposed form, own rows are keys: S^T = K Q^T and
//          dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q with P^T and
//          dS^T from registers.  P and dS are never a B operand, so
//          nothing is staged through shared memory: dK and dV (64 x D fp32
//          each) stay in the consumer's registers (setmaxnreg gives the
//          consumers 232 a thread).
//   - P = exp2(S * scale * log2(e) - lse * log2(e)) and dS = P (dP -
//     delta) in registers; the mask is applied before the exp, and only
//     on tiles where some pair can be invalid, so a masked pair gives an
//     exact zero and a fully masked row (lse ~ -1e30) exact zero
//     gradients, never inf * 0.  Rows past S are zeros from TMA and
//     contribute nothing (lse +inf for a streamed query past S).
//   - K2a's streamed queries need their lse and delta by column: a second
//     producer warp stages them (lse already in log2 units) into the
//     stage beside the Q/dO tiles and arrives on the same full barrier.
//   - Causal tiles above the diagonal and, with a window, tiles outside
//     the band are never visited.  K2b launches its heaviest (last) Q
//     tiles first, K2a its heaviest (first) K tiles.  q, k, v, o and dO
//     are read through their [B, S, H, D] strides, so the fused qkv
//     projection's slices need no copy; dq, dk and dv are written
//     contiguous.
//
// Head dims 32, 64 and 128; D = 32 takes the 64-byte swizzle, as K1 does
// (flash_attention.cu says why).
//
// fp32 inputs (on no main path) take the scalar kernel flash_bwd_f32:
// four warps per 64-row tile, S and dP through one fp32 shared scratch per
// warp, full fp32 precision.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"
#include "launch.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_mask;   // [B, S] int32, nonzero = attend; may be null
  const void* o;        // forward output (dq kernel only)
  const void* dout;     // gradient of the output
  const float* lse;     // [B*H, S]
  float* delta;         // [B*H, S]: written by the dq kernel, read by dkv
  void* out_a;          // dq (dq kernel) or dk (dkv kernel), [B, S, H, D]
  void* out_b;          // dv (dkv kernel)
  int B, S, H;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;   // elements
  long long osb, oss, osh, dsb, dss, dsh;
  int causal, window;
  float scale;
};

// ==== bf16: wgmma + TMA ======================================================

constexpr int kOwn = 128;          // rows of the block's own tile
constexpr int kStr = 64;           // rows of a streamed tile
constexpr int kStages = 2;
constexpr int kConsumers = 2;
constexpr int kThreadsW = 128 * (1 + kConsumers);

template <int D> struct BwdSmem {
  static constexpr int kOwnTile = kOwn * D * 2;
  static constexpr int kStrTile = kStr * D * 2;
  static constexpr int kStage = 2 * kStrTile;
  static constexpr int kStats = kStages * 2 * kStr * 4;   // lse2, delta
  static constexpr int kDelta = kOwn * 4;                 // dq: own delta
  static constexpr int kBarriers =
      2 * kOwnTile + kStages * kStage + kStats + kDelta;
  static constexpr size_t kBytes =
      1024 + kBarriers + (1 + 2 * kStages) * sizeof(uint64_t);
};

// The producer warpgroup: lane 0 of warp 0 issues the TMA copies, warp 1
// (K2a only) stages the streamed rows' lse (log2 units) and delta.
// `own_a`/`own_b` load once; streamed tile it covers rows str0(it).
template <int D, bool kStats>
__device__ __forceinline__ void produce(
    const CUtensorMap* own_a, const CUtensorMap* own_b,
    const CUtensorMap* str_a, const CUtensorMap* str_b, uint8_t* smem,
    uint64_t* bar_own, uint64_t* full, uint64_t* empty, float* stats,
    const Params& p, int b, int h, int own0, int st_begin, int n_tiles) {
  using G = BwdSmem<D>;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (warp == 0 && lane == 0) {
    dtt::mbar_expect_tx(bar_own, 2 * G::kOwnTile);
    dtt::tma_load_tile<D, kOwn>(smem, own_a, bar_own, h, own0, b);
    dtt::tma_load_tile<D, kOwn>(smem + G::kOwnTile, own_b, bar_own, h, own0,
                                b);
    uint8_t* stages = smem + 2 * G::kOwnTile;
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      dtt::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      dtt::mbar_expect_tx(&full[s], G::kStage);
      const int r0 = (st_begin + it) * kStr;
      uint8_t* st = stages + s * G::kStage;
      dtt::tma_load_tile<D, kStr>(st, str_a, &full[s], h, r0, b);
      dtt::tma_load_tile<D, kStr>(st + G::kStrTile, str_b, &full[s], h, r0,
                                  b);
    }
  } else if (kStats && warp == 1) {
    const long long row = (long long)(b * p.H + h) * p.S;
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      dtt::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      float* lse2 = stats + s * 2 * kStr;
      float* del = lse2 + kStr;
#pragma unroll
      for (int e = 0; e < kStr / 32; ++e) {
        const int i = lane + 32 * e;
        const int qpos = (st_begin + it) * kStr + i;
        const bool in = qpos < p.S;
        lse2[i] = in ? p.lse[row + qpos] * kLog2e : INFINITY;
        del[i] = in ? p.delta[row + qpos] : 0.f;
      }
      dtt::mbar_arrive(&full[s]);   // one arrival a lane, after its stores
    }
  }
}

template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           bf16* base, int row0, int S,
                                           int H, float scale, int col0) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = row0 + 8 * r;
    if (pos >= S) continue;
    bf16* dst = base + (long long)pos * H * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + col0) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * scale,
                                acc[4 * j + 2 * r + 1] * scale);
  }
}

// K2b: dq and delta.  Own: Q, dO; streamed: K, V.
template <int D>
__global__ void __launch_bounds__(kThreadsW, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo, Params p) {
  using G = BwdSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint8_t* Qs = smem;
  const uint8_t* dOs = smem + G::kOwnTile;
  const uint8_t* stages = smem + 2 * G::kOwnTile;
  float* delta_s = reinterpret_cast<float*>(smem + G::kBarriers - G::kDelta);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + G::kBarriers);
  uint64_t* bar_own = bar;
  uint64_t* full = bar + 1;
  uint64_t* empty = bar + 1 + kStages;

  const int S = p.S, H = p.H;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kOwn;   // heaviest first
  const int tid = threadIdx.x;

  // Key tiles that can hold a valid key for some row of this Q tile.
  const int q_last = min(S - 1, q0 + kOwn - 1);
  int st_begin = 0, st_end = (S + kStr - 1) / kStr;
  if (p.causal) {
    st_end = min(st_end, q_last / kStr + 1);
    if (p.window > 0 && q0 - p.window + 1 > 0)
      st_begin = (q0 - p.window + 1) / kStr;
  }
  const int n_tiles = st_end - st_begin;

  if (tid == 0) {
    dtt::mbar_init(bar_own, 1);
    for (int s = 0; s < kStages; ++s) {
      dtt::mbar_init(&full[s], 1);
      dtt::mbar_init(&empty[s], 4 * kConsumers);
    }
    dtt::mbar_fence_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 0) {
    dtt::regs_dec<40>();
    produce<D, false>(&tq, &tdo, &tk, &tv, smem, bar_own, full, empty,
                      nullptr, p, b, h, q0, st_begin, n_tiles);
    return;
  }

  dtt::regs_inc<232>();
  const int c = wg - 1;
  const int t = tid % 128, warp = t / 32, lane = t % 32;
  const int q_lo = q0 + 64 * c;
  const int row0 = q_lo + 16 * warp + lane / 4;   // and row0 + 8
  const int col0 = 2 * (lane % 4);
  const float cs = p.scale * kLog2e;
  const long long srow = (long long)bh * S;
  const int* kvm = p.kv_mask ? p.kv_mask + (long long)b * S : nullptr;

  // delta = rowsum(dO * o) in fp32 for this warp's 16 rows, read from
  // device memory (the swizzled dO tile is for the products).
  {
    const bf16* ob = static_cast<const bf16*>(p.o) + b * p.osb + h * p.osh;
    const bf16* db =
        static_cast<const bf16*>(p.dout) + b * p.dsb + h * p.dsh;
    for (int i = 0; i < 16; ++i) {
      const int r = 64 * c + 16 * warp + i, pos = q0 + r;
      float s = 0.f;
      if (pos < S) {
#pragma unroll
        for (int d = 2 * lane; d < D; d += 64) {
          const float2 x = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(ob + pos * p.oss + d));
          const float2 y = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(db + pos * p.dss + d));
          s = fmaf(x.x, y.x, fmaf(x.y, y.y, s));
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) {
        delta_s[r] = s;
        if (pos < S) p.delta[srow + pos] = s;
      }
    }
    __syncwarp();
  }
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = row0 + 8 * r;
    lse2[r] = pos < S ? p.lse[srow + pos] * kLog2e : INFINITY;
    dl[r] = delta_s[pos - q0];
  }

  float dq[D / 2];
  dtt::zero(dq);
  dtt::mbar_wait(bar_own, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int k0 = (st_begin + it) * kStr;
    const uint8_t* Ks = stages + s * G::kStage;
    const uint8_t* Vs = Ks + G::kStrTile;
    dtt::mbar_wait(&full[s], (it / kStages) & 1);

    float sc[kStr / 2], dp[kStr / 2];
    dtt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      dtt::wgmma_ss<kStr>(sc, dtt::tile_kmajor<D, kOwn>(Qs, 64 * c, kk),
                          dtt::tile_kmajor<D, kStr>(Ks, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      dtt::wgmma_ss<kStr>(dp, dtt::tile_kmajor<D, kOwn>(dOs, 64 * c, kk),
                          dtt::tile_kmajor<D, kStr>(Vs, 0, kk), kk > 0);
    dtt::wgmma_commit();
    dtt::wgmma_wait_all();
    dtt::fence_regs(sc);
    dtt::fence_regs(dp);

    const bool need_mask =
        kvm != nullptr ||
        (p.causal && (k0 + kStr - 1 > q_lo ||
                      (p.window > 0 && q_lo + 63 - k0 >= p.window)));
#pragma unroll
    for (int i = 0; i < kStr / 2; ++i) {
      const int r = (i / 2) % 2;
      bool ok = true;
      if (need_mask) {
        const int kpos = k0 + 8 * (i / 4) + col0 + i % 2;
        const int qpos = row0 + 8 * r;
        ok = kvm == nullptr || (kpos < S && kvm[kpos] != 0);
        if (p.causal) {
          ok = ok && qpos >= kpos;
          if (p.window > 0) ok = ok && qpos - kpos < p.window;
        }
      }
      const float pr = ok ? dtt::fast_exp2(fmaf(sc[i], cs, -lse2[r])) : 0.f;
      sc[i] = pr * (dp[i] - dl[r]);   // dS
    }

    uint32_t ds[kStr / 16][4];
#pragma unroll
    for (int kk = 0; kk < kStr / 16; ++kk) dtt::to_a_frag(sc, kk, ds[kk]);
    dtt::fence_frags(ds);
    dtt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kStr / 16; ++kk)
      dtt::wgmma_rs<D>(dq, ds[kk], dtt::tile_mnmajor<D, kStr>(Ks, kk), 1);
    dtt::wgmma_commit();
    dtt::wgmma_wait_all();
    dtt::fence_regs(dq);
    dtt::fence_frags(ds);
    __syncwarp();
    if (lane == 0) dtt::mbar_arrive(&empty[s]);
  }

  // dq = scale dS K: the scale folds in here.
  store_rows<D>(dq, static_cast<bf16*>(p.out_a) + ((long long)b * S * H + h) * D,
                row0, S, H, p.scale, col0);
}

// K2a: dk and dv.  Own: K, V; streamed: Q, dO (and their lse, delta).
template <int D>
__global__ void __launch_bounds__(kThreadsW, 1)
    flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo, Params p) {
  using G = BwdSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint8_t* Ks = smem;
  const uint8_t* Vs = smem + G::kOwnTile;
  const uint8_t* stages = smem + 2 * G::kOwnTile;
  float* stats = reinterpret_cast<float*>(smem + 2 * G::kOwnTile +
                                          kStages * G::kStage);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + G::kBarriers);
  uint64_t* bar_own = bar;
  uint64_t* full = bar + 1;
  uint64_t* empty = bar + 1 + kStages;

  const int S = p.S, H = p.H;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kOwn;      // causal: the first are heaviest
  const int tid = threadIdx.x;

  // Query tiles that can hold a valid query for some key of this tile:
  // q >= k, and with a window q <= k + window - 1.
  const int k_last = min(S - 1, k0 + kOwn - 1);
  const int n_q = (S + kStr - 1) / kStr;
  int st_begin = 0, st_end = n_q;
  if (p.causal) {
    st_begin = k0 / kStr;
    if (p.window > 0) st_end = min(n_q, (k_last + p.window - 1) / kStr + 1);
  }
  const int n_tiles = st_end - st_begin;

  if (tid == 0) {
    dtt::mbar_init(bar_own, 1);
    for (int s = 0; s < kStages; ++s) {
      dtt::mbar_init(&full[s], 1 + 32);   // TMA thread + the stats warp
      dtt::mbar_init(&empty[s], 4 * kConsumers);
    }
    dtt::mbar_fence_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 0) {
    dtt::regs_dec<40>();
    produce<D, true>(&tk, &tv, &tq, &tdo, smem, bar_own, full, empty, stats,
                     p, b, h, k0, st_begin, n_tiles);
    return;
  }

  dtt::regs_inc<232>();
  const int c = wg - 1;
  const int t = tid % 128, warp = t / 32, lane = t % 32;
  const int k_lo = k0 + 64 * c;
  const int row0 = k_lo + 16 * warp + lane / 4;   // key rows row0, row0 + 8
  const int col0 = 2 * (lane % 4);
  const float cs = p.scale * kLog2e;
  const int* kvm = p.kv_mask ? p.kv_mask + (long long)b * S : nullptr;
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    key_ok[r] = kvm == nullptr ||
                (row0 + 8 * r < S && kvm[row0 + 8 * r] != 0);

  float dk[D / 2], dv[D / 2];
  dtt::zero(dk);
  dtt::zero(dv);
  dtt::mbar_wait(bar_own, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int qs0 = (st_begin + it) * kStr;
    const uint8_t* Qt = stages + s * G::kStage;
    const uint8_t* dOt = Qt + G::kStrTile;
    const float* lse2 = stats + s * 2 * kStr;
    const float* del = lse2 + kStr;
    dtt::mbar_wait(&full[s], (it / kStages) & 1);

    float st[kStr / 2], dpt[kStr / 2];
    dtt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      dtt::wgmma_ss<kStr>(st, dtt::tile_kmajor<D, kOwn>(Ks, 64 * c, kk),
                          dtt::tile_kmajor<D, kStr>(Qt, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      dtt::wgmma_ss<kStr>(dpt, dtt::tile_kmajor<D, kOwn>(Vs, 64 * c, kk),
                          dtt::tile_kmajor<D, kStr>(dOt, 0, kk), kk > 0);
    dtt::wgmma_commit();
    dtt::wgmma_wait_all();
    dtt::fence_regs(st);
    dtt::fence_regs(dpt);

    const bool need_mask =
        kvm != nullptr ||
        (p.causal && (qs0 < k_lo + 63 ||
                      (p.window > 0 && qs0 + kStr - 1 - k_lo >= p.window)));
#pragma unroll
    for (int i = 0; i < kStr / 2; ++i) {
      const int r = (i / 2) % 2;
      const int col = 8 * (i / 4) + col0 + i % 2;
      bool ok = true;
      if (need_mask) {
        const int kpos = row0 + 8 * r, qpos = qs0 + col;
        ok = key_ok[r];
        if (p.causal) {
          ok = ok && qpos >= kpos;
          if (p.window > 0) ok = ok && qpos - kpos < p.window;
        }
      }
      const float pr = ok ? dtt::fast_exp2(fmaf(st[i], cs, -lse2[col])) : 0.f;
      st[i] = pr;                          // P^T
      dpt[i] = pr * (dpt[i] - del[col]);   // dS^T
    }

    uint32_t pa[kStr / 16][4], da[kStr / 16][4];
#pragma unroll
    for (int kk = 0; kk < kStr / 16; ++kk) {
      dtt::to_a_frag(st, kk, pa[kk]);
      dtt::to_a_frag(dpt, kk, da[kk]);
    }
    dtt::fence_frags(pa);
    dtt::fence_frags(da);
    dtt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kStr / 16; ++kk)
      dtt::wgmma_rs<D>(dv, pa[kk], dtt::tile_mnmajor<D, kStr>(dOt, kk), 1);
#pragma unroll
    for (int kk = 0; kk < kStr / 16; ++kk)
      dtt::wgmma_rs<D>(dk, da[kk], dtt::tile_mnmajor<D, kStr>(Qt, kk), 1);
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
  const long long base = ((long long)b * S * H + h) * D;
  store_rows<D>(dk, static_cast<bf16*>(p.out_a) + base, row0, S, H, p.scale,
                col0);
  store_rows<D>(dv, static_cast<bf16*>(p.out_b) + base, row0, S, H, 1.f,
                col0);
}

template <int D, bool kDKV>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  // The own tiles are 128-row boxes, the streamed ones 64-row boxes.
  const int rq = kDKV ? kStr : kOwn, rk = kDKV ? kOwn : kStr;
  cudaError_t e;
  if ((e = dtt::make_tile_map(&tq, p.q, p.B, p.S, p.H, D, p.qsb, p.qss,
                              p.qsh, rq)) != cudaSuccess ||
      (e = dtt::make_tile_map(&tk, p.k, p.B, p.S, p.H, D, p.ksb, p.kss,
                              p.ksh, rk)) != cudaSuccess ||
      (e = dtt::make_tile_map(&tv, p.v, p.B, p.S, p.H, D, p.vsb, p.vss,
                              p.vsh, rk)) != cudaSuccess ||
      (e = dtt::make_tile_map(&tdo, p.dout, p.B, p.S, p.H, D, p.dsb, p.dss,
                              p.dsh, rq)) != cudaSuccess)
    return e;
  constexpr size_t smem = BwdSmem<D>::kBytes;
  auto kernel = kDKV ? flash_bwd_dkv_wgmma<D> : flash_bwd_dq_wgmma<D>;
  static bool done[dtt::kMaxDevices];
  if ((e = dtt::opt_in_smem(kernel, smem, done)) != cudaSuccess) return e;
  dim3 grid(p.B * p.H, (p.S + kOwn - 1) / kOwn);
  kernel<<<grid, kThreadsW, smem, stream>>>(tq, tk, tv, tdo, p);
  return cudaGetLastError();
}

// ==== fp32: the scalar kernel ================================================

constexpr int BT = 64;         // rows of the own tile and of each streamed tile
constexpr int kWarps = 4;      // 16 own rows each
constexpr int kThreads = kWarps * 32;

// Shared-memory geometry: rows padded by one element (operand tiles) or
// four (P / dS; the fp32 S and dP scratch aliases the dS tile).
template <int D> struct Geo {
  static constexpr int LD = D + 1;       // operand tiles
  static constexpr int LDP = BT + 4;     // P, dS and the S / dP scratch
  static constexpr int LDS = LDP;
  static constexpr size_t kTile = sizeof(float) * (size_t)BT * LD;
  static constexpr size_t kPS = sizeof(float) * (size_t)BT * LDP;
  static constexpr size_t kInfo = (4 * sizeof(float) + 2 * sizeof(int)) * BT;
  static constexpr size_t kBytes = 4 * kTile + 2 * kPS + kInfo;
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

// C[16 x 64] = A[16 x D] . B[64 x D]^T for this warp's rows.
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

  __device__ __forceinline__ void store(float* out, long long pitch,
                                        int pos0, int S, float scale,
                                        int lane) {
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      if (pos0 + rr >= S) break;
#pragma unroll
      for (int j = 0; j < J; ++j)
        out[(long long)(pos0 + rr) * pitch + lane + 32 * j] =
            f[rr][j] * scale;
    }
  }
};

// kDKV = true: K2a (own tile = keys, streamed = queries) -> dk, dv.
// kDKV = false: K2b (own tile = queries, streamed = keys) -> dq, delta.
template <int D, bool kDKV>
__global__ void __launch_bounds__(kThreads) flash_bwd_f32(Params p) {
  using G = Geo<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* own1 = reinterpret_cast<float*>(smem);
  float* own2 = reinterpret_cast<float*>(smem + G::kTile);
  float* str1 = reinterpret_cast<float*>(smem + 2 * G::kTile);
  float* str2 = reinterpret_cast<float*>(smem + 3 * G::kTile);
  float* Ps = reinterpret_cast<float*>(smem + 4 * G::kTile);
  float* dSs = reinterpret_cast<float*>(smem + 4 * G::kTile + G::kPS);
  float* Sc = dSs;
  float* own_lse = reinterpret_cast<float*>(smem + 4 * G::kTile + 2 * G::kPS);
  float* own_delta = own_lse + BT;
  float* str_lse = own_delta + BT;
  float* str_delta = str_lse + BT;
  int* own_ok = reinterpret_cast<int*>(str_delta + BT);
  int* str_ok = own_ok + BT;

  const int S = p.S, H = p.H;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int own0 = blockIdx.x * BT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row0 = (long long)bh * S;   // lse / delta row base
  const float* qb = static_cast<const float*>(p.q) + b * p.qsb + h * p.qsh;
  const float* kb = static_cast<const float*>(p.k) + b * p.ksb + h * p.ksh;
  const float* vb = static_cast<const float*>(p.v) + b * p.vsb + h * p.vsh;
  const float* db =
      static_cast<const float*>(p.dout) + b * p.dsb + h * p.dsh;

  if (kDKV) {
    load_tile<D>(own1, kb, p.kss, own0, S);
    load_tile<D>(own2, vb, p.vss, own0, S);
  } else {
    load_tile<D>(own1, qb, p.qss, own0, S);
    load_tile<D>(own2, db, p.dss, own0, S);
  }
  for (int i = tid; i < BT; i += kThreads) {
    const int pos = own0 + i;
    const bool in = pos < S;
    if (kDKV) {
      own_ok[i] = in && (p.kv_mask == nullptr || p.kv_mask[b * S + pos]);
    } else {
      own_ok[i] = in;
      own_lse[i] = in ? p.lse[row0 + pos] : 0.f;
    }
  }
  __syncthreads();

  if (!kDKV) {
    // delta = rowsum(dO * o) for this warp's 16 query rows, fp32.
    const float* ob = static_cast<const float*>(p.o) + b * p.osb + h * p.osh;
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr, pos = own0 + r;
      float s = 0.f;
      if (pos < S)
        for (int d = lane; d < D; d += 32)
          s += own2[r * G::LD + d] * ob[pos * p.oss + d];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) {
        own_delta[r] = s;
        if (pos < S) p.delta[row0 + pos] = s;
      }
    }
    __syncwarp();
  }

  // Streamed tiles that can hold a valid pair for some own row.
  const int own_last = min(S - 1, own0 + BT - 1);
  const int n_tiles = (S + BT - 1) / BT;
  int st_begin = 0, st_end = n_tiles;
  if (p.causal) {
    if (kDKV) {
      // queries q >= k, and with a window q <= k + window - 1
      st_begin = own0 / BT;
      if (p.window > 0)
        st_end = min(n_tiles, (own_last + p.window - 1) / BT + 1);
    } else {
      // keys k <= q, and with a window k >= q - window + 1
      st_end = min(n_tiles, own_last / BT + 1);
      if (p.window > 0) {
        const int lo = own0 - p.window + 1;
        if (lo > 0) st_begin = lo / BT;
      }
    }
  }

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
      load_tile<D>(str1, qb, p.qss, str0, S);
      load_tile<D>(str2, db, p.dss, str0, S);
    } else {
      load_tile<D>(str1, kb, p.kss, str0, S);
      load_tile<D>(str2, vb, p.vss, str0, S);
    }
    if (tid < BT) {
      const int pos = str0 + tid;
      const bool in = pos < S;
      if (kDKV) {
        str_ok[tid] = in;
        str_lse[tid] = in ? p.lse[row0 + pos] : 0.f;
        str_delta[tid] = in ? p.delta[row0 + pos] : 0.f;
      } else {
        str_ok[tid] =
            in && (p.kv_mask == nullptr || p.kv_mask[b * S + pos]);
      }
    }
    __syncthreads();

    // S slice, then P = exp(scale S - lse) on valid pairs (0 elsewhere).
    // Lane handles columns lane and lane + 32 of every row of the slice.
    mm_nt<D>(own1_w, str1, Sc_w, lane);
    __syncwarp();
    float pr[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = i >> 1, c = (i & 1) * 32 + lane;
      const int orow = warp * 16 + r;
      const int opos = own0 + orow, spos = str0 + c;
      const int qpos = kDKV ? spos : opos, kpos = kDKV ? opos : spos;
      bool valid = own_ok[orow] && str_ok[c];
      if (p.causal) {
        valid = valid && qpos >= kpos;
        if (p.window > 0) valid = valid && qpos - kpos < p.window;
      }
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
  const long long pitch = (long long)H * D;
  const int pos0 = own0 + warp * 16;
  float* out_a = static_cast<float*>(p.out_a) + ((long long)b * S * H + h) * D;
  acc_a.store(out_a, pitch, pos0, S, p.scale, lane);
  if (kDKV) {
    float* out_b =
        static_cast<float*>(p.out_b) + ((long long)b * S * H + h) * D;
    acc_b.store(out_b, pitch, pos0, S, 1.f, lane);
  }
}

template <int D, bool kDKV>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Geo<D>::kBytes;
  static bool done[dtt::kMaxDevices];
  const cudaError_t e = dtt::opt_in_smem(flash_bwd_f32<D, kDKV>, smem, done);
  if (e != cudaSuccess) return e;
  dim3 grid((p.S + BT - 1) / BT, p.B * p.H);
  flash_bwd_f32<D, kDKV><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kDKV>
int dispatch(const Params& p, int D, int dtype, cudaStream_t s) {
  if (dtype == 1 && D == 128) return (int)launch_wgmma<128, kDKV>(p, s);
  if (dtype == 1 && D == 64) return (int)launch_wgmma<64, kDKV>(p, s);
  if (dtype == 1 && D == 32) return (int)launch_wgmma<32, kDKV>(p, s);
  if (dtype == 0 && D == 128) return (int)launch_f32<128, kDKV>(p, s);
  if (dtype == 0 && D == 64) return (int)launch_f32<64, kDKV>(p, s);
  if (dtype == 0 && D == 32) return (int)launch_f32<32, kDKV>(p, s);
  return (int)cudaErrorInvalidValue;
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* kv_mask, const void* o, const void* dout,
                   const void* lse, void* delta, void* out_a, void* out_b,
                   int B, int S, int H, const long long* st, int causal,
                   int window, float scale) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.kv_mask = static_cast<const int*>(kv_mask);
  p.o = o;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.out_a = out_a;
  p.out_b = out_b;
  p.B = B;
  p.S = S;
  p.H = H;
  p.qsb = st[0]; p.qss = st[1]; p.qsh = st[2];
  p.ksb = st[3]; p.kss = st[4]; p.ksh = st[5];
  p.vsb = st[6]; p.vss = st[7]; p.vsh = st[8];
  p.osb = st[9]; p.oss = st[10]; p.osh = st[11];
  p.dsb = st[12]; p.dss = st[13]; p.dsh = st[14];
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  return p;
}

}  // namespace

// Dynamic shared memory of the bf16 kernels at head_dim D (both use the
// same layout; for reports).
extern "C" long long dtt_flash_attention_bwd_smem(int D) {
  return D == 32   ? (long long)BwdSmem<32>::kBytes
         : D == 64 ? (long long)BwdSmem<64>::kBytes
                   : (long long)BwdSmem<128>::kBytes;
}

// Both entry points take the same arguments.  dtype: 0 = fp32, 1 = bf16;
// D in {32, 64, 128}.  Strides (batch, seq, head) of q, k, v, o and dout, in
// elements; the last dim must be contiguous and the base and every stride
// 16-byte aligned (the Python wrapper checks).  kv_mask is int32 [B, S] or
// null.  lse and delta are fp32 [B*H, S]; outputs are contiguous
// [B, S, H, D] in the input dtype.  Launch on the current device; return
// cudaGetLastError().
//
// dq:  reads q, k, v, o, dout, lse; writes delta and out_a = dq (out_b
//      unused).  Run it first.
// dkv: reads q, k, v, dout, lse, delta; writes out_a = dk, out_b = dv (o
//      unused).
extern "C" int dtt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* kv_mask,
    const void* o, const void* dout, const void* lse, void* delta,
    void* out_a, void* out_b, int B, int S, int H, int D, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb, long long oss,
    long long osh, long long dsb, long long dss, long long dsh, int causal,
    int window, float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaSuccess;
  const long long st[15] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
                            vsh, osb, oss, osh, dsb, dss, dsh};
  Params p = make_params(q, k, v, kv_mask, o, dout, lse, delta, out_a, out_b,
                         B, S, H, st, causal, window, scale);
  return dispatch<false>(p, D, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int dtt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* kv_mask,
    const void* o, const void* dout, const void* lse, void* delta,
    void* out_a, void* out_b, int B, int S, int H, int D, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb, long long oss,
    long long osh, long long dsb, long long dss, long long dsh, int causal,
    int window, float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaSuccess;
  const long long st[15] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
                            vsh, osb, oss, osh, dsb, dss, dsh};
  Params p = make_params(q, k, v, kv_mask, o, dout, lse, delta, out_a, out_b,
                         B, S, H, st, causal, window, scale);
  return dispatch<true>(p, D, dtype, static_cast<cudaStream_t>(stream));
}
