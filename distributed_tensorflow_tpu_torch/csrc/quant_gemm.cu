// K4 (the int8 MLP's quantize-matmul forward), K5 (its NT dgrad) and K8
// (the TN dgrad against a re-quantized w.T) as two kernels each: a
// quantize pass over the activations, then a block-scaled int8 GEMM on
// wgmma.
//
// Replaces: distributed_tensorflow_tpu/ops/pallas/quant_matmul.py,
// _qmm_kernel (launched by quantized_matmul), _qmm_nt_kernel (launched
// by quantized_matmul_nt) and _qmm_dgelu_kernel (launched by
// quantized_matmul_dgelu).  There the TPU walks the K-blocks as the last,
// sequential grid axis and quantizes each (bm, bk) block of the
// activations in VMEM right before its product.
//
// The function (identical to the plain versions in ops/quant_matmul.py):
//   A, per row m and K-block kb of width bk (a power of two, 128..1024):
//     v   = K4: x[m, kb]           K5: da[m, kb] (* gelu'(pre)) (then
//                                      g = T(v) with want_g), v *= sf[k]
//                                  K8: da[m, kb] * gelu'(pre) (g with
//                                      want_g), no fold
//     sx[kb, m] = max(amax_k |v[m, k]|, 1e-8) / 127   (IEEE division)
//                 or, given sx_in (a K split over tensor-parallel shards
//                 whose K-block spans them: the block's scale is the max
//                 over the shards' parts), sx_in[kb, m]
//     q[m, k]   = clamp(rint(v / sx), -127, 127)      (half to even)
//   B, per output element:
//     acc  = sum over kb, in order, of float(part) * sx[kb, m], where
//     part = sum_{k in kb} q[m, k] * w[n, k]   (int32, exact: 127^2 * 1024)
//     K4: y = acc * sw[n] (+ bias[n]); with preact pre = T(y), y = float(pre);
//         gelu(y); + residual; out = T(y).       K5: out = T(acc).
//     K8: out = T(acc * sw[n]).
// w is the weight K-major, [N, K]: K5's qw is so already, K4's qw [K, N]
// and K8's qwt [K, N] are transposed once per call (T below, N * K bytes
// each way).
//
// Bound on the H100, at the int8 MLP's sites (M = 8192 rows, K and N
// 2048/8192): the GEMM is 2 M K N = 2.75e11 int8 operations, 0.139 ms at
// the 1,979 TOP/s of the dense int8 tensor cores.  The quantize pass is
// bound by bytes: reading the activations (and pre) and writing the codes
// (and g), 50 MB (0.015 ms) at mlp_in, 201 MB (0.060 ms) at mlp_out, and
// 470 MB (0.140 ms) at the mlp_in dgrad with gelu' and g, whose floor is
// bytes as much as operations whatever the design.
//
// Design.  A per-(row, K-block) scale needs the whole row of the K-block
// before any code can be written, and every output tile along N needs the
// same codes.  Quantizing inside the GEMM therefore either repeats the
// work for every N-tile (a 128 x 512 slab is ~2.4 us of one SM's CUDA
// cores against ~0.6 us of its tensor cores) or shares slabs across
// blocks behind cluster barriers (the previous design: 1.5-1.7 ms a call).
// So the quantize is its own pass, once per element, and the GEMM is an
// ordinary block-scaled int8 product, shaped like an fp8 GEMM with
// per-block promotion:
//   A (quantize_blocks): one warp per (row, K-block), the row in
//     registers, 16-byte loads (8 bytes at bf16 bk = 128) with the lanes
//     interleaved so that each load instruction reads one contiguous
//     span, one warp reduction for the amax, the codes stored 8 or 4 bytes
//     a lane.  No shared memory, no barriers.  Codes [M, K] int8
//     row-major (K-major for the GEMM), scales [K / bk, M] so that a row
//     tile's scales of one K-block are contiguous.
//   B (qgemm_wgmma): the Hopper structure of the flash kernels (hopper.cuh).
//     A producer warpgroup gives its registers back and one thread keeps
//     TMA loads of [128 rows, 128 codes] A and [BN rows, 128 codes] B
//     tiles (128-byte swizzle, zero fill past M) in flight through
//     kGemmStages mbarrier stages; two consumer warpgroups, 64 rows each,
//     run wgmma m64nBNk32 s8.s8 -> s32 on them (four k32 slices a stage).
//     The int32 accumulator collects one K-block (bk / 128 stages, the
//     first product with scale-d 0); after its wait each thread promotes
//     it into the fp32 accumulator, acc = acc + float(part) * sx, with
//     __fmul_rn / __fadd_rn, K-blocks in order: the plain version's bits.
//     The part and the fp32 tile both live in registers (64 + 64 a thread
//     at BN = 128: a 64 x 256 tile would not fit), so a block is 128 x BN.
//     While one consumer waits for its products and promotes, the other's
//     products keep the tensor cores busy.  The epilogue's arithmetic runs
//     on the registers; the output goes through a padded shared-memory
//     tile per consumer and leaves 16 bytes a thread, whole rows a warp
//     (K4 at mlp_in, with gelu and the pre-activation, stores two columns
//     a thread from the registers: measured faster there), rows past M
//     masked.  The epilogue does not overlap the products (one block an
//     SM, not persistent): at mlp_in, gelu on 67 M outputs costs about
//     as much as the products.
//   T (transpose_s8): K4's weight [K, N] -> [N, K] through 64 x 64-byte
//     shared-memory tiles, 16-byte loads and stores (a generic strided
//     copy of the int8 weight runs at a tenth of the card's bandwidth).
//   tools/quant_matmul_ablation.py rebuilds this source with kGemmBN,
//   kGemmStages and kGemmStagedStore rewritten and times A, B and the
//   variants.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "launch.cuh"
#include "quant.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMinBk = 128;
constexpr int kMaxBk = 1024;

bool bk_ok(int K, int bk) {
  return bk >= kMinBk && bk <= kMaxBk && (bk & (bk - 1)) == 0 && K > 0 &&
         K % bk == 0;
}

// ==== A: the per-(row, K-block) quantize pass ================================

struct QuantParams {
  const void* a;        // K4: x; K5: da [M, K] (row stride lda)
  const void* pre;      // gelu' input [M, K] (row stride ldpre) or null
  const float* sf;      // the fold [K] or null
  int8_t* q;            // codes [M, K], row-major
  float* sx;            // scales [K / bk, M]
  void* g;              // v before the fold, [M, K], or null
  const float* sx_in;   // given scales [K / bk, M], or null (computed)
  int M, K;
  long long lda, ldpre;
};

constexpr int kQuantWarps = 8;         // rows of one K-block per block

template <typename T, int BK>
__global__ void __launch_bounds__(kQuantWarps * 32)
    quantize_blocks(const QuantParams p) {
  // Elements a lane loads at once (16 bytes; 8 at bf16 bk = 128, where a
  // row is 4 elements a lane), and how many such pieces a lane holds.
  constexpr int kVecMax = (int)(16 / sizeof(T));
  constexpr int kVec = kVecMax < BK / 32 ? kVecMax : BK / 32;
  constexpr int kChunks = BK / (32 * kVec);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long m = (long long)blockIdx.x * kQuantWarps + warp;
  if (m >= p.M) return;
  const int k0 = blockIdx.y * BK;
  const T* a = static_cast<const T*>(p.a) + m * p.lda + k0;
  const T* pre =
      p.pre ? static_cast<const T*>(p.pre) + m * p.ldpre + k0 : nullptr;
  T* g = p.g ? static_cast<T*>(p.g) + m * p.K + k0 : nullptr;
  const float* sf = p.sf ? p.sf + k0 : nullptr;

  // Piece c of lane l covers elements (32 c + l) kVec .. + kVec - 1 of the
  // K-block: each load instruction of the warp reads one contiguous span.
  float v[kChunks][kVec];
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int k = (c * 32 + lane) * kVec;
    dtt::loadv<kVec>(a + k, v[c]);
    if (pre != nullptr) {
      float pr[kVec];
      dtt::loadv<kVec>(pre + k, pr);
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        v[c][i] = __fmul_rn(v[c][i], dtt::dgelu(pr[i]));
    }
    if (g != nullptr) dtt::storev<kVec>(g + k, v[c]);
    if (sf != nullptr) {
      float f[kVec];
      dtt::loadv<kVec>(sf + k, f);
#pragma unroll
      for (int i = 0; i < kVec; ++i) v[c][i] = __fmul_rn(v[c][i], f[i]);
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) amax = fmaxf(amax, fabsf(v[c][i]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = p.sx_in != nullptr
                      ? p.sx_in[(long long)blockIdx.y * p.M + m]
                      : __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
  const float rs = __frcp_rn(s);
  int8_t* q = p.q + m * p.K + k0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    int8_t* dst = q + (c * 32 + lane) * kVec;
    if constexpr (kVec == 8)
      *reinterpret_cast<uint2*>(dst) = make_uint2(
          dtt::quant4(v[c], s, rs), dtt::quant4(v[c] + 4, s, rs));
    else
      *reinterpret_cast<uint32_t*>(dst) = dtt::quant4(v[c], s, rs);
  }
  if (lane == 0) p.sx[(long long)blockIdx.y * p.M + m] = s;
}

template <typename T, int BK>
cudaError_t launch_quant(const QuantParams& p, cudaStream_t stream) {
  const dim3 grid((p.M + kQuantWarps - 1) / kQuantWarps, p.K / BK);
  quantize_blocks<T, BK><<<grid, kQuantWarps * 32, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_quant(const QuantParams& p, int bk, cudaStream_t s) {
  switch (bk) {
    case 128: return launch_quant<T, 128>(p, s);
    case 256: return launch_quant<T, 256>(p, s);
    case 512: return launch_quant<T, 512>(p, s);
    case 1024: return launch_quant<T, 1024>(p, s);
  }
  return cudaErrorInvalidValue;
}

// ==== B: the block-scaled int8 GEMM ==========================================

constexpr int kBM = 128;               // rows a block: two consumers of 64
constexpr int kKS = 128;               // k a stage: one 128-byte row of codes
constexpr int kGemmBN = 128;           // output columns a block
constexpr int kGemmStages = 4;         // TMA stages in flight
constexpr int kGemmThreads = 128 * 3;  // producer + two consumer warpgroups
// The epilogue writes the output through a shared-memory tile and stores
// it 16 bytes a thread, whole rows a warp, where it computes no gelu (else,
// and when false: two columns a thread straight from the registers).
constexpr bool kGemmStagedStore = true;

template <typename T, int BN, int STAGES> struct GemmSmem {
  static constexpr int kA = kBM * kKS;            // A tile bytes
  static constexpr int kB = BN * kKS;             // B tile bytes
  static constexpr int kStage = kA + kB;
  // The epilogue's staging tile, one per consumer: 64 rows of BN outputs,
  // the row pitch padded by 16 bytes (conflict-free pair writes, 16-byte
  // aligned reads).
  static constexpr int kPitch = BN * (int)sizeof(T) + 16;
  static constexpr int kOut = STAGES * kStage;
  static constexpr int kBarriers =
      kOut + (kGemmStagedStore ? 2 * 64 * kPitch : 0);
  // + 1 KB so the tiles can start on a 1024-byte boundary.
  static constexpr size_t kBytes =
      1024 + kBarriers + 2 * STAGES * sizeof(uint64_t);
};

struct GemmParams {
  const float* sx;      // [K / bk, M]
  const float* sw;      // K4: [N] (epilogue); K5: null (no scale)
  const float* bias;    // [N] or null
  const void* residual; // [M, N] or null
  void* out;            // [M, N]
  void* pre;            // K4 with preact: [M, N], else null
  int M, N, K, bk;
  int gelu;
};

template <typename T, int BN, int STAGES>
__global__ void __launch_bounds__(kGemmThreads, 1)
    qgemm_wgmma(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb, const GemmParams p) {
  using G = GemmSmem<T, BN, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::kBarriers);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kBM;
  const int n_stages = p.K / kKS;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      dtt::mbar_init(&full[s], 1);
      dtt::mbar_init(&empty[s], 8);          // one arrival a consumer warp
    }
    dtt::mbar_fence_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 0) {
    // ---- producer ----
    dtt::regs_dec<40>();
    if (tid == 0) {
      for (int it = 0; it < n_stages; ++it) {
        const int s = it % STAGES;
        dtt::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        dtt::mbar_expect_tx(&full[s], G::kStage);
        uint8_t* st = smem + s * G::kStage;
        dtt::tma_load_2d(st, &ta, &full[s], it * kKS, m0);
        dtt::tma_load_2d(st + G::kA, &tb, &full[s], it * kKS, n0);
      }
    }
    return;
  }

  // ---- consumers ----
  dtt::regs_inc<232>();
  const int c = wg - 1;                      // 64-row half of the tile
  const int t = tid % 128, warp = t / 32, lane = t % 32;
  const int r0 = m0 + 64 * c + 16 * warp + lane / 4;   // and r0 + 8
  const int spb = p.bk / kKS;                // stages a K-block

  float acc[BN / 2];
  int part[BN / 2];
  dtt::zero(acc);
  float s0 = 0.f, s1 = 0.f;                  // this K-block's row scales
  int held = -1;         // a stage whose products may still be in flight

  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) dtt::mbar_arrive(&empty[s]);
  };

  for (int it = 0; it < n_stages; ++it) {
    const int s = it % STAGES;
    const int j = it % spb;                  // stage within the K-block
    if (j == 0) {
      const float* sxk = p.sx + (long long)(it / spb) * p.M;
      s0 = r0 < p.M ? sxk[r0] : 0.f;
      s1 = r0 + 8 < p.M ? sxk[r0 + 8] : 0.f;
    }
    dtt::mbar_wait(&full[s], (it / STAGES) & 1);
    const uint8_t* As = smem + s * G::kStage;
    const uint8_t* Bs = As + G::kA;
    dtt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKS / 32; ++kk)
      dtt::wgmma_ss_s8<BN>(part, dtt::tile_kmajor<64, kBM>(As, 64 * c, kk),
                           dtt::tile_kmajor<64, BN>(Bs, 0, kk),
                           j > 0 || kk > 0);
    dtt::wgmma_commit();
    if (j == spb - 1) {
      // The K-block is complete: promote it into the fp32 tile.
      dtt::wgmma_wait<0>();
      dtt::fence_regs(part);
      if (held >= 0) release(held);
      release(s);
      held = -1;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        acc[i] = __fadd_rn(acc[i], __fmul_rn((float)part[i],
                                             (i / 2) % 2 ? s1 : s0));
    } else {
      // Every group but this stage's is done: free the stage before it.
      dtt::wgmma_wait<1>();
      if (held >= 0) release(held);
      held = s;
    }
  }

  // Epilogue.  Register i holds row r0 + 8 ((i / 2) % 2), column
  // n0 + 8 (i / 4) + 2 (lane % 4) + i % 2.  K4's arithmetic runs on the
  // registers (the pre-activation stored on the way), acc ending as the
  // output's fp32 values.
  T* pre = static_cast<T*>(p.pre);
  if (p.sw != nullptr) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = r0 + 8 * h;
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn) {
        const int n = n0 + 8 * jn + 2 * (lane % 4);
        if (m >= p.M || n >= p.N) continue;
        float& y0 = acc[4 * jn + 2 * h];
        float& y1 = acc[4 * jn + 2 * h + 1];
        const long long o = m * p.N + n;
        y0 = __fmul_rn(y0, p.sw[n]);
        y1 = __fmul_rn(y1, p.sw[n + 1]);
        if (p.bias != nullptr) {
          y0 = __fadd_rn(y0, p.bias[n]);
          y1 = __fadd_rn(y1, p.bias[n + 1]);
        }
        if (pre != nullptr) {
          const float2 r = dtt::store2(pre + o, y0, y1);
          y0 = r.x;
          y1 = r.y;
        }
        if (p.gelu) {
          y0 = dtt::gelu(y0);
          y1 = dtt::gelu(y1);
        }
        if (p.residual != nullptr) {
          const float2 r = dtt::load2(static_cast<const T*>(p.residual) + o);
          y0 = __fadd_rn(y0, r.x);
          y1 = __fadd_rn(y1, r.y);
        }
      }
    }
  }
  // The output: through the consumer's padded shared-memory tile, 16 bytes
  // a thread and whole rows a warp; or, where the epilogue computes gelu
  // and stores the pre-activation (K4 at mlp_in, where the tile's extra
  // barriers cost more than the wider stores save), two columns a thread
  // straight from the registers.
  T* out = static_cast<T*>(p.out);
  if (kGemmStagedStore && pre == nullptr && !p.gelu) {
    uint8_t* tile = smem + G::kOut + c * 64 * G::kPitch;
    const int row0 = 16 * warp + lane / 4;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn)
        dtt::store2(reinterpret_cast<T*>(tile + (row0 + 8 * h) * G::kPitch) +
                        8 * jn + 2 * (lane % 4),
                    acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]);
    dtt::named_sync(1 + c, 128);
    constexpr int kChunks = BN * (int)sizeof(T) / 16;
    for (int i = t; i < 64 * kChunks; i += 128) {
      const int r = i / kChunks, ch = i % kChunks;
      const long long m = m0 + 64 * c + r;
      const int n = n0 + ch * 16 / (int)sizeof(T);
      if (m < p.M && n < p.N)
        *reinterpret_cast<uint4*>(out + m * p.N + n) =
            *reinterpret_cast<const uint4*>(tile + r * G::kPitch + ch * 16);
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = r0 + 8 * h;
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn) {
        const int n = n0 + 8 * jn + 2 * (lane % 4);
        if (m < p.M && n < p.N)
          dtt::store2(out + m * p.N + n, acc[4 * jn + 2 * h],
                      acc[4 * jn + 2 * h + 1]);
      }
    }
  }
}

template <typename T>
cudaError_t launch_gemm(const void* q, const void* w, const GemmParams& p,
                        cudaStream_t stream) {
  constexpr int BN = kGemmBN, STAGES = kGemmStages;
  CUtensorMap ta, tb;
  cudaError_t e;
  if ((e = dtt::make_u8_map(&ta, q, p.M, p.K, p.K, kBM)) != cudaSuccess ||
      (e = dtt::make_u8_map(&tb, w, p.N, p.K, p.K, BN)) != cudaSuccess)
    return e;
  constexpr size_t smem = GemmSmem<T, BN, STAGES>::kBytes;
  static bool done[dtt::kMaxDevices];
  if ((e = dtt::opt_in_smem(qgemm_wgmma<T, BN, STAGES>, smem, done)) !=
      cudaSuccess)
    return e;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + kBM - 1) / kBM);
  qgemm_wgmma<T, BN, STAGES><<<grid, kGemmThreads, smem, stream>>>(ta, tb, p);
  return cudaGetLastError();
}

// ==== T: the int8 weight's transpose =========================================

constexpr int kTT = 64;                // tile edge, bytes

// in [R, C] -> out [C, R], both row-major, R and C multiples of 64, rows
// 16-byte aligned.  Thread t loads 16 bytes of tile row t / 4 and stores
// 16 bytes of transposed row t / 4, gathered down a column of the tile.
__global__ void __launch_bounds__(256)
    transpose_s8(const int8_t* __restrict__ in, int8_t* __restrict__ out,
                 int R, int C) {
  __shared__ uint32_t tile[kTT][kTT / 4 + 1];    // a word of padding a row
  const int r0 = blockIdx.y * kTT, c0 = blockIdx.x * kTT;
  const int t = threadIdx.x, row = t >> 2, seg = (t & 3) * 16;
  const uint4 v = *reinterpret_cast<const uint4*>(
      in + (long long)(r0 + row) * C + c0 + seg);
  tile[row][seg / 4] = v.x;
  tile[row][seg / 4 + 1] = v.y;
  tile[row][seg / 4 + 2] = v.z;
  tile[row][seg / 4 + 3] = v.w;
  __syncthreads();
  // Out row c0 + row holds in column c0 + row, rows r0 + seg .. + 15.
  const int word = row / 4, shift = 8 * (row % 4);
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[j] = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      w[j] |= ((tile[seg + 4 * j + b][word] >> shift) & 0xffu) << (8 * b);
  }
  *reinterpret_cast<uint4*>(out + (long long)(c0 + row) * R + r0 + seg) =
      make_uint4(w[0], w[1], w[2], w[3]);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Dynamic shared memory of the GEMM (for reports).
extern "C" long long dtt_quant_gemm_smem() {
  return (long long)GemmSmem<bf16, kGemmBN, kGemmStages>::kBytes;
}

// T.  in [R, C] int8 -> out [C, R] int8, both contiguous and 16-byte
// aligned, R and C multiples of 64.  Returns cudaGetLastError().
extern "C" int dtt_transpose_s8(const void* in, void* out, int R, int C,
                                void* stream) {
  if (R <= 0 || C <= 0 || R % kTT || C % kTT || !aligned16(in) ||
      !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(C / kTT, R / kTT);
  transpose_s8<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(in), static_cast<int8_t*>(out), R, C);
  return (int)cudaGetLastError();
}

// A.  a [M, K] (row stride lda), pre [M, K] (row stride ldpre) or null
// (given: v = a * gelu'(pre)), sf [K] fp32 or null (given: v *= sf after g
// is written), q [M, K] int8 and sx [K / bk, M] fp32 out, g [M, K] or null
// (v before the fold), sx_in [K / bk, M] fp32 or null (given: the codes
// take these scales, which sx repeats).  bk a power of two, 128..1024,
// dividing K; rows,
// sf, q and g 16-byte aligned.  dtype: 0 = fp32, 1 = bf16.  Returns
// cudaGetLastError().
extern "C" int dtt_quant_blocks(const void* a, const void* pre,
                                const void* sf, void* q, void* sx, void* g,
                                const void* sx_in, int M, int K, int bk,
                                long long lda, long long ldpre, int dtype,
                                void* stream) {
  if (M <= 0 || !bk_ok(K, bk)) return (int)cudaErrorInvalidValue;
  QuantParams p{};
  p.a = a;
  p.pre = pre;
  p.sf = static_cast<const float*>(sf);
  p.q = static_cast<int8_t*>(q);
  p.sx = static_cast<float*>(sx);
  p.g = g;
  p.sx_in = static_cast<const float*>(sx_in);
  p.M = M;
  p.K = K;
  p.lda = lda;
  p.ldpre = ldpre;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_quant<float>(p, bk, s);
  if (dtype == 1) return (int)dispatch_quant<bf16>(p, bk, s);
  return (int)cudaErrorInvalidValue;
}

// B.  q [M, K] int8 (A's codes), sx [K / bk, M] fp32, w [N, K] int8
// (K-major), sw [N] fp32 or null (null: out = T(acc), K5), bias [N] fp32
// or null, residual [M, N] or null, out [M, N], pre [M, N] or null
// (written when given), gelu 0/1; every matrix contiguous, q and w
// 16-byte aligned, N even.  dtype: 0 = fp32, 1 = bf16.  Returns
// cudaGetLastError().
extern "C" int dtt_quant_gemm(const void* q, const void* sx, const void* w,
                              const void* sw, const void* bias,
                              const void* residual, void* out, void* pre,
                              int M, int N, int K, int bk, int gelu,
                              int dtype, void* stream) {
  if (M <= 0 || N <= 0 || N % 2 || !bk_ok(K, bk) || !aligned16(q) ||
      !aligned16(w))
    return (int)cudaErrorInvalidValue;
  GemmParams p{};
  p.sx = static_cast<const float*>(sx);
  p.sw = static_cast<const float*>(sw);
  p.bias = static_cast<const float*>(bias);
  p.residual = residual;
  p.out = out;
  p.pre = pre;
  p.M = M;
  p.N = N;
  p.K = K;
  p.bk = bk;
  p.gelu = gelu;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_gemm<float>(q, w, p, s);
  if (dtype == 1) return (int)launch_gemm<bf16>(q, w, p, s);
  return (int)cudaErrorInvalidValue;
}
