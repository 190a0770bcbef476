// Fused quantize-and-matmul on the int8 tensor cores for K8 (TN dgrad
// with the gelu backward in its prologue), on no training path.  K4 and K5
// moved to quant_gemm.cu (a quantize pass, then a wgmma GEMM); K8 moves
// there next, and this file goes.
//
// Replaces: distributed_tensorflow_tpu/ops/pallas/quant_matmul.py,
// _qmm_dgelu_kernel (launched by quantized_matmul_dgelu).  There the TPU
// walks the K-blocks as the last, sequential grid axis, quantizes each
// (bm, bk) block of the activations in VMEM and carries the fp32
// accumulator in scratch.  Hopper blocks run in parallel and in no order,
// so here one thread block owns a 64 x 128 output tile and loops over the
// K-blocks itself.
//
// The function (identical to the plain version in ops/quant_matmul.py):
//   for each K-block kb of width bk (a power of two, 128..1024):
//     v   = da[m, kb] * gelu'(pre)     (g = v written out with want_g)
//     sx  = max(amax_k |v[m, k]|, 1e-8) / 127          (per row, per kb)
//     q   = clamp(rint(v / sx), -127, 127)             (IEEE division,
//                                                       half to even)
//     part = sum_k q[m, k] * qwt[k, n]       (int32, exact: 127^2 * 1024)
//     acc += float(part) * sx                (fp32, K-blocks in order)
//   out = T(acc * sw[n]).
// This is the dgrad against an explicitly re-quantized w.T (the TPU
// kernel's pre-NT formulation; K5 replaced it on the training path).
// Every rounding step is written with __f*_rn intrinsics (quant.cuh).
//
// Bound on the H100: at the int8 MLP's mlp_in dgrad shape (M = 8192 rows,
// K = 8192, N = 2048) a call is 2.7e11 int8 operations, 0.139 ms at the
// 1,979 TOP/s of the dense int8 tensor cores, against 0.055-0.135 ms of
// bytes (da, pre, g, the int8 weight, the output): the tensor cores bound
// it, barely.
//
// Design, simple first: 8 warps per block, each owning a 32 x 32 piece of
// the 64 x 128 tile, on mma.sync m16n8k32 s8 (int32 fragments in
// registers, whose row/column layout is fixed by the PTX ISA, so the
// per-row rescale by sx needs no shared-memory round trip).  Two blocks
// per SM.  Per K-block:
// - the prologue quantizes the 64 x bk activation slab into shared memory
//   as int8 (<= 64 KB) with its 64 row scales, one warp per row with the
//   row in registers (the amax needs the whole row before any element is
//   quantized: one read, a warp reduction, then the codes).  The blocks
//   of one output row tile all need the same slab: up to 8 neighbours
//   along N form a thread block cluster, each quantizes its share of the
//   rows and writes the codes into every member's shared memory
//   (distributed shared memory), so a slab is quantized once per cluster
//   rather than once per block;
// - the weight streams through a ring of 128 x 128 int8 stages filled with
//   cp.async, the first stages issued before the prologue.  The weight
//   sits K-contiguous ([n][k]), as the mma's B operand wants: the wrapper
//   hands qwt [K, N] over transposed (one int8 K-major copy per call).
// M is masked (any M); K must be a multiple of bk and N of 128, which the
// wrapper checks.  The quantize is IEEE-exact at the cost of a multiply
// by the reciprocal plus a division near ties (quant1).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "launch.cuh"
#include "quant.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int BM = 64;                 // rows per block
constexpr int BN = 128;                // output columns per block
constexpr int KS = 128;                // k per weight stage
constexpr int kMaxCluster = 8;         // blocks along N sharing a slab
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxBk = 1024;
constexpr int kChunks = kMaxBk / 128;  // 4 elements per lane per chunk
constexpr int LDB = KS + 16;           // bytes per weight row in shared mem
constexpr size_t kSxBytes = BM * sizeof(float);
constexpr size_t kStageBytes = BN * LDB;

struct Params {
  const void* a;        // da [M, K] (row stride lda)
  const void* pre_in;   // pre [M, K] (row stride ldpre)
  const int8_t* qw;     // [N, K], K-contiguous (the transposed copy)
  const float* scale;   // sw [N] (epilogue)
  void* out;            // [M, N]
  void* g_out;          // with want_g: [M, K], else null
  int M, N, K, bk;
  long long lda, ldpre;
};

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 16-byte matrices from shared memory; lane i names row i % 8 of
// matrix i / 8.  Register j of lane t holds bytes 4 (t % 4) .. + 3 of row
// t / 4 of matrix j: the m16n8k32 s8 fragment layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// One weight stage: rows n0..n0+127 of the K-major weight [N, K], k0..k0
// + 127, copied to shared memory ([n][k], row pitch LDB) with cp.async
// (16 bytes a piece, four per thread), no registers on the way.
__device__ __forceinline__ void load_stage(uint8_t* sB, const int8_t* qw,
                                           int K, int n0, int k0) {
#pragma unroll
  for (int j = 0; j < BN * KS / 16 / kThreads; ++j) {
    const int c = threadIdx.x + j * kThreads;
    const uint32_t dst = static_cast<uint32_t>(
        __cvta_generic_to_shared(sB + (c >> 3) * LDB + (c & 7) * 16));
    const int8_t* src = qw + (long long)(n0 + (c >> 3)) * K + k0 + (c & 7) * 16;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(src));
  }
}
// The cluster barrier in its two halves, so that work can sit between
// them: arrive (release: this thread's shared-memory reads and writes
// before it are done) and wait (acquire: every thread of the cluster has
// arrived).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit_stage() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

template <typename T, int kStages>
__global__ void __launch_bounds__(kThreads, 2)
qmm_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* sx = reinterpret_cast<float*>(smem);
  uint8_t* sB = smem + kSxBytes;                 // [kStages][BN][LDB]
  uint8_t* sA = sB + kStages * kStageBytes;      // [BM][bk + 16]
  const int bk = p.bk, lda_s = bk + 16;
  const int nc = bk / 128;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;       // 2 x 4 warps of 32 x 32
  const int gq = lane >> 2, tg = lane & 3;
  const int n0 = blockIdx.x * BN;
  const long long m0 = (long long)blockIdx.y * BM;
  const T* A = static_cast<const T*>(p.a);
  // The cluster's blocks (neighbours along N, same rows) quantize the
  // slab together: each its share of the rows, written into every
  // block's shared memory.
  cg::cluster_group cluster = cg::this_cluster();
  const int crank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int rows_per = BM / csize;
  // g is written by the blocks of the last cluster along N, each for the
  // rows it quantizes: every element once.
  const bool write_g = p.g_out != nullptr &&
                       (int)blockIdx.x >= (int)gridDim.x - csize;

  float acc[2][4][4];
  int part[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[mi][ni][c] = 0.f;
        part[mi][ni][c] = 0;
      }

  const int steps = bk / KS;
  const int per = bk / 32;             // elements of a row per lane: 4..32
  cluster_arrive();                    // this block's shared memory is live
  for (int kbase = 0; kbase < p.K; kbase += bk) {
    __syncthreads();                   // this block's weight slots are free
    // The K-block's first weight stages fly while the slab is quantized.
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < steps)
        load_stage(sB + st * kStageBytes, p.qw, p.K, n0, kbase + st * KS);
      commit_stage();
    }

    // Prologue: quantize this block's rows of the 64 x bk slab, one warp
    // per row, lane l owning elements l * per .. + per - 1 of it.
    bool waited = false;
    for (int r = crank * rows_per + warp; r < (crank + 1) * rows_per;
         r += kWarps) {
      const long long m = m0 + r;
      float v[kChunks][4];
      float amax = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        if (4 * c >= per) break;
        const int k = kbase + lane * per + 4 * c;
        if (m < p.M) {
          dtt::loadv<4>(A + m * p.lda + k, v[c]);
          float pr[4];
          dtt::loadv<4>(static_cast<const T*>(p.pre_in) + m * p.ldpre + k,
                        pr);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[c][i] = __fmul_rn(v[c][i], dtt::dgelu(pr[i]));
          if (write_g)
            dtt::storev<4>(static_cast<T*>(p.g_out) + m * p.K + k, v[c]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) v[c][i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) amax = fmaxf(amax, fabsf(v[c][i]));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float s = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
      const float rs = __frcp_rn(s);
      uint32_t words[kChunks];
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        if (4 * c < per) words[c] = dtt::quant4(v[c], s, rs);
      if (!waited) {                   // every block is done with the
        cluster_wait();                // previous slab
        waited = true;
      }
      for (int dst = 0; dst < csize; ++dst) {
        uint8_t* a_dst =
            cluster.map_shared_rank(sA, dst) + r * lda_s + lane * per;
        if (per >= 16) {
#pragma unroll
          for (int q = 0; q < kChunks / 4; ++q)
            if (16 * q < per)
              reinterpret_cast<uint4*>(a_dst)[q] = make_uint4(
                  words[4 * q], words[4 * q + 1], words[4 * q + 2],
                  words[4 * q + 3]);
        } else if (per == 8) {
          *reinterpret_cast<uint2*>(a_dst) = make_uint2(words[0], words[1]);
        } else {
          *reinterpret_cast<uint32_t*>(a_dst) = words[0];
        }
        if (lane == 0) cluster.map_shared_rank(sx, dst)[r] = s;
      }
    }
    cluster_arrive();                  // the whole slab has landed
    cluster_wait();                    // everywhere

    // The K-block's int32 product over a ring of kStages weight stages:
    // stage ks is waited for, then stage ks + kStages - 1 is issued into
    // the slot that stage ks - 1 used.
    for (int ks = 0; ks < steps; ++ks) {
      wait_stages<kStages - 2>();
      __syncthreads();
      const int next = ks + kStages - 1;
      if (next < steps)
        load_stage(sB + (next % kStages) * kStageBytes, p.qw, p.K, n0,
                   kbase + next * KS);
      commit_stage();
      const uint8_t* b_s = sB + (ks % kStages) * kStageBytes;
#pragma unroll
      for (int kk = 0; kk < KS; kk += 32) {
        // A (16 rows x 32 k): matrices rows 0-7 / 8-15 x bytes 0-15 /
        // 16-31 give a0..a3.  B (8 n x 32 k) per n8 tile: bytes 0-15 and
        // 16-31 give b0, b1; one x4 loads two tiles.
        uint32_t a[2][4], b[4][2];
        const int mrow = lane & 7, mat = lane >> 3;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldmatrix_x4(a[mi], sA + (wm * 32 + mi * 16 + (mat & 1) * 8 + mrow)
                                      * lda_s + ks * KS + kk + (mat >> 1) * 16);
#pragma unroll
        for (int ni = 0; ni < 4; ni += 2) {
          uint32_t r[4];
          ldmatrix_x4(r, b_s + (wn * 32 + (ni + (mat >> 1)) * 8 + mrow) * LDB
                              + kk + (mat & 1) * 16);
          b[ni][0] = r[0];
          b[ni][1] = r[1];
          b[ni + 1][0] = r[2];
          b[ni + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_s8(part[mi][ni], a[mi], b[ni]);
      }
    }

    // acc += float(part) * sx, per row of the fragment.
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float s = sx[wm * 32 + mi * 16 + gq + (c >> 1) * 8];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          acc[mi][ni][c] = __fadd_rn(
              acc[mi][ni][c], __fmul_rn((float)part[mi][ni][c], s));
          part[mi][ni][c] = 0;
        }
      }
    // This block is done with its slab: the next may be written into it.
    if (kbase + bk < p.K) cluster_arrive();
  }

  // Epilogue.  Fragment element c sits at row gq + (c >> 1) * 8, column
  // tg * 2 + (c & 1) of its 16 x 8 piece.
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + wm * 32 + mi * 16 + gq + h * 8;
      if (m >= p.M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn * 32 + ni * 8 + tg * 2;
        float y0 = acc[mi][ni][2 * h], y1 = acc[mi][ni][2 * h + 1];
        const long long o = m * p.N + n;
        y0 = __fmul_rn(y0, p.scale[n]);
        y1 = __fmul_rn(y1, p.scale[n + 1]);
        dtt::store2(out + o, y0, y1);
      }
    }
}

template <typename T, int kStages>
cudaError_t launch_stages(const Params& p, cudaStream_t stream) {
  const size_t smem =
      kSxBytes + kStages * kStageBytes + (size_t)BM * (p.bk + 16);
  if (smem > 48 * 1024) {
    // Once per device, for the largest K-block (kMaxBk).
    static bool done[dtt::kMaxDevices];
    const cudaError_t e = dtt::opt_in_smem(
        qmm_kernel<T, kStages>, kSxBytes + kStages * kStageBytes +
                                    (size_t)BM * (kMaxBk + 16),
        done);
    if (e != cudaSuccess) return e;
  }
  int cn = kMaxCluster;
  while ((p.N / BN) % cn) cn /= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.N / BN, (p.M + BM - 1) / BM);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cn;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, qmm_kernel<T, kStages>, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Three weight stages where two blocks still fit on an SM (bk <= 512:
// <= 89 KB each), two for the 1024-wide K-block's 66 KB slab.
template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  return p.bk > 512 ? launch_stages<T, 2>(p, stream)
                    : launch_stages<T, 3>(p, stream);
}

bool valid(const Params& p) {
  return p.M > 0 && p.N > 0 && p.K > 0 && p.N % BN == 0 && p.bk >= 128 &&
         p.bk <= kMaxBk && (p.bk & (p.bk - 1)) == 0 && p.K % p.bk == 0;
}

}  // namespace

// K8.  da, pre [M, K] (row strides ldda, ldpre), qwt [N, K] int8 (the
// weight K-major: the transpose of quantize_cols' [K, N]), sw [N] fp32,
// out [M, N], g [M, K] or null (want_g).  Returns cudaGetLastError().
extern "C" int dtt_quant_matmul_dgelu(const void* da, const void* pre,
                                      const void* qwt, const void* sw,
                                      void* out, void* g, int M, int N, int K,
                                      int bk, long long ldda, long long ldpre,
                                      int dtype, void* stream) {
  Params p{};
  p.a = da;
  p.pre_in = pre;
  p.qw = static_cast<const int8_t*>(qwt);
  p.scale = static_cast<const float*>(sw);
  p.out = out;
  p.g_out = g;
  p.M = M; p.N = N; p.K = K; p.bk = bk;
  p.lda = ldda;
  p.ldpre = ldpre;
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, s);
  if (dtype == 1) return (int)launch<bf16>(p, s);
  return (int)cudaErrorInvalidValue;
}
