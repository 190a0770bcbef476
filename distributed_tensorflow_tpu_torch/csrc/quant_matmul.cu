// Fused quantize-and-matmul on the int8 tensor cores: K4 (forward), K5
// (NT dgrad) and K8 (TN dgrad with the gelu backward in its prologue).
//
// Replaces: distributed_tensorflow_tpu/ops/pallas/quant_matmul.py,
// _qmm_kernel (launched by quantized_matmul), _qmm_nt_kernel (launched
// by quantized_matmul_nt) and _qmm_dgelu_kernel (launched by
// quantized_matmul_dgelu).  There the TPU walks the K-blocks as the last,
// sequential grid axis, quantizes each (bm, bk) block of the activations
// in VMEM and carries the fp32 accumulator in scratch.  Hopper blocks run
// in parallel and in no order, so here one thread block owns a 64 x 128
// output tile and loops over the K-blocks itself.
//
// The function (identical to the plain versions in ops/quant_matmul.py):
//   for each K-block kb of width bk (a power of two, 128..1024):
//     v   = K4: x[m, kb]                   K5: da[m, kb] (* gelu'(pre))
//                                              (then g = v is written out
//                                              with want_g) and v *= sf[k]
//                                          K8: da[m, kb] * gelu'(pre) (g
//                                              written with want_g), no fold
//     sx  = max(amax_k |v[m, k]|, 1e-8) / 127          (per row, per kb)
//     q   = clamp(rint(v / sx), -127, 127)             (IEEE division,
//                                                       half to even)
//     part = sum_k q[m, k] * qw[k, n]        (int32, exact: 127^2 * 1024)
//     acc += float(part) * sx                (fp32, K-blocks in order)
//   K4 epilogue: y = acc * sw[n] (+ bias[n]); with preact: pre = T(y),
//                y = float(pre); gelu(y); + residual; out = T(y).
//   K5 epilogue: out = T(acc).
//   K8 epilogue: out = T(acc * sw[n]).
// K8 is K5's prologue without the scale fold and K4's weight layout and
// scale epilogue: the dgrad against an explicitly re-quantized w.T (the
// TPU kernel's pre-NT formulation, on no training path; K5 replaced it).
// Every rounding step is written with __f*_rn intrinsics so that nvcc does
// not contract a multiply and an add into one FMA: the plain version
// rounds each operation, and the kernel gives the same bits.
//
// Bound on the H100: at the int8 MLP's shapes (M = 8192 rows, K and N
// 2048/8192) each call is 2.7e11 int8 operations, 0.139 ms at the 1,979
// TOP/s of the dense int8 tensor cores, against 0.055-0.135 ms of bytes
// (the bf16 activations in, the int8 weight, the bf16 outputs): the
// tensor cores bound it, barely.
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
//   sits K-contiguous ([n][k]), as the mma's B operand wants: K5's qw
//   [N, K] is so already; K4's qw [K, N] is handed over transposed (the
//   wrapper makes one int8 K-major copy per call, N*K bytes; so does K8's
//   for its qwt [K, N]).  A later
//   wgmma/TMA design wants that layout too: quantize_cols could then emit
//   both layouts once per step.
// M is masked (any M); K must be a multiple of bk and N of 128, which the
// wrappers check.  The quantize is IEEE-exact at the cost of a multiply
// by the reciprocal plus a division near ties (quant1).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

// The three variants of one kernel body.
enum Mode : int { kFwd = 0, kNt = 1, kDgelu = 2 };

struct Params {
  const void* a;        // K4: x [M, K]; K5, K8: da [M, K] (row stride lda)
  const void* pre_in;   // K5 dgelu, K8: pre [M, K] (row stride ldpre)
  const int8_t* qw;     // [N, K], K-contiguous (K4, K8: the transposed copy)
  const float* scale;   // K4, K8: sw [N] (epilogue); K5: sf [K] (prologue)
  const float* bias;    // K4, [N] or null
  const void* residual; // K4, [M, N] or null
  void* out;            // [M, N]
  void* pre_out;        // K4 with preact: [M, N], else null
  void* g_out;          // K5, K8 with want_g: [M, K], else null
  int M, N, K, bk;
  long long lda, ldpre;
  int gelu;             // K4: gelu epilogue; K5, K8: dgelu prologue
};

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void load4(const bf16* p, float v[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float v[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// A pair of adjacent output columns: round to T and store (4- or 8-byte
// aligned, since the column is even); returns the rounded values.
__device__ __forceinline__ float2 store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
  return make_float2(a, b);
}
__device__ __forceinline__ float2 store2(bf16* p, float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
  return __bfloat1622float2(v);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// jax.nn.gelu(approximate=True) and its derivative, in the JAX code's
// operation order with every step rounded.
constexpr float kGeluC = 0.7978845608028654f;
constexpr float kGeluA = 0.044715f;
constexpr float kGelu3A = (float)(3.0 * 0.044715);

__device__ __forceinline__ float tanh_arg(float y) {
  const float y3 = __fmul_rn(__fmul_rn(__fmul_rn(kGeluA, y), y), y);
  return __fmul_rn(kGeluC, __fadd_rn(y, y3));
}
__device__ __forceinline__ float gelu(float y) {
  const float t = tanhf(tanh_arg(y));
  return __fmul_rn(__fmul_rn(0.5f, y), __fadd_rn(1.0f, t));
}
__device__ __forceinline__ float dgelu(float y) {
  const float t = tanhf(tanh_arg(y));
  const float dt = __fmul_rn(
      __fmul_rn(__fsub_rn(1.0f, __fmul_rn(t, t)), kGeluC),
      __fadd_rn(1.0f, __fmul_rn(__fmul_rn(kGelu3A, y), y)));
  return __fadd_rn(__fmul_rn(0.5f, __fadd_rn(1.0f, t)),
                   __fmul_rn(__fmul_rn(0.5f, y), dt));
}

// q = clamp(rint(v / s), -127, 127), rounding half to even, with the
// result of the IEEE division: v * (1/s) is within 1.5 ulp of v / s, so
// the two round to different integers only when v * (1/s) lies within
// that distance of a half-integer (< 1.2e-5 for |v / s| <= 128); there
// the division itself is taken.
__device__ __forceinline__ int quant1(float v, float s, float rs) {
  float y = __fmul_rn(v, rs);
  if (fabsf(y - floorf(y) - 0.5f) < 1e-4f) y = __fdiv_rn(v, s);
  return max(-127, min(127, __float2int_rn(y)));
}

__device__ __forceinline__ uint32_t quant4(const float v[4], float s,
                                           float rs) {
  uint32_t packed = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    packed |= (uint32_t)(uint8_t)(int8_t)quant1(v[i], s, rs) << (8 * i);
  return packed;
}

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

template <typename T, int kMode, int kStages>
__global__ void __launch_bounds__(kThreads, 2)
qmm_kernel(const Params p) {
  // K5 and K8 share the dgrad prologue (gelu', g out); K4 and K8 the
  // weight-scale epilogue.
  constexpr bool kDgrad = kMode != kFwd;
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
  const bool write_g = kDgrad && p.g_out != nullptr &&
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
          load4(A + m * p.lda + k, v[c]);
          if (kDgrad) {
            if (p.gelu) {
              float pr[4];
              load4(static_cast<const T*>(p.pre_in) + m * p.ldpre + k, pr);
#pragma unroll
              for (int i = 0; i < 4; ++i)
                v[c][i] = __fmul_rn(v[c][i], dgelu(pr[i]));
            }
            if (write_g)
              store4(static_cast<T*>(p.g_out) + m * p.K + k, v[c]);
            if (kMode == kNt) {
              float sf[4];
              load4(p.scale + k, sf);
#pragma unroll
              for (int i = 0; i < 4; ++i)
                v[c][i] = __fmul_rn(v[c][i], sf[i]);
            }
          }
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
        if (4 * c < per) words[c] = quant4(v[c], s, rs);
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
        if (kMode == kDgelu) {
          y0 = __fmul_rn(y0, p.scale[n]);
          y1 = __fmul_rn(y1, p.scale[n + 1]);
        } else if (kMode == kFwd) {
          y0 = __fmul_rn(y0, p.scale[n]);
          y1 = __fmul_rn(y1, p.scale[n + 1]);
          if (p.bias) {
            y0 = __fadd_rn(y0, p.bias[n]);
            y1 = __fadd_rn(y1, p.bias[n + 1]);
          }
          if (p.pre_out) {
            const float2 r = store2(static_cast<T*>(p.pre_out) + o, y0, y1);
            y0 = r.x;
            y1 = r.y;
          }
          if (p.gelu) {
            y0 = gelu(y0);
            y1 = gelu(y1);
          }
          if (p.residual) {
            const float2 r = load2(static_cast<const T*>(p.residual) + o);
            y0 = __fadd_rn(y0, r.x);
            y1 = __fadd_rn(y1, r.y);
          }
        }
        store2(out + o, y0, y1);
      }
    }
}

template <typename T, int kMode, int kStages>
cudaError_t launch_stages(const Params& p, cudaStream_t stream) {
  const size_t smem =
      kSxBytes + kStages * kStageBytes + (size_t)BM * (p.bk + 16);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        qmm_kernel<T, kMode, kStages>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, qmm_kernel<T, kMode, kStages>, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Three weight stages where two blocks still fit on an SM (bk <= 512:
// <= 89 KB each), two for the 1024-wide K-block's 66 KB slab.
template <typename T, int kMode>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  return p.bk > 512 ? launch_stages<T, kMode, 2>(p, stream)
                    : launch_stages<T, kMode, 3>(p, stream);
}

bool valid(const Params& p) {
  return p.M > 0 && p.N > 0 && p.K > 0 && p.N % BN == 0 && p.bk >= 128 &&
         p.bk <= kMaxBk && (p.bk & (p.bk - 1)) == 0 && p.K % p.bk == 0;
}

template <typename T>
cudaError_t launch_mode(const Params& p, int mode, cudaStream_t s) {
  if (mode == kFwd) return launch<T, kFwd>(p, s);
  if (mode == kNt) return launch<T, kNt>(p, s);
  if (mode == kDgelu) return launch<T, kDgelu>(p, s);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(const Params& p, int dtype, int mode, cudaStream_t s) {
  if (!valid(p)) return cudaErrorInvalidValue;
  if (dtype == 0) return launch_mode<float>(p, mode, s);
  if (dtype == 1) return launch_mode<bf16>(p, mode, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// K4.  x [M, K] (row stride ldx), qwt [N, K] int8 (the weight K-major:
// the transpose of quantize_cols' [K, N]), sw [N] fp32, bias [N]
// fp32 or null, residual [M, N] or null, out [M, N], pre [M, N] or null
// (written when given); gelu: 0/1; dtype: 0 = fp32, 1 = bf16.  Returns
// cudaGetLastError().
extern "C" int dtt_quant_matmul(const void* x, const void* qwt,
                                const void* sw, const void* bias,
                                const void* residual, void* out, void* pre,
                                int M, int N, int K, int bk, long long ldx,
                                int gelu, int dtype, void* stream) {
  Params p{};
  p.a = x;
  p.qw = static_cast<const int8_t*>(qwt);
  p.scale = static_cast<const float*>(sw);
  p.bias = static_cast<const float*>(bias);
  p.residual = residual;
  p.out = out;
  p.pre_out = pre;
  p.M = M; p.N = N; p.K = K; p.bk = bk;
  p.lda = ldx;
  p.gelu = gelu;
  return (int)dispatch(p, dtype, kFwd, static_cast<cudaStream_t>(stream));
}

// K5.  da [M, K] (row stride ldda), pre [M, K] (row stride ldpre) or null
// (null: the "fold" prologue; given: "dgelu_fold"), qw [N, K] int8, sf
// [K] fp32, out [M, N], g [M, K] or null (want_g).  Returns
// cudaGetLastError().
extern "C" int dtt_quant_matmul_nt(const void* da, const void* pre,
                                   const void* qw, const void* sf, void* out,
                                   void* g, int M, int N, int K, int bk,
                                   long long ldda, long long ldpre, int dtype,
                                   void* stream) {
  Params p{};
  p.a = da;
  p.pre_in = pre;
  p.qw = static_cast<const int8_t*>(qw);
  p.scale = static_cast<const float*>(sf);
  p.out = out;
  p.g_out = g;
  p.M = M; p.N = N; p.K = K; p.bk = bk;
  p.lda = ldda;
  p.ldpre = ldpre;
  p.gelu = pre != nullptr;
  return (int)dispatch(p, dtype, kNt, static_cast<cudaStream_t>(stream));
}

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
  p.gelu = 1;
  return (int)dispatch(p, dtype, kDgelu, static_cast<cudaStream_t>(stream));
}
