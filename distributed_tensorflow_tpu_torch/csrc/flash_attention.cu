// Flash-attention forward: blockwise online softmax, fp32 statistics,
// output in the input dtype plus the per-row logsumexp.
//
// Replaces: distributed_tensorflow_tpu/ops/pallas/flash_attention.py,
// _kernel (launched by _flash_forward).  There the TPU walks the K blocks
// as the last, sequential grid axis and carries (m, l, acc) in VMEM
// scratch between grid steps.  Hopper blocks run in parallel and in no
// order, so here one thread block owns one (batch*head, 64-row Q tile) and
// loops over the K/V tiles itself, keeping (m, l, acc) in shared memory.
//
// Bound on the H100: at the serving path's shapes (S = 112 .. 1024 with
// D = 128) the work is ~2 S^2 D flops per head against ~8 S D bytes of
// q/k/v/o, about S/2 flops per byte: below the ~295 flop/byte ridge of the
// bf16 tensor cores up to S ~ 600 and just above it beyond, so the bound
// is bytes for short prompts and tensor-core flops for the longest.
//
// Design, simple first: four warps per block, each owning 16 Q rows.  The
// Q tile is read once; each 64-row K and V tile is read once per Q tile.
// Scores S = Q K^T and the update O += P V run on the tensor cores through
// WMMA bf16 fragments with fp32 accumulation (fp32 inputs take a scalar
// FMA path instead, which keeps full fp32 precision).  Scores, P and the
// fp32 output accumulator live in shared memory; the softmax runs two
// threads per row, in registers.  Causal tiles above the diagonal and, with a
// sliding window, tiles below the band are never loaded.  The ragged last
// tile is masked, so any S works.  q, k and v are read through their
// [B, S, H, D] strides (only the last dim must be contiguous), so the
// fused qkv projection's slices need no transpose copy.  wgmma, TMA and
// warp specialisation are left for later work.
//
// Masked scores are -1e30 and masked probabilities exactly 0, as in the
// TPU kernel; a row with no valid key ends with l = 0, is clamped to 1e-30
// and so writes zeros, with lse = m + log(l) ~ -1e30.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;         // Q rows per block
constexpr int BK = 64;         // K/V rows per tile
constexpr int kWarps = 4;      // 16 Q rows each
constexpr int kThreads = kWarps * 32;
constexpr float kNeg = -1e30f;

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

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// Shared-memory geometry.  bf16 rows are padded by 8 elements (16 bytes)
// so WMMA fragment pointers stay 32-byte aligned and rows fall on other
// banks; fp32 rows by one element, for conflict-free column reads in the
// scalar path.
template <typename T, int D> struct Geo {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int LD = D + (kBf16 ? 8 : 1);      // Q, K, V tiles
  static constexpr int LDS = BK + 4;                  // fp32 scores
  static constexpr int LDP = BK + (kBf16 ? 8 : 4);    // probabilities
  static constexpr int LDO = D + 4;                   // fp32 accumulator
  static constexpr size_t kQKV = sizeof(T) * (size_t)BQ * LD;
  static constexpr size_t kS = sizeof(float) * (size_t)BQ * LDS;
  static constexpr size_t kP = sizeof(T) * (size_t)BQ * LDP;
  static constexpr size_t kO = sizeof(float) * (size_t)BQ * LDO;
  static constexpr size_t kBytes =
      3 * kQKV + kS + kP + kO + 2 * sizeof(float) * BQ + sizeof(int) * BK;
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
  for (int c = threadIdx.x; c < BQ * kChunks; c += kThreads) {
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

// ---- S = Q K^T for this warp's 16 rows -----------------------------------

template <int D>
__device__ __forceinline__ void scores_bf16(
    const wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
        (&qa)[D / 16],
    const bf16* Ks, float* Ss, int warp) {
  using G = Geo<bf16, D>;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) {
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // K^T(k, n) = K[n][k]: column-major with leading dimension LD.
      wmma::load_matrix_sync(kb, Ks + (n * 16) * G::LD + kk * 16, G::LD);
      wmma::mma_sync(acc, qa[kk], kb, acc);
    }
    wmma::store_matrix_sync(Ss + (warp * 16) * G::LDS + n * 16, acc, G::LDS,
                            wmma::mem_row_major);
  }
}

template <int D>
__device__ __forceinline__ void scores_f32(const float* Qs, const float* Ks,
                                           float* Ss, int warp, int lane) {
  using G = Geo<float, D>;
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

// ---- O += P V for this warp's 16 rows --------------------------------------

template <int D>
__device__ __forceinline__ void pv_bf16(const bf16* Ps, const bf16* Vs,
                                        float* Os, int warp) {
  using G = Geo<bf16, D>;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
      pa[BK / 16];
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wmma::load_matrix_sync(pa[kk], Ps + (warp * 16) * G::LDP + kk * 16,
                           G::LDP);
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    float* o = Os + (warp * 16) * G::LDO + n * 16;
    wmma::load_matrix_sync(acc, o, G::LDO, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::load_matrix_sync(vb, Vs + (kk * 16) * G::LD + n * 16, G::LD);
      wmma::mma_sync(acc, pa[kk], vb, acc);
    }
    wmma::store_matrix_sync(o, acc, G::LDO, wmma::mem_row_major);
  }
}

template <int D>
__device__ __forceinline__ void pv_f32(const float* Ps, const float* Vs,
                                       float* Os, int warp, int lane) {
  using G = Geo<float, D>;
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

// ---- the kernel ------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  using G = Geo<T, D>;
  constexpr bool kBf16 = G::kBf16;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = reinterpret_cast<T*>(smem + G::kQKV);
  T* Vs = reinterpret_cast<T*>(smem + 2 * G::kQKV);
  float* Ss = reinterpret_cast<float*>(smem + 3 * G::kQKV);
  T* Ps = reinterpret_cast<T*>(smem + 3 * G::kQKV + G::kS);
  float* Os = reinterpret_cast<float*>(smem + 3 * G::kQKV + G::kS + G::kP);
  float* m_s = Os + BQ * G::LDO;
  float* l_s = m_s + BQ;
  int* mask_s = reinterpret_cast<int*>(l_s + BQ);

  const int S = p.S, H = p.H;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* qb = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* kb = static_cast<const T*>(p.k) + b * p.ksb + h * p.ksh;
  const T* vb = static_cast<const T*>(p.v) + b * p.vsb + h * p.vsh;

  load_tile<T, D>(Qs, qb, p.qss, q0, S);
  for (int i = tid; i < BQ * G::LDO; i += kThreads) Os[i] = 0.f;
  for (int i = tid; i < BQ; i += kThreads) {
    m_s[i] = kNeg;
    l_s[i] = 0.f;
  }
  __syncthreads();

  // This warp's Q rows stay in registers for the whole K loop.
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
      qa[kBf16 ? D / 16 : 1];
  if constexpr (kBf16) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wmma::load_matrix_sync(
          qa[kk], reinterpret_cast<const bf16*>(Qs) + (warp * 16) * G::LD +
                      kk * 16, G::LD);
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
    load_tile<T, D>(Ks, kb, p.kss, k0, S);
    load_tile<T, D>(Vs, vb, p.vss, k0, S);
    if (tid < BK) {
      const int s = k0 + tid;
      mask_s[tid] = s < S && (p.kv_mask == nullptr || p.kv_mask[b * S + s]);
    }
    __syncthreads();

    if constexpr (kBf16)
      scores_bf16<D>(qa, reinterpret_cast<const bf16*>(Ks), Ss, warp);
    else
      scores_f32<D>(reinterpret_cast<const float*>(Qs),
                    reinterpret_cast<const float*>(Ks), Ss, warp, lane);
    __syncwarp();

    // Online softmax: lanes 2i and 2i + 1 of warp w own row 16w + i, 32 of
    // the tile's 64 columns each, so the row reductions run in registers
    // with one shuffle between the pair.  Column order is rotated by lane
    // to spread the shared-memory banks.
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
        Ps[r * G::LDP + half * 32 + ((j + lane) & 31)] = from_f<T>(pr);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float corr = expf(m_prev - m_new);
      __syncwarp();   // both lanes of the row have read m_s[r]
      if (half == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
      }
      // Rescale this lane's half of the row's output accumulator.
      float* o = Os + r * G::LDO + half * (D / 2);
#pragma unroll 8
      for (int i = 0; i < D / 2; ++i) o[(i + lane) & (D / 2 - 1)] *= corr;
    }
    __syncwarp();

    if constexpr (kBf16)
      pv_bf16<D>(reinterpret_cast<const bf16*>(Ps),
                 reinterpret_cast<const bf16*>(Vs), Os, warp);
    else
      pv_f32<D>(reinterpret_cast<const float*>(Ps),
                reinterpret_cast<const float*>(Vs), Os, warp, lane);
  }
  __syncthreads();

  T* out = static_cast<T*>(p.out);
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
    const int qpos = q0 + r;
    if (qpos >= S) break;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* orow = out + (((long long)b * S + qpos) * H + h) * D;
    for (int d = lane; d < D; d += 32)
      orow[d] = from_f<T>(Os[r * G::LDO + d] / l);
    if (lane == 0) p.lse[(long long)bh * S + qpos] = m_s[r] + logf(l);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Geo<T, D>::kBytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((p.S + BQ - 1) / BQ, p.B * p.H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16.  D in {64, 128}.  Strides in elements; the
// last dim must be contiguous and every row start 16-byte aligned (the
// Python wrapper checks).  Returns cudaGetLastError().
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
  if (dtype == 1 && D == 128) return (int)launch<bf16, 128>(p, s);
  if (dtype == 1 && D == 64) return (int)launch<bf16, 64>(p, s);
  if (dtype == 0 && D == 128) return (int)launch<float, 128>(p, s);
  if (dtype == 0 && D == 64) return (int)launch<float, 64>(p, s);
  return (int)cudaErrorInvalidValue;
}
