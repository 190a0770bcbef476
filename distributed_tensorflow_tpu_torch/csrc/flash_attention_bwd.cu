// Flash-attention backward (FlashAttention-2): dq, dk and dv from the saved
// per-row logsumexp, fp32 accumulation, gradients in the input dtype.
//
// Replaces: distributed_tensorflow_tpu/ops/pallas/flash_attention.py,
// _dkv_kernel (K2a) and _dq_kernel (K2b), both launched by _flash_backward.
// There the TPU walks the streamed blocks as the last, sequential grid axis
// and carries the fp32 dk/dv (or dq) accumulators in VMEM scratch.  Hopper
// blocks run in parallel and in no order, so here one thread block owns one
// 64-row tile and loops over the streamed tiles itself:
//   K2a (dkv): a block per (batch*head, K tile) walks the Q tiles that can
//              see it, accumulating dK and dV;
//   K2b (dq):  a block per (batch*head, Q tile) walks the K tiles it can
//              see, accumulating dQ.
// The TPU's two-call split is kept: neither kernel needs atomics, so the
// gradients are deterministic.  K2b also computes delta = rowsum(dO * o)
// for its Q tile (the JAX code does it in XLA before both calls) and writes
// it out for K2a, so the dq call runs first.
//
// Bound on the H100: at the train shape (S = 1024, D = 128, causal) the
// work per (q, k) pair is 2 D flops for each of the products a kernel runs
// (K2a: S, dP, dV, dK; K2b: S, dP, dQ) against ~10 S D bytes of operands
// per head: ~S/2 * D flops per byte, above the bf16 ridge (~295 flop/byte),
// so the bound is tensor-core flops.  Each kernel recomputes S and dP,
// which a fused kernel would share: the pair does 7 products where 5 would
// do.
//
// Design, simple first.  Four warps per block, each owning 16 rows of the
// block's tile.  The block's own two operand tiles (K2a: K, V; K2b: Q, dO)
// are read once; each streamed tile pair (K2a: Q, dO; K2b: K, V) is read
// once per block.  For each streamed tile a warp computes its 16 x 64 slice
// of S = own1 . str1^T and dP = own2 . str2^T, then
//   P = exp(scale * S - lse)   for valid (q, k), exactly 0 otherwise,
//   dS = P * (dP - delta),
// and accumulates dQ += dS . K (K2b) or dK += dS^T . Q and dV += P^T . dO
// (K2a: own rows are keys, so the warp's slices are already transposed).
// bf16 products run on the tensor cores through WMMA fragments with fp32
// accumulation; P and dS are rounded to bf16 as tensor-core operands, as in
// FlashAttention-2.  fp32 inputs take a scalar FMA path at full precision.
// The accumulators stay in registers (WMMA accumulator fragments, or
// per-lane arrays in the fp32 path); S and dP share one fp32 scratch tile
// per warp, so the bf16 D = 128 kernel needs ~105 KB of shared memory and
// two blocks fit on an SM (the wrapper opts in above 48 KB).  wgmma, TMA
// and a fused single-pass variant are left for later work.
//
// Masking happens before the exp, as in the TPU kernel: an invalid pair
// (key padding, causal, outside the window, past S) gets P = 0 without
// evaluating exp, so a fully masked row (lse ~ -1e30) gives exact zeros
// and never inf * 0.  Causal tiles above the diagonal and, with a window,
// tiles below the band are never visited.  q, k, v, o and dO are read
// through their [B, S, H, D] strides (last dim contiguous, rows 16-byte
// aligned), so the fused qkv projection's slices need no copy; dq, dk and
// dv are written contiguous.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BT = 64;         // rows of the own tile and of each streamed tile
constexpr int kWarps = 4;      // 16 own rows each
constexpr int kThreads = kWarps * 32;

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

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// Shared-memory geometry.  bf16 rows are padded by 8 elements (16 bytes) so
// WMMA fragment pointers stay 32-byte aligned and rows fall on other banks;
// fp32 rows by one element (operand tiles) or four (score tiles).
template <typename T, int D> struct Geo {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int LD = D + (kBf16 ? 8 : 1);      // operand tiles
  static constexpr int LDP = BT + (kBf16 ? 8 : 4);    // P and dS (type T)
  static constexpr int LDS = BT + 4;                  // fp32 S / dP scratch
  static constexpr size_t kTile = sizeof(T) * (size_t)BT * LD;
  static constexpr size_t kPS = sizeof(T) * (size_t)BT * LDP;
  // fp32 inputs: the scratch aliases the dS tile (same type and pitch).
  static constexpr size_t kSc = kBf16 ? sizeof(float) * (size_t)BT * LDS : 0;
  static constexpr size_t kInfo = (4 * sizeof(float) + 2 * sizeof(int)) * BT;
  static constexpr size_t kBytes = 4 * kTile + 2 * kPS + kSc + kInfo;
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

// ---- C[16 x 64] = A[16 x D] . B[64 x D]^T for this warp's rows ----------

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

// ---- a warp's 16 x D fp32 accumulator: acc += A[16 x 64] . B[64 x D] -----

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

  // scale * acc -> rows [pos0, pos0 + 16) of out (row pitch `pitch`),
  // staged through the warp's fp32 scratch 64 columns at a time.
  __device__ __forceinline__ void store(float* stage, bf16* out,
                                        long long pitch, int pos0, int S,
                                        float scale, int lane) {
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
          out[(long long)(pos0 + r) * pitch + c0 + c] =
              __float2bfloat16(stage[r * G::LDS + c] * scale);
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
                                        long long pitch, int pos0, int S,
                                        float scale, int lane) {
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

// ---- the kernel ------------------------------------------------------------
// kDKV = true: K2a (own tile = keys, streamed = queries) -> dk, dv.
// kDKV = false: K2b (own tile = queries, streamed = keys) -> dq, delta.

template <typename T, int D, bool kDKV>
__global__ void __launch_bounds__(kThreads) flash_bwd_kernel(Params p) {
  using G = Geo<T, D>;
  constexpr bool kBf16 = G::kBf16;
  extern __shared__ __align__(128) unsigned char smem[];
  T* own1 = reinterpret_cast<T*>(smem);
  T* own2 = reinterpret_cast<T*>(smem + G::kTile);
  T* str1 = reinterpret_cast<T*>(smem + 2 * G::kTile);
  T* str2 = reinterpret_cast<T*>(smem + 3 * G::kTile);
  T* Ps = reinterpret_cast<T*>(smem + 4 * G::kTile);
  T* dSs = reinterpret_cast<T*>(smem + 4 * G::kTile + G::kPS);
  float* Sc = kBf16 ? reinterpret_cast<float*>(smem + 4 * G::kTile +
                                               2 * G::kPS)
                    : reinterpret_cast<float*>(dSs);
  float* own_lse = reinterpret_cast<float*>(smem + 4 * G::kTile +
                                            2 * G::kPS + G::kSc);
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
  const T* qb = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* kb = static_cast<const T*>(p.k) + b * p.ksb + h * p.ksh;
  const T* vb = static_cast<const T*>(p.v) + b * p.vsb + h * p.vsh;
  const T* db = static_cast<const T*>(p.dout) + b * p.dsb + h * p.dsh;

  if (kDKV) {
    load_tile<T, D>(own1, kb, p.kss, own0, S);
    load_tile<T, D>(own2, vb, p.vss, own0, S);
  } else {
    load_tile<T, D>(own1, qb, p.qss, own0, S);
    load_tile<T, D>(own2, db, p.dss, own0, S);
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
    const T* ob = static_cast<const T*>(p.o) + b * p.osb + h * p.osh;
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr, pos = own0 + r;
      float s = 0.f;
      if (pos < S)
        for (int d = lane; d < D; d += 32)
          s += to_f(own2[r * G::LD + d]) * to_f(ob[pos * p.oss + d]);
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
      load_tile<T, D>(str1, qb, p.qss, str0, S);
      load_tile<T, D>(str2, db, p.dss, str0, S);
    } else {
      load_tile<T, D>(str1, kb, p.kss, str0, S);
      load_tile<T, D>(str2, vb, p.vss, str0, S);
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

    acc_a.mma(dS_w, str1, lane);        // dq += dS K  |  dk += dS^T Q
    if (kDKV) acc_b.mma(P_w, str2, lane);   // dv += P^T dO
  }

  // dq = scale dS K and dk = dS^T (scale q): the scale folds in here.
  const long long pitch = (long long)H * D;
  const int pos0 = own0 + warp * 16;
  T* out_a = static_cast<T*>(p.out_a) + ((long long)b * S * H + h) * D;
  acc_a.store(Sc_w, out_a, pitch, pos0, S, p.scale, lane);
  if (kDKV) {
    T* out_b = static_cast<T*>(p.out_b) + ((long long)b * S * H + h) * D;
    acc_b.store(Sc_w, out_b, pitch, pos0, S, 1.f, lane);
  }
}

template <typename T, int D, bool kDKV>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Geo<T, D>::kBytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_kernel<T, D, kDKV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((p.S + BT - 1) / BT, p.B * p.H);
  flash_bwd_kernel<T, D, kDKV><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kDKV>
int dispatch(const Params& p, int D, int dtype, cudaStream_t s) {
  if (dtype == 1 && D == 128) return (int)launch<bf16, 128, kDKV>(p, s);
  if (dtype == 1 && D == 64) return (int)launch<bf16, 64, kDKV>(p, s);
  if (dtype == 0 && D == 128) return (int)launch<float, 128, kDKV>(p, s);
  if (dtype == 0 && D == 64) return (int)launch<float, 64, kDKV>(p, s);
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

// Both entry points take the same arguments.  dtype: 0 = fp32, 1 = bf16;
// D in {64, 128}.  Strides (batch, seq, head) of q, k, v, o and dout, in
// elements; the last dim must be contiguous and every row start 16-byte
// aligned (the Python wrapper checks).  kv_mask is int32 [B, S] or null.
// lse and delta are fp32 [B*H, S]; outputs are contiguous [B, S, H, D] in
// the input dtype.  Returns cudaGetLastError().
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
