// LayerNorm forward over the last axis, fp32 statistics, fp32 output.
//
// Replaces: distributed_tensorflow_tpu/ops/pallas/layer_norm.py, _ln_kernel
// (launched by _ln_forward): one VMEM pass per row tile there.
//
// Bound on the H100: bytes.  Per row it reads H input values and writes H
// fp32 values and does ~8 flops per element, far below the ~295 flop/byte
// at which the tensor cores, let alone the CUDA cores, would become the
// limit.  The least time is (rows * H * (in_bytes + 4) + 8 H) / 3.35 TB/s:
// under 3 us at the serving shapes, where the launch and the host's call
// are the cost, and 30 us at the train step's 8192 x 2048 rows.
//
// Design, H <= 8192 (layer_norm_rows): a row lives in registers, spread
// over tpr = 32, 64 or 128 threads (the fewest that leave a thread at most
// kRowVals = 16 values; four warps from H = 2048 up), several rows to a
// 256-thread block.  Each thread reads its share with vector loads of
// kVec = 4 values (8 bytes of bf16/fp16, 16 of fp32; neighbouring threads
// on neighbouring vectors) and keeps it as fp32 in registers: the row is
// read once, and no pass after the load touches memory.  Scale and bias
// come in, and the output goes out, as 16-byte fp32 vectors, a warp's 512
// contiguous bytes an instruction.  The statistics reduce with warp
// shuffles; a row of several warps adds its warps' sums through a few
// bytes of shared memory (one __syncthreads per statistic).  Two-pass
// statistics (mean, then the mean of squared deviations) keep the variance
// exact for rows with a large mean, as the reference's fp32 formula does.
// The values a thread holds (8 to 64) are a template parameter, so the
// row's registers are sized at compile time.  An H that is not a multiple
// of kVec (or an unaligned operand) takes the same kernel with one-element
// accesses.  kVec and kRowVals were chosen by a same-call A/B of rebuilt
// variants (tools/layer_norm_ablation.py; PERF.md): on an NVIDIA H100
// 80GB HBM3 at 700 W this form took 0.0369 ms at the train step's rows
// against 0.0461 for one warp a row with 16-byte bf16 loads (each thread's
// two fp32 stores 32 bytes apart), and was faster at the serving rows too.
//
// Design, 8192 < H <= 56 Ki (layer_norm_smem): one block of 256 threads
// per row, the row staged in shared memory as fp32; the host wrapper
// raises above.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRegMaxH = 8192;     // layer_norm_rows up to here
// Values of x one access of layer_norm_rows reads (an H or an operand
// that does not allow it reads one).
template <typename T>
constexpr int kVec = 4;
// The most values a thread of layer_norm_rows holds before its row takes
// twice the threads (32 to 128).
constexpr int kRowVals = 16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// W consecutive values at p as fp32: one load of W * sizeof(T) = 16 or
// 8 bytes, or (W == 1) one element.
template <typename T, int W>
__device__ __forceinline__ void load_vals(const T* p, float* v) {
  if constexpr (W * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = to_float(e[i]);
  } else if constexpr (W * sizeof(T) == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = to_float(e[i]);
  } else {
    static_assert(W == 1, "1, 4 or 8 values an access");
    v[0] = to_float(*p);
  }
}

// E values a thread, W at a time (kVec: one vector access of x and W / 4
// of scale, bias and out; 1: one element), tpr = 32, 64 or 128 threads a
// row.
template <typename T, int E, int W>
__global__ void __launch_bounds__(kThreads)
layer_norm_rows(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ bias, float* __restrict__ out,
                long long rows, int H, int tpr, float eps) {
  constexpr int NC = E / W;                      // accesses a thread
  __shared__ float red[2][kThreads / 32];        // warp sums, per statistic
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j = threadIdx.x % tpr;               // thread within the row
  const long long r = (long long)blockIdx.x * (kThreads / tpr) +
                      threadIdx.x / tpr;
  const bool live = r < rows;
  const T* xr = x + r * H;

  float v[E];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int col = (j + k * tpr) * W;
    if (live && col < H) {
      load_vals<T, W>(xr + col, v + k * W);
#pragma unroll
      for (int i = 0; i < W; ++i) s += v[k * W + i];
    }
  }

  // The row's sum over its warps (uniform branch: tpr is the block's).
  auto row_sum = [&](float a, int slot) {
    a = warp_sum(a);
    if (tpr > 32) {
      if (lane == 0) red[slot][warp] = a;
      __syncthreads();
      const int w0 = (threadIdx.x / tpr) * (tpr / 32);
      a = 0.f;
      for (int w = 0; w < tpr / 32; ++w) a += red[slot][w0 + w];
    }
    return a;
  };
  const float mean = row_sum(s, 0) / H;

  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int col = (j + k * tpr) * W;
    if (live && col < H) {
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const float c = v[k * W + i] - mean;
        ss += c * c;
      }
    }
  }
  const float inv = rsqrtf(row_sum(ss, 1) / H + eps);

  if (!live) return;
  float* outr = out + r * H;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int col = (j + k * tpr) * W;
    if (col >= H) continue;
    if constexpr (W > 1) {
#pragma unroll
      for (int q = 0; q < W; q += 4) {
        const float4 g = *reinterpret_cast<const float4*>(scale + col + q);
        const float4 b = *reinterpret_cast<const float4*>(bias + col + q);
        const float* e = v + k * W + q;
        *reinterpret_cast<float4*>(outr + col + q) = make_float4(
            (e[0] - mean) * inv * g.x + b.x, (e[1] - mean) * inv * g.y + b.y,
            (e[2] - mean) * inv * g.z + b.z, (e[3] - mean) * inv * g.w + b.w);
      }
    } else {
      outr[col] = (v[k] - mean) * inv * scale[col] + bias[col];
    }
  }
}

// Sum over the block; every thread gets the result.  `scratch` holds one
// float per warp.
__device__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // scratch may still be read by a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += scratch[w];
  return total;
}

// One block per row, the row staged in shared memory as fp32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
layer_norm_smem(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ bias, float* __restrict__ out,
                int H, float eps) {
  extern __shared__ float row[];        // [H] fp32 copy of this row
  __shared__ float scratch[kThreads / 32];
  const long long r = blockIdx.x;
  const T* xr = x + r * H;
  float* outr = out + r * H;

  float s = 0.f;
  for (int i = threadIdx.x; i < H; i += kThreads) {
    const float v = to_float(xr[i]);
    row[i] = v;
    s += v;
  }
  const float mean = block_sum(s, scratch) / H;

  float ss = 0.f;
  for (int i = threadIdx.x; i < H; i += kThreads) {
    const float c = row[i] - mean;
    ss += c * c;
  }
  const float var = block_sum(ss, scratch) / H;
  const float inv = rsqrtf(var + eps);

  for (int i = threadIdx.x; i < H; i += kThreads)
    outr[i] = (row[i] - mean) * inv * scale[i] + bias[i];
}

template <typename T, int E, int W>
void launch_rows(const void* x, const void* scale, const void* bias,
                 void* out, long long rows, int H, int tpr, float eps,
                 cudaStream_t stream) {
  const long long per_block = kThreads / tpr;
  layer_norm_rows<T, E, W>
      <<<(unsigned)((rows + per_block - 1) / per_block), kThreads, 0,
         stream>>>(static_cast<const T*>(x),
                   static_cast<const float*>(scale),
                   static_cast<const float*>(bias), static_cast<float*>(out),
                   rows, H, tpr, eps);
}

// kVec values an access when H is a multiple of kVec and all four
// operands start on 16-byte boundaries, else one element an access.
template <typename T>
bool vectors(const void* x, const void* scale, const void* bias,
             const void* out, int H) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(scale) |
                         reinterpret_cast<uintptr_t>(bias) |
                         reinterpret_cast<uintptr_t>(out);
  return H % kVec<T> == 0 && ptrs % 16 == 0;
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, const void* bias,
                   void* out, long long rows, int H, float eps,
                   cudaStream_t stream) {
  if (H <= kRegMaxH) {
    int tpr = 32;                                 // threads a row
    while (tpr < 128 && tpr * kRowVals < H) tpr *= 2;
    const int need = (H + tpr - 1) / tpr;         // values a thread
    const bool vec = vectors<T>(x, scale, bias, out, H);
#define DTT_LN_ROWS(E)                                                      \
    if (need <= E) {                                                        \
      if (vec)                                                              \
        launch_rows<T, E, kVec<T>>(x, scale, bias, out, rows, H, tpr, eps,  \
                                   stream);                                 \
      else                                                                  \
        launch_rows<T, E, 1>(x, scale, bias, out, rows, H, tpr, eps,        \
                             stream);                                       \
      return cudaGetLastError();                                            \
    }
    DTT_LN_ROWS(8)
    DTT_LN_ROWS(16)
    DTT_LN_ROWS(32)
    DTT_LN_ROWS(64)
#undef DTT_LN_ROWS
  }
  const size_t smem = sizeof(float) * (size_t)H;
  if (smem > 48 * 1024) {
    // Once per device, for the widest row the wrapper admits (56 Ki).
    static bool done[dtt::kMaxDevices];
    cudaError_t e = dtt::opt_in_smem(layer_norm_smem<T>,
                                     sizeof(float) * 56 * 1024, done);
    if (e != cudaSuccess) return e;
  }
  layer_norm_smem<T><<<(unsigned)rows, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<float*>(out), H, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, 2 = fp16.  Returns cudaGetLastError().
extern "C" int dtt_layer_norm_fwd(const void* x, const void* scale,
                                  const void* bias, void* out, long long rows,
                                  int H, float eps, int dtype, void* stream) {
  if (rows <= 0 || H <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(x, scale, bias, out, rows, H, eps, s);
    case 1:
      return (int)launch<__nv_bfloat16>(x, scale, bias, out, rows, H, eps, s);
    case 2: return (int)launch<__half>(x, scale, bias, out, rows, H, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* dtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
