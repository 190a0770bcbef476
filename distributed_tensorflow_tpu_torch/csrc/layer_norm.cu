// LayerNorm forward over the last axis, fp32 statistics, fp32 output.
//
// Replaces: distributed_tensorflow_tpu/ops/pallas/layer_norm.py, _ln_kernel
// (launched by _ln_forward): one VMEM pass per row tile there.
//
// Bound on the H100: bytes.  Per row it reads H input values and writes H
// fp32 values and does ~8 flops per element, far below the ~295 flop/byte
// at which the tensor cores, let alone the CUDA cores, would become the
// limit.  The least time is (rows * H * (in_bytes + 4) + 8 H) / 3.35 TB/s.
//
// Design: one block of 256 threads per row.  The row is read from device
// memory once, converted to fp32 into shared memory, and every later pass
// (mean, centred variance, normalise, scale and shift) reads shared memory
// only; the output is written once.  Two-pass statistics (mean, then the
// mean of squared deviations) keep the variance exact for rows with a
// large mean, as the reference's fp32 formula does.  Any H that fits in
// shared memory as fp32 (H <= 56K) is taken; the host wrapper raises above.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// Sum over the block; every thread gets the result.  `scratch` holds one
// float per warp.
__device__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // scratch may still be read by a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += scratch[w];
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
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

template <typename T>
cudaError_t launch(const void* x, const void* scale, const void* bias,
                   void* out, long long rows, int H, float eps,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)H;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        layer_norm_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  layer_norm_fwd_kernel<T><<<(unsigned)rows, kThreads, smem, stream>>>(
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
