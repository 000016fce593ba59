// uint8 -> scaled float for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel nnstreamer_tpu/ops/normalize.py
// (_normalize_pallas / _kernel). Same function, element by element:
//   out[i] = round_rn(((float)x[i] - offset) * scale)
// in the output dtype (float32, float16 or bfloat16). The subtraction and
// the product are separate round-to-nearest f32 operations (__fsub_rn,
// __fmul_rn), so nvcc cannot contract them into an FMA or reassociate
// them into x*scale - offset*scale; the result is rounded to the output
// dtype once. Python side, plain version and bound:
// nnstreamer_tpu_torch/ops/normalize.py.
//
// Bound: n bytes in and n * itemsize bytes out, one pass, no reuse, so
// the kernel is bound by device memory (3.35 TB/s); a frame of
// 224x224x3 moves 0.45 MB (about 0.13 us) and is launch-bound.
//
// Schedule: the function, not the TPU's tiling. One flat grid-stride loop
// over the n elements, no padding, any n. Each thread loads 16 bytes of
// u8 at once (uint4) and writes its 16 outputs with 16-byte stores (two
// for bf16/f16, four for f32). A scalar loop takes the n % 16 tail, and
// the whole range when the input or output pointer is not 16-byte
// aligned (a view with a storage offset).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;  // 16 blocks a Hopper SM
constexpr int kVec = 16;                    // u8 elements per vector load

__device__ __forceinline__ float affine(unsigned v, float offset,
                                        float scale) {
  return __fmul_rn(__fsub_rn(static_cast<float>(v), offset), scale);
}

template <typename T>
__device__ __forceinline__ T cvt(float y);
template <>
__device__ __forceinline__ float cvt<float>(float y) { return y; }
template <>
__device__ __forceinline__ __half cvt<__half>(float y) {
  return __float2half_rn(y);
}
template <>
__device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16>(float y) {
  return __float2bfloat16_rn(y);
}

__device__ __forceinline__ unsigned bits16(__half h) {
  return __half_as_ushort(h);
}
__device__ __forceinline__ unsigned bits16(__nv_bfloat16 h) {
  return __bfloat16_as_ushort(h);
}

// 16 results to 16-byte-aligned ``o``: four float4 stores for f32 ...
__device__ __forceinline__ void store16(float* o, const float (&y)[kVec]) {
  float4* d = reinterpret_cast<float4*>(o);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    d[j] = make_float4(y[4 * j], y[4 * j + 1], y[4 * j + 2], y[4 * j + 3]);
}

// ... two uint4 stores of packed halves for f16/bf16
template <typename T>
__device__ __forceinline__ void store16(T* o, const float (&y)[kVec]) {
  unsigned w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    w[j] = bits16(cvt<T>(y[2 * j])) | (bits16(cvt<T>(y[2 * j + 1])) << 16);
  uint4* d = reinterpret_cast<uint4*>(o);
  d[0] = make_uint4(w[0], w[1], w[2], w[3]);
  d[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// ``groups`` 16-element vectors from the start (0 when unaligned), then
// the scalar remainder [16 * groups, n)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    normalize_kernel(const unsigned char* __restrict__ x, T* __restrict__ o,
                     long long n, long long groups, float offset,
                     float scale) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  for (long long g = tid; g < groups; g += stride) {
    const uint4 v = xv[g];
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
    float y[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      y[i] = affine((w[i >> 2] >> (8 * (i & 3))) & 0xffu, offset, scale);
    store16(o + g * kVec, y);
  }
  for (long long i = groups * kVec + tid; i < n; i += stride)
    o[i] = cvt<T>(affine(x[i], offset, scale));
}

template <typename T>
void launch(const void* x, void* o, long long n, float offset, float scale,
            cudaStream_t stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(o) % 16 == 0);
  const long long groups = aligned ? n / kVec : 0;
  const long long work = groups > n - groups * kVec ? groups
                                                    : n - groups * kVec;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  normalize_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                        stream>>>(static_cast<const unsigned char*>(x),
                                  static_cast<T*>(o), n, groups, offset,
                                  scale);
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. x: n bytes of uint8,
// o: n elements of dtype, both contiguous. Returns cudaGetLastError()
// after the launch (0 on success); n == 0 launches nothing.
extern "C" int nns_normalize_u8(const void* x, void* o, long long n,
                                int dtype, float offset, float scale,
                                void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch<float>(x, o, n, offset, scale, st);
      break;
    case 1:
      launch<__half>(x, o, n, offset, scale, st);
      break;
    case 2:
      launch<__nv_bfloat16>(x, o, n, offset, scale, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nns_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
