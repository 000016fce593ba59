// Fused multi-head attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel nnstreamer_tpu/ops/attention.py
// (_fused_bshd / _attn_kernel). Same function: for every (batch, head),
// o = softmax(q k^T * scale) v over all keys (non-causal), with the scores,
// the softmax and the p.v sums in f32 and o stored in the input dtype.
// Python side, plain version and bound: nnstreamer_tpu_torch/ops/attention.py.
//
// Layout: q, k, v and o are [B, S, H, D], read and written through their
// batch/sequence/head strides (in elements; the head dim is contiguous), so
// the caller makes no transpose or pad copies. Any S; D <= 128.
//
// Schedule: one block of 4 warps per (b*h, tile of 16 query rows); each
// warp owns 4 rows. The block walks the keys in tiles of 32, staged in
// shared memory as f32. For one row and one key tile, lane j computes the
// score of key j (a D-long dot product against a padded K row, so the 32
// lanes hit 32 different banks), the warp takes the tile's max and sum by
// shuffles, and an online softmax rescales the running row sum and the
// f32 accumulators. Each lane accumulates D/32 output columns of p.v,
// taking p_j from lane j by shuffle. No S x S buffer exists anywhere.
//
// Rounding differs from the TPU kernel: that one rounds the normalised
// probabilities to the input dtype before p.v; here the unnormalised
// probabilities of each tile stay in f32 and the row sum divides the
// accumulators once at the end, so o is rounded to the input dtype once.
//
// The products run on the CUDA cores in f32, not on the tensor cores:
// simple and exact first; wgmma and TMA are for a later change.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kMaxD = 128;                      // largest head dim taken
constexpr int kWarps = 4;                       // warps per block
constexpr int kRowsPerWarp = 4;                 // query rows per warp
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBlockK = 32;                     // keys per tile: one a lane
constexpr int kColsPerLane = kMaxD / 32;        // output columns per lane
constexpr int kKStride = kMaxD + 1;             // padded K row (banks)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Strides {
  long long b, s, h;
};

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o, int S,
                         int H, int D, Strides qs, Strides ks, Strides vs,
                         Strides os, float scale) {
  __shared__ float q_s[kBlockQ][kMaxD];
  __shared__ float k_s[kBlockK][kKStride];
  __shared__ float v_s[kBlockK][kMaxD];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_qtiles = (S + kBlockQ - 1) / kBlockQ;
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x - bh * n_qtiles) * kBlockQ;
  const int b = bh / H;
  const int h = bh - b * H;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int i = tid; i < kBlockQ * D; i += kWarps * 32) {
    const int r = i / D;
    const int d = i - r * D;
    const int row = q0 + r;
    q_s[r][d] = row < S ? to_f32(qb[row * qs.s + d]) : 0.f;
  }

  float m[kRowsPerWarp];
  float l[kRowsPerWarp];
  float acc[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) acc[rr][c] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += kBlockK) {
    __syncthreads();  // the last tile is consumed (and q_s is written)
    for (int i = tid; i < kBlockK * D; i += kWarps * 32) {
      const int r = i / D;
      const int d = i - r * D;
      const int key = k0 + r;
      const bool ok = key < S;
      k_s[r][d] = ok ? to_f32(kb[key * ks.s + d]) : 0.f;
      v_s[r][d] = ok ? to_f32(vb[key * vs.s + d]) : 0.f;
    }
    __syncthreads();

    const bool key_ok = k0 + lane < S;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      if (q0 + r >= S) continue;  // uniform across the warp

      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(q_s[r][d], k_s[lane][d], dot);
      const float score = key_ok ? dot * scale : -INFINITY;

      float tile_max = score;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(kFull, tile_max, off));
      // lane 0's key is always in range, so m_new is finite
      const float m_new = fmaxf(m[rr], tile_max);
      const float alpha = expf(m[rr] - m_new);  // 0 on the first tile
      const float p = expf(score - m_new);      // 0 for a masked key
      float tile_sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tile_sum += __shfl_xor_sync(kFull, tile_sum, off);
      l[rr] = l[rr] * alpha + tile_sum;
      m[rr] = m_new;

#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) acc[rr][c] *= alpha;
      for (int j = 0; j < kBlockK; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) {
          const int d = lane + 32 * c;
          if (d < D) acc[rr][c] = fmaf(pj, v_s[j][d], acc[rr][c]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + warp * kRowsPerWarp + rr;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) ob[row * os.s + d] = from_f32<T>(acc[rr][c] / l[rr]);
    }
  }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, void* o, int S,
            int H, int D, Strides qs, Strides ks, Strides vs, Strides os,
            float scale, unsigned blocks, cudaStream_t stream) {
  attention_fwd_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, D, qs, ks, vs, os,
      scale);
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. Strides are in elements.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int nns_attention_fwd(const void* q, const void* k, const void* v,
                                 void* o, int dtype, int B, int S, int H,
                                 int D, long long q_sb, long long q_ss,
                                 long long q_sh, long long k_sb,
                                 long long k_ss, long long k_sh,
                                 long long v_sb, long long v_ss,
                                 long long v_sh, long long o_sb,
                                 long long o_ss, long long o_sh, float scale,
                                 void* stream) {
  if (B < 0 || S < 0 || H < 0 || D < 1 || D > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || H == 0) return 0;
  const long long blocks =
      static_cast<long long>(B) * H * ((S + kBlockQ - 1) / kBlockQ);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  const unsigned n = static_cast<unsigned>(blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch<float>(q, k, v, o, S, H, D, qs, ks, vs, os, scale, n, st);
      break;
    case 1:
      launch<__half>(q, k, v, o, S, H, D, qs, ks, vs, os, scale, n, st);
      break;
    case 2:
      launch<__nv_bfloat16>(q, k, v, o, S, H, D, qs, ks, vs, os, scale, n,
                            st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nns_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
