// Fused multi-head attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel nnstreamer_tpu/ops/attention.py:80
// (_fused_bshd, body _attn_kernel at :60). Same function: for every
// (batch, head), o = softmax(q k^T * D^-0.5) v over all keys (non-causal),
// with the scores and the softmax in f32 and o stored in the input dtype.
// Python side, plain version and routing: nnstreamer_tpu_torch/ops/attention.py.
//
// Layout: q, k, v and o are [B, S, H, D], read and written through their
// batch/sequence/head strides (in elements; the head dim is contiguous), so
// the caller makes no transpose or pad copies. Any S; D <= 128.
//
// Bound on an H100 SXM: q, k, v read once and o written once are
// 4*B*S*H*D*itemsize bytes at 3.35 TB/s; the two products are 4*B*H*S*S*D
// FLOP at 989 TFLOP/s (bf16/f16). At the ViT-B/16 shapes (S=196, H=12,
// D=64) bytes bound the call: 77 MB against 7.5 GFLOP at B=64, 23 us
// against 7.6 us. What the design does about it: every input byte crosses
// HBM once, no S x S score tile leaves the registers, the key/value tiles of
// one (b, h) are read by its neighbouring blocks from L2, and loads run
// ahead of the tensor-core work.
//
// bf16/f16: attention_fwd_mma_kernel, a FlashAttention-2 forward on the
// tensor cores.
//   * One block of 4 warps takes 64 query rows of one (b, h); each warp owns
//     16 rows, and its Q fragments stay in registers for the whole key loop.
//   * Keys and values go through shared memory in tiles of 64 rows x DP
//     (the head dim padded to 32, 64 or 128), in a ring of two stages:
//     cp.async moves 16 bytes a thread and the load of tile t+1 is in flight
//     while the warps compute on tile t. Where a row is not 16-byte aligned
//     the wrapper picks the element-staging instantiation, which fills the
//     same layout with 2-byte loads. Rows are padded by 8 elements (16
//     bytes), so the 8 row addresses of every ldmatrix fall in 8 disjoint
//     groups of 4 banks. Head-dim columns in [D, DP) and rows >= S are
//     zero-filled, so they add nothing to q.k^T and no stale shared memory
//     reaches an accumulator.
//   * S = Q K^T with mma.sync.m16n8k16 (bf16/f16 in, f32 accumulate), K
//     fragments by ldmatrix; keys >= S are set to -inf. The online softmax
//     runs on the accumulator fragments: the row max and row sum across the
//     4 lanes of a quad by __shfl_xor_sync (1, 2), exp2 of the scores scaled
//     by D^-0.5*log2(e), the O accumulators rescaled by exp(m_old - m_new).
//   * P is rounded to bf16/f16 in registers and used directly as the A
//     operand of O += P V (V fragments by ldmatrix.trans); P never goes
//     through shared memory. O is divided by the row sum once at the end and
//     stored through its strides, rows >= S and columns >= D skipped.
//   * Grid: q-tile index fastest, (b*h) slowest, so the blocks of one (b, h)
//     run together and share its K and V in L2.
//   * A block holds (64 + 4*64)*(DP+8)*2 bytes of dynamic shared memory,
//     46,080 at DP = 64; with 128 registers a thread there, four blocks fit
//     an SM. The alternatives measured against this shape (8 or 16 warps a
//     block, 2 warps, two 16-row tiles a warp, skipping key groups past S)
//     were no faster at the ViT shapes (times in PERF.md).
//   Rounding differs from the TPU kernel: that one rounds the normalised
//   probabilities to the input dtype before p.v; this one rounds the
//   unnormalised probabilities of each key tile (p <= 1 before the final
//   division) and divides the f32 p.v sums by the f32 row sum at the end.
//
// f32: attention_fwd_f32_kernel on the CUDA cores, f32 throughout (the
// tensor cores would take TF32 and miss the 1e-5 f32 contract): one block of
// 4 warps per (b*h, 16 query rows), key tiles of 32 staged as f32, lane j
// scores key j, each lane accumulates D/32 output columns of p.v.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxD = 128;  // largest head dim taken
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long b, s, h;
};

// ---------------------------------------------------------------------------
// f32: CUDA cores

constexpr int kF32Warps = 4;                          // warps per block
constexpr int kF32RowsPerWarp = 4;                    // query rows per warp
constexpr int kF32BlockQ = kF32Warps * kF32RowsPerWarp;  // rows per block
constexpr int kF32BlockK = 32;                        // keys per tile
constexpr int kF32ColsPerLane = kMaxD / 32;           // output cols per lane
constexpr int kF32KStride = kMaxD + 1;                // padded K row (banks)

__global__ void __launch_bounds__(kF32Warps * 32)
    attention_fwd_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             float* __restrict__ o, int S, int H, int D,
                             Strides qs, Strides ks, Strides vs, Strides os,
                             float scale) {
  __shared__ float q_s[kF32BlockQ][kMaxD];
  __shared__ float k_s[kF32BlockK][kF32KStride];
  __shared__ float v_s[kF32BlockK][kMaxD];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_qtiles = (S + kF32BlockQ - 1) / kF32BlockQ;
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x - bh * n_qtiles) * kF32BlockQ;
  const int b = bh / H;
  const int h = bh - b * H;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  float* ob = o + b * os.b + h * os.h;

  for (int i = tid; i < kF32BlockQ * D; i += kF32Warps * 32) {
    const int r = i / D;
    const int d = i - r * D;
    const int row = q0 + r;
    q_s[r][d] = row < S ? qb[row * qs.s + d] : 0.f;
  }

  float m[kF32RowsPerWarp];
  float l[kF32RowsPerWarp];
  float acc[kF32RowsPerWarp][kF32ColsPerLane];
#pragma unroll
  for (int rr = 0; rr < kF32RowsPerWarp; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < kF32ColsPerLane; ++c) acc[rr][c] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += kF32BlockK) {
    __syncthreads();  // the last tile is consumed (and q_s is written)
    for (int i = tid; i < kF32BlockK * D; i += kF32Warps * 32) {
      const int r = i / D;
      const int d = i - r * D;
      const int key = k0 + r;
      const bool ok = key < S;
      k_s[r][d] = ok ? kb[key * ks.s + d] : 0.f;
      v_s[r][d] = ok ? vb[key * vs.s + d] : 0.f;
    }
    __syncthreads();

    const bool key_ok = k0 + lane < S;
#pragma unroll
    for (int rr = 0; rr < kF32RowsPerWarp; ++rr) {
      const int r = warp * kF32RowsPerWarp + rr;
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
      for (int c = 0; c < kF32ColsPerLane; ++c) acc[rr][c] *= alpha;
      for (int j = 0; j < kF32BlockK; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
#pragma unroll
        for (int c = 0; c < kF32ColsPerLane; ++c) {
          const int d = lane + 32 * c;
          if (d < D) acc[rr][c] = fmaf(pj, v_s[j][d], acc[rr][c]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kF32RowsPerWarp; ++rr) {
    const int row = q0 + warp * kF32RowsPerWarp + rr;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < kF32ColsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) ob[row * os.s + d] = acc[rr][c] / l[rr];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16/f16: tensor cores

constexpr int kWarps = 4;                // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = 16 * kWarps;     // query rows per block
constexpr int kBlockN = 64;              // keys per tile
constexpr int kStages = 2;               // K/V ring depth

// shared memory of one block: Q tile + kStages x (K tile + V tile)
template <int DP>
constexpr int mma_smem_bytes() {
  return (kBlockM + 2 * kStages * kBlockN) * (DP + 8) * 2;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-fills when !full
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  // c += a b: a 16x16 row-major, b 16x8 column-major, c 16x8 f32
  static __device__ __forceinline__ void run(float (&c)[4],
                                             const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // two f32 -> one register of two bf16, lo in the low half (RN)
  static __device__ __forceinline__ unsigned pack(float lo, float hi) {
    __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<unsigned*>(&x);
  }
  static __device__ __forceinline__ __nv_bfloat16 cast(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&c)[4],
                                             const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ unsigned pack(float lo, float hi) {
    __half2 x = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<unsigned*>(&x);
  }
  static __device__ __forceinline__ __half cast(float x) {
    return __float2half_rn(x);
  }
};

// Stage rows [r0, r0 + kRows) x DP columns of one (b, h) into a padded
// tile. kVec: 16-byte cp.async (rows 16-byte aligned, D a multiple of 8);
// otherwise 2-byte loads and stores. Rows >= S and columns >= D are zeros.
template <typename T, int DP, bool kVec, int kRows>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long stride, int r0, int S,
                                          int D, int tid) {
  constexpr int kLd = DP + 8;
  if constexpr (kVec) {
    constexpr int kChunks = DP / 8;  // 16-byte chunks a row
#pragma unroll
    for (int j = 0; j < kRows * kChunks / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / kChunks;
      const int c = i - r * kChunks;
      const int row = r0 + r;
      const bool ok = row < S && c * 8 < D;
      cp_async_16(dst + r * kLd + c * 8, ok ? src + row * stride + c * 8 : src,
                  ok);
    }
  } else {
    const T zero = Mma<T>::cast(0.f);
#pragma unroll 4
    for (int j = 0; j < kRows * DP / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / DP;
      const int c = i - r * DP;
      const int row = r0 + r;
      dst[r * kLd + c] = (row < S && c < D) ? src[row * stride + c] : zero;
    }
  }
}

template <typename T, int DP, bool kVec>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_mma_kernel(const T* __restrict__ q,
                             const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ o,
                             int S, int H, int D, Strides qs, Strides ks,
                             Strides vs, Strides os, float scale_log2) {
  constexpr int kLd = DP + 8;       // padded tile row, elements
  constexpr int kSteps = DP / 16;   // k-steps of q.k^T
  constexpr int kOTiles = DP / 8;   // 8-column tiles of o
  constexpr int kSTiles = kBlockN / 8;  // 8-key tiles of a score tile
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + kBlockM * kLd;
  T* v_s = k_s + kStages * kBlockN * kLd;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t4 = lane & 3;  // fragment column pair
  const int n_qtiles = (S + kBlockM - 1) / kBlockM;
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x - bh * n_qtiles) * kBlockM;
  const int b = bh / H;
  const int h = bh - b * H;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  T* ob = o + b * os.b + h * os.h;

  const int n_ktiles = (S + kBlockN - 1) / kBlockN;
  load_tile<T, DP, kVec, kBlockM>(q_s, qb, qs.s, q0, S, D, tid);
  load_tile<T, DP, kVec, kBlockN>(k_s, kb, ks.s, 0, S, D, tid);
  load_tile<T, DP, kVec, kBlockN>(v_s, vb, vs.s, 0, S, D, tid);
  cp_async_commit();

  // a warp whose 16 rows all lie past S only helps to load
  const bool active = q0 + warp * 16 < S;
  unsigned qf[kSteps][4];
  float acc[kOTiles][4];
#pragma unroll
  for (int j = 0; j < kOTiles; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // row max (raw scores), rows g, g+8
  float l0 = 0.f, l1 = 0.f;              // this lane's share of the row sum

  for (int t = 0; t < n_ktiles; ++t) {
    const int stage = t % kStages;
    if (t + 1 < n_ktiles) {
      const int next = (t + 1) % kStages;
      load_tile<T, DP, kVec, kBlockN>(k_s + next * kBlockN * kLd, kb, ks.s,
                                      (t + 1) * kBlockN, S, D, tid);
      load_tile<T, DP, kVec, kBlockN>(v_s + next * kBlockN * kLd, vb, vs.s,
                                      (t + 1) * kBlockN, S, D, tid);
      cp_async_commit();
      cp_async_wait<1>();  // tile t (and Q) landed; tile t+1 in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (active) {
      if (t == 0) {
        // A fragments of Q: matrices (rows 0-7 | 8-15) x (cols 0-7 | 8-15)
        const T* base = q_s + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                                  * kLd + (lane >> 4) * 8;
#pragma unroll
        for (int s = 0; s < kSteps; ++s) ldsm_x4(qf[s], base + s * 16);
      }
      const T* kt = k_s + stage * kBlockN * kLd;
      const T* vt = v_s + stage * kBlockN * kLd;

      // scores of 16 rows x 64 keys: sc[j] is keys 8j..8j+7
      float sc[kSTiles][4];
#pragma unroll
      for (int j = 0; j < kSTiles; ++j)
        sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int n2 = 0; n2 < kSTiles / 2; ++n2) {
        // B fragments of two key tiles: (keys 0-7 | 8-15) x (d 0-7 | 8-15)
        const T* base = kt + (n2 * 16 + (lane & 7) + (lane >> 4) * 8) * kLd
                        + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          unsigned bf[4];
          ldsm_x4(bf, base + s * 16);
          Mma<T>::run(sc[2 * n2], qf[s], bf[0], bf[1]);
          Mma<T>::run(sc[2 * n2 + 1], qf[s], bf[2], bf[3]);
        }
      }
      const int k0 = t * kBlockN;
      if (k0 + kBlockN > S) {
#pragma unroll
        for (int j = 0; j < kSTiles; ++j) {
          const int key = k0 + j * 8 + 2 * t4;
          if (key >= S) sc[j][0] = sc[j][2] = -INFINITY;
          if (key + 1 >= S) sc[j][1] = sc[j][3] = -INFINITY;
        }
      }

      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
      }
      // key k0 < S in every tile, so mx0 and mx1 are finite
      const float alpha0 = exp2f((m0 - mx0) * scale_log2);  // 0 at t == 0
      const float alpha1 = exp2f((m1 - mx1) * scale_log2);
      m0 = mx0;
      m1 = mx1;
      const float off0 = mx0 * scale_log2, off1 = mx1 * scale_log2;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
        sc[j][0] = exp2f(fmaf(sc[j][0], scale_log2, -off0));  // 0 if masked
        sc[j][1] = exp2f(fmaf(sc[j][1], scale_log2, -off0));
        sc[j][2] = exp2f(fmaf(sc[j][2], scale_log2, -off1));
        sc[j][3] = exp2f(fmaf(sc[j][3], scale_log2, -off1));
        rs0 += sc[j][0] + sc[j][1];
        rs1 += sc[j][2] + sc[j][3];
      }
      l0 = l0 * alpha0 + rs0;
      l1 = l1 * alpha1 + rs1;
#pragma unroll
      for (int j = 0; j < kOTiles; ++j) {
        acc[j][0] *= alpha0;
        acc[j][1] *= alpha0;
        acc[j][2] *= alpha1;
        acc[j][3] *= alpha1;
      }

      // o += p v: the score fragments of keys 16kk..16kk+15 are the A
      // fragment of one k-step
#pragma unroll
      for (int kk = 0; kk < kSTiles / 2; ++kk) {
        const unsigned pa[4] = {
            Mma<T>::pack(sc[2 * kk][0], sc[2 * kk][1]),
            Mma<T>::pack(sc[2 * kk][2], sc[2 * kk][3]),
            Mma<T>::pack(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
            Mma<T>::pack(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
        // B fragments of two column tiles: (keys 0-7 | 8-15) x (d 0-7 | 8-15)
        const T* base = vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                                 * kLd + (lane >> 4) * 8;
#pragma unroll
        for (int d2 = 0; d2 < kOTiles / 2; ++d2) {
          unsigned bf[4];
          ldsm_x4_trans(bf, base + d2 * 16);
          Mma<T>::run(acc[2 * d2], pa, bf[0], bf[1]);
          Mma<T>::run(acc[2 * d2 + 1], pa, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // stage t is consumed before tile t+2 lands in it
  }

  if (!active) return;
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, off);
    l1 += __shfl_xor_sync(kFull, l1, off);
  }
  // pairs of columns as one 4-byte store where every row start is even
  const bool pairs = (D % 2 == 0) && (os.b % 2 == 0) && (os.s % 2 == 0) &&
                     (os.h % 2 == 0) &&
                     (reinterpret_cast<uintptr_t>(o) % 4 == 0);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + warp * 16 + g + half * 8;
    if (row >= S) continue;
    const float l = half ? l1 : l0;
    T* orow = ob + row * os.s;
#pragma unroll
    for (int j = 0; j < kOTiles; ++j) {
      const int c = j * 8 + 2 * t4;
      if (c >= D) continue;
      const float x = acc[j][2 * half] / l;
      const float y = acc[j][2 * half + 1] / l;
      if (pairs) {
        *reinterpret_cast<unsigned*>(orow + c) = Mma<T>::pack(x, y);
      } else {
        orow[c] = Mma<T>::cast(x);
        if (c + 1 < D) orow[c + 1] = Mma<T>::cast(y);
      }
    }
  }
}

// One tensor-core instantiation: its entry, dynamic shared memory, and the
// devices on which its shared-memory limit has been set.
struct MmaKernel {
  const void* fn;
  int smem;
  std::atomic<unsigned>* configured;
};

template <typename T, int DP, bool kVec>
MmaKernel mma_kernel() {
  static std::atomic<unsigned> configured{0};
  return {reinterpret_cast<const void*>(&attention_fwd_mma_kernel<T, DP, kVec>),
          mma_smem_bytes<DP>(), &configured};
}

template <typename T, bool kVec>
MmaKernel pick_dp(int D) {
  if (D <= 32) return mma_kernel<T, 32, kVec>();
  if (D <= 64) return mma_kernel<T, 64, kVec>();
  return mma_kernel<T, 128, kVec>();
}

template <typename T>
MmaKernel pick(int D, bool vec) {
  return vec ? pick_dp<T, true>(D) : pick_dp<T, false>(D);
}

// raise the instantiation's dynamic shared-memory limit once per device
int configure(const MmaKernel& kern) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned bit = 1u << (dev & 31);
  if (kern.configured->load(std::memory_order_acquire) & bit) return 0;
  err = cudaFuncSetAttribute(kern.fn,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kern.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern.configured->fetch_or(bit, std::memory_order_acq_rel);
  return 0;
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = float16, 2 = bfloat16 (tensor
// cores). Strides are in elements. vec16: stage q/k/v with 16-byte cp.async
// (every row 16-byte aligned and D*itemsize a multiple of 16; the caller
// checks), else with element loads; f32 ignores it. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int nns_attention_fwd(const void* q, const void* k, const void* v,
                                 void* o, int dtype, int B, int S, int H,
                                 int D, long long q_sb, long long q_ss,
                                 long long q_sh, long long k_sb,
                                 long long k_ss, long long k_sh,
                                 long long v_sb, long long v_ss,
                                 long long v_sh, long long o_sb,
                                 long long o_ss, long long o_sh, int vec16,
                                 float scale, void* stream) {
  if (B < 0 || S < 0 || H < 0 || D < 1 || D > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || H == 0) return 0;
  Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const long long blocks =
        static_cast<long long>(B) * H * ((S + kF32BlockQ - 1) / kF32BlockQ);
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    attention_fwd_f32_kernel<<<static_cast<unsigned>(blocks),
                               kF32Warps * 32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), S, H, D, qs, ks,
        vs, os, scale);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1 && dtype != 2) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks =
      static_cast<long long>(B) * H * ((S + kBlockM - 1) / kBlockM);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const MmaKernel kern = dtype == 1 ? pick<__half>(D, vec16 != 0)
                                    : pick<__nv_bfloat16>(D, vec16 != 0);
  const int err = configure(kern);
  if (err != 0) return err;
  float scale_log2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
  void* args[] = {&q, &k, &v, &o, &S, &H, &D, &qs, &ks, &vs, &os,
                  &scale_log2};
  const cudaError_t launched = cudaLaunchKernel(
      kern.fn, dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args,
      kern.smem, st);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return static_cast<int>(launched != cudaSuccess ? launched : last);
}

extern "C" const char* nns_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
