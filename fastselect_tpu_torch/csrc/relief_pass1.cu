// Relief pass 1 on Hopper: the pairwise distance matrix
//
//   D[i, j] = sum_f diff(xi[i, f], xp[j, f])
//   diff    = 1[x_if != x_jf]           where disc[f] > 0 (MIXED only)
//           = |x_if - x_jf| * recip[f]  otherwise
//
// Replaces the Pallas kernels `_dist_kernel` (MIXED = true) and
// `_dist_kernel_cont` (MIXED = false) of fastselect_tpu/ops/relief_pallas.py.
//
// What bounds it on the H100: FP32 issue.  An |a - b| sum has no
// tensor-core form, and the contract with the plain version
// (`dist_matrix_ref`) is bit equality: every pair adds its features in
// order with separately rounded subtract, multiply and add (no FMA), 3 FP32
// instructions a continuous pair-feature, against O(nb * n) bytes of D.  At
// large-n (25,024 x 50,048 pairs, 100 features) that is 11.2 ms of issue at
// the 1.98 GHz boost clock and 1.5 ms of D at 3.35 TB/s.
//
// What the design does about it:
//  - a 128 x 128 block tile, 256 threads, each holding an 8 x 8 register
//    tile of D: per 4 features a thread reads 8 + 8 + 1 16-byte shared
//    words for 768 FP32 instructions, so shared-load issue stays far below
//    the FP32 pipes' rate; that 4-feature step is the unit of code (a
//    stage unrolled whole ran slower), and two blocks fit on an SM;
//  - row-major [row][feature] tiles, each row padded by 4 floats, so that
//    the 16-byte reads of 8 consecutive rows by a quarter-warp fall on 8
//    distinct bank groups and need no transpose;
//  - 16-feature stages copied with 16-byte `cp.async` into a two-stage
//    ring, the next stage in flight while the current one computes (rows
//    are 16-byte aligned: p is a multiple of 4, which the wrapper checks);
//  - when the tile grid cannot fill the card (p >> n), blockIdx.z splits
//    the features into contiguous ranges of `split` features; each split
//    sums its range from 0.0 in order into its own partial D, and a second
//    small kernel adds the partials in split order.  `dist_matrix_ref`
//    follows the same plan (`relief_cuda.pass1_splits`), so D stays equal
//    to it bit for bit;
//  - MIXED: the kind of a column is read from `disc`, staged beside recip,
//    once a 4-feature step, and the whole step takes one branch, the same
//    for every thread of the block.  The fused engine orders its columns
//    by kind (the discrete run, then the continuous run, each padded to 4),
//    so every step is of one kind: continuous steps are the code above,
//    discrete steps cost 2 instructions a pair-feature (compare, then a
//    predicated add of 1.0; adding 0.0 to a sum changes no bit).  A step
//    whose 4 columns mix kinds (a caller's own `disc`) selects per element.
// Ragged edges of nb, n and a split are masked: rows and features out of
// range load as 0 with recip 0 and add +0.0.

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "relief_diff.cuh"

namespace {

constexpr int kTile = 128;                  // focal rows = samples per block
constexpr int kT = 16;                      // threads along each side
constexpr int kR = kTile / kT;              // 8 x 8 register tile
constexpr int kThreads = kT * kT;
constexpr int kBK = 16;                     // features per stage
constexpr int kLd = kBK + 4;                // padded row, in floats
constexpr int kStages = 2;

// one stage: xi rows [kTile][kLd], xp rows [kTile][kLd], recip [kBK] and,
// MIXED, disc [kBK]
template <bool MIXED>
__host__ __device__ constexpr int stage_floats() {
  return 2 * kTile * kLd + (MIXED ? 2 : 1) * kBK;
}
template <bool MIXED>
constexpr int smem_bytes() {
  return kStages * stage_floats<MIXED>() * sizeof(float);
}

enum Kind { kCont, kDisc, kMix };

__device__ __forceinline__ float add1(float acc, float a, float b, float r) {
  return __fadd_rn(acc, __fmul_rn(fabsf(__fsub_rn(a, b)), r));
}

template <int KIND>
__device__ __forceinline__ float step1(float acc, float a, float b, float r,
                                       float d) {
  if constexpr (KIND == kCont) return add1(acc, a, b, r);
  if constexpr (KIND == kDisc) return fs::add_ne(acc, a, b, 1.f);
  return d > 0.f ? fs::add_ne(acc, a, b, 1.f) : add1(acc, a, b, r);
}

// one 4-feature step of the thread's 8 x 8 tile, features in order
template <int KIND>
__device__ __forceinline__ void step4(float (&acc)[kR][kR],
                                      const float4 (&a)[kR],
                                      const float* sb, int tx, int k,
                                      float4 rc, float4 dc) {
#pragma unroll
  for (int c = 0; c < kR; ++c) {
    const float4 b =
        *reinterpret_cast<const float4*>(sb + (tx + kT * c) * kLd + k);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      float s = acc[r][c];
      s = step1<KIND>(s, a[r].x, b.x, rc.x, dc.x);
      s = step1<KIND>(s, a[r].y, b.y, rc.y, dc.y);
      s = step1<KIND>(s, a[r].z, b.z, rc.z, dc.z);
      s = step1<KIND>(s, a[r].w, b.w, rc.w, dc.w);
      acc[r][c] = s;
    }
  }
}

// out[z] (nb, n) = the sum over features [z * split, (z + 1) * split) of
// split z = blockIdx.z.
template <bool MIXED>
__global__ void __launch_bounds__(kThreads, 2)
dist_kernel(const float* __restrict__ xi, const float* __restrict__ xp,
            const float* __restrict__ recip, const float* __restrict__ disc,
            float* __restrict__ out, int nb, int n, int p, int split) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kStageFloats = stage_floats<MIXED>();
  const int tid = threadIdx.x;
  const int tx = tid % kT;
  const int ty = tid / kT;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int f_begin = blockIdx.z * split;
  const int f_end = min(p, f_begin + split);
  const int n_stages = (f_end - f_begin + kBK - 1) / kBK;

  auto load = [&](int stage, int f0) {
    float* sa = smem + stage * kStageFloats;
    float* sb = sa + kTile * kLd;
    float* sr = sb + kTile * kLd;
#pragma unroll
    for (int k = 0; k < kTile * (kBK / 4) / kThreads; ++k) {
      const int e = tid + k * kThreads;
      const int row = e / (kBK / 4);
      const int c = (e % (kBK / 4)) * 4;
      const int gf = f0 + c;
      const bool i_ok = gf < f_end && i0 + row < nb;
      const bool j_ok = gf < f_end && j0 + row < n;
      fs::cp_async16(sa + row * kLd + c,
                     i_ok ? xi + (long long)(i0 + row) * p + gf : xi, i_ok);
      fs::cp_async16(sb + row * kLd + c,
                     j_ok ? xp + (long long)(j0 + row) * p + gf : xp, j_ok);
    }
    if (tid < kBK / 4) {
      const int gf = f0 + tid * 4;
      const bool ok = gf < f_end;
      fs::cp_async16(sr + tid * 4, ok ? recip + gf : recip, ok);
      if constexpr (MIXED)
        fs::cp_async16(sr + kBK + tid * 4, ok ? disc + gf : disc, ok);
    }
  };

  float acc[kR][kR];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int c = 0; c < kR; ++c) acc[r][c] = 0.f;

  load(0, f_begin);
  fs::cp_async_commit();
  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) load((s + 1) % kStages, f_begin + (s + 1) * kBK);
    fs::cp_async_commit();
    fs::cp_async_wait<1>();     // stage s has landed
    __syncthreads();
    const float* sa = smem + (s % kStages) * kStageFloats;
    const float* sb = sa + kTile * kLd;
    const float* sr = sb + kTile * kLd;
    const int live = f_end - f_begin - s * kBK;   // features in this stage
#pragma unroll 1     // one 4-feature step: 768 FP32 instructions
    for (int k = 0; k < kBK; k += 4) {
      if (k >= live) break;     // a ragged last stage skips its padding
      const float4 rc = *reinterpret_cast<const float4*>(sr + k);
      float4 a[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r)
        a[r] = *reinterpret_cast<const float4*>(sa + (ty + kT * r) * kLd + k);
      if constexpr (MIXED) {    // the step's kind: uniform over the block
        const float4 dc = *reinterpret_cast<const float4*>(sr + kBK + k);
        const int n_disc = (dc.x > 0.f) + (dc.y > 0.f) + (dc.z > 0.f) +
                           (dc.w > 0.f);
        if (n_disc == 4)
          step4<kDisc>(acc, a, sb, tx, k, rc, dc);
        else if (n_disc == 0)
          step4<kCont>(acc, a, sb, tx, k, rc, dc);
        else
          step4<kMix>(acc, a, sb, tx, k, rc, dc);
      } else {
        step4<kCont>(acc, a, sb, tx, k, rc, rc);
      }
    }
    __syncthreads();            // the stage may be overwritten next
  }

  float* o = out + (long long)blockIdx.z * nb * n;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int gi = i0 + ty + kT * r;
#pragma unroll
    for (int c = 0; c < kR; ++c) {
      const int gj = j0 + tx + kT * c;
      if (gi < nb && gj < n) o[(long long)gi * n + gj] = acc[r][c];
    }
  }
}

// d[e] = partial[0][e] + partial[1][e] + ... in split order.
__global__ void split_sum_kernel(const float* __restrict__ partial,
                                 float* __restrict__ d, long long count,
                                 int splits) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < count; e += (long long)gridDim.x * blockDim.x) {
    float s = partial[e];
    for (int k = 1; k < splits; ++k) s = __fadd_rn(s, partial[k * count + e]);
    d[e] = s;
  }
}

template <bool MIXED>
int launch(const void* xi, const void* xp, const void* recip,
           const void* disc, void* d, void* partial, int nb, int n, int p,
           int split, int splits, void* stream) {
  if (p % 4 != 0 || split % 4 != 0 || split <= 0 || splits < 1 ||
      (long long)(splits - 1) * split >= p || (splits > 1 && !partial))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = fs::allow_smem(dist_kernel<MIXED>, smem_bytes<MIXED>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kTile - 1) / kTile, (nb + kTile - 1) / kTile, splits);
  float* out = static_cast<float*>(splits > 1 ? partial : d);
  dist_kernel<MIXED><<<grid, kThreads, smem_bytes<MIXED>(), s>>>(
      static_cast<const float*>(xi), static_cast<const float*>(xp),
      static_cast<const float*>(recip), static_cast<const float*>(disc), out,
      nb, n, p, split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long count = (long long)nb * n;
  const long long want = (count + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  split_sum_kernel<<<blocks, 256, 0, s>>>(out, static_cast<float*>(d), count,
                                          splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// D (nb, n) = pass 1 of focal rows xi (nb, p) against samples xp (n, p),
// float32, row-major and contiguous, rows 16-byte aligned (p a multiple of
// 4); recip (and disc) are (p,).  The features run in `splits` contiguous
// ranges of `split` features (a multiple of 4; the last range is ragged);
// with splits > 1, `partial` holds (splits, nb, n) floats of scratch.
// Launches on `stream` and returns cudaGetLastError() of the launches.
extern "C" int fs_relief_pass1_cont(const void* xi, const void* xp,
                                    const void* recip, void* d,
                                    void* partial, int nb, int n, int p,
                                    int split, int splits, void* stream) {
  return launch<false>(xi, xp, recip, nullptr, d, partial, nb, n, p, split,
                       splits, stream);
}

// The same with Hamming diffs on the columns where disc > 0 (16-byte
// aligned too).
extern "C" int fs_relief_pass1_mixed(const void* xi, const void* xp,
                                     const void* recip, const void* disc,
                                     void* d, void* partial, int nb, int n,
                                     int p, int split, int splits,
                                     void* stream) {
  return launch<true>(xi, xp, recip, disc, d, partial, nb, n, p, split,
                      splits, stream);
}

// Message for a CUDA error code returned by the entry points.
extern "C" const char* fs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
