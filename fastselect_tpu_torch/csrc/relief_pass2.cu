// Relief pass 2 on Hopper: per-feature scores from the pair weights
//
//   partial[t, f] = sum_{i in focal tile} sum_{j in sample span}
//                   W[i, j] * diff(xi[i, f], xp[j, f])
//
// with diff as in pass 1, for tile t = (focal tile, sample span); the
// wrapper sums the partial rows in a fixed order, so scores are bitwise the
// same from run to run: no float atomics.  Replaces the Pallas kernels
// `_accum_kernel_cont` (`accum_kernel_cont`) and `_accum_kernel`
// (`accum_kernel_mixed`) of fastselect_tpu/ops/relief_pallas.py.  The TPU
// kept one score block resident across a sequential grid; here blocks run
// in any order and each writes its own row.
//
// What bounds it on the H100: FP32 issue, 2 instructions a pair-feature
// (continuous: subtract, then FMA of |d| by the weight, recip scaling the
// finished sum once; discrete: compare, then a predicated add of the
// weight), against O(nb * n) bytes of W.  At large-n (25,024 x 50,048
// pairs, 100 features) that is 7.5 ms of issue at the 1.98 GHz boost clock
// and 1.5 ms of W at 3.35 TB/s.
//
// What the design does about it:
//  - a thread owns 4 features (one float4 group) of 8 focal rows: their xi
//    values stay in registers for the whole launch, beside 32 independent
//    accumulators, so no FMA waits on the one before;
//  - per 4 samples it reads one 16-byte W word for each of its 8 rows and
//    one 16-byte xp word for each sample (12 shared loads for 256 FP32
//    instructions); its rows are rg, rg + R, ..., so that the row groups of
//    one warp read W rows that sit in distinct bank groups (rows are padded
//    by 4 floats);
//  - a block is `groups` float4 groups by `rows` row groups (at most 256
//    threads): at p = 100 that is 25 x 10 threads, 2% of them idle, and all
//    features of a p up to 128 sit in one block, so W comes from device
//    memory once per launch; a larger p tiles the features along
//    blockIdx.x, so the feature tiles of one focal tile run next to each
//    other and share its W rows in L2;
//  - W and xp stages of 64 samples are copied with 16-byte `cp.async` into
//    a two-stage ring (rows 16-byte aligned: p and n multiples of 4, which
//    the wrapper checks);
//  - blockIdx.z splits the samples into spans when the focal and feature
//    tiles alone would leave the card's 132 SMs short of blocks;
//  - MIXED: the feature tiles of the discrete run [0, p_disc) come first
//    along blockIdx.x, then those of the continuous run [p_disc, p), so
//    that when the columns are ordered by kind (the fused engine's layout)
//    no block holds both kinds.  A thread reads the kind of its 4 columns
//    from `disc` once (all discrete, all continuous, or, for a caller's
//    own `disc`, mixed and selected per element) and takes that branch for
//    every stage: the same branch for a whole block of one run.  Its three
//    loops would take 174 registers, one block an SM; bounded to two
//    blocks an SM it takes 128 and spills 24 bytes, and ran faster so at
//    the mixed-xl focal block and the all-discrete shape.
// The plan (groups, rows, spans) is `relief_cuda.pass2_plan`.  Ragged
// edges are masked: rows, samples and features out of range load as 0 and
// add 0 * |a - b| = +0.0.

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "relief_diff.cuh"

namespace {

constexpr int kRI = 8;                // focal rows per thread
constexpr int kJT = 64;               // samples per stage
constexpr int kLdW = kJT + 4;         // padded W row, in floats
constexpr int kStages = 2;
constexpr int kMaxThreads = 256;
constexpr int kMaxGroups = 32;        // float4 feature groups per block
constexpr int kMaxRows = 32;          // row groups per block

enum Kind { kCont, kDisc, kMix };

__host__ __device__ constexpr int stage_floats(int groups, int rows) {
  return kRI * rows * kLdW + kJT * 4 * groups;
}

// acc + w * diff(a, b) of a discrete column, or of one of either kind (d:
// the column is discrete)
template <int KIND>
__device__ __forceinline__ float term(float acc, float a, float b, float w,
                                      bool d) {
  if constexpr (KIND == kDisc) return fs::add_ne(acc, a, b, w);
  const float t = fabsf(a - b);
  return fmaf(d ? (t != 0.f ? 1.f : 0.f) : t, w, acc);
}

// one stage of kJT samples into the thread's 8 x 4 accumulators, for the
// discrete and mixed kinds; the continuous loop is written out in
// `accum_body` (a call around it changes ptxas's schedule of the
// continuous kernel)
template <int KIND>
__device__ __forceinline__ void stage_sums(float (&acc)[kRI][4],
                                           const float4 (&a)[kRI],
                                           const float* sw, const float* sx,
                                           int rg, int rows, int g, int ldx,
                                           const bool (&d)[4]) {
#pragma unroll 2
  for (int jj = 0; jj < kJT; jj += 4) {
    float4 wv[kRI];
#pragma unroll
    for (int r = 0; r < kRI; ++r)
      wv[r] = *reinterpret_cast<const float4*>(
          sw + (rg + rows * r) * kLdW + jj);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 b =
          *reinterpret_cast<const float4*>(sx + (jj + q) * ldx + 4 * g);
#pragma unroll
      for (int r = 0; r < kRI; ++r) {
        const float wq = q == 0 ? wv[r].x : q == 1 ? wv[r].y
                       : q == 2 ? wv[r].z : wv[r].w;
        acc[r][0] = term<KIND>(acc[r][0], a[r].x, b.x, wq, d[0]);
        acc[r][1] = term<KIND>(acc[r][1], a[r].y, b.y, wq, d[1]);
        acc[r][2] = term<KIND>(acc[r][2], a[r].z, b.z, wq, d[2]);
        acc[r][3] = term<KIND>(acc[r][3], a[r].w, b.w, wq, d[3]);
      }
    }
  }
}

template <bool MIXED>
__device__ __forceinline__ void accum_body(
    const float* __restrict__ xi, const float* __restrict__ xp,
    const float* __restrict__ w, const float* __restrict__ recip,
    const float* __restrict__ disc, float* __restrict__ partial, int nb,
    int n, int p, int p_disc, int groups, int rows, int span) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int g = tid % groups;             // float4 feature group
  const int rg = tid / groups;            // row group
  const int ib = kRI * rows;              // focal rows per block
  const int ldx = 4 * groups;             // staged xp row, in floats
  const int w_floats = ib * kLdW;
  const int stage = stage_floats(groups, rows);
  // the block's features [f0, f_end): a tile of the discrete run (MIXED:
  // its tiles come first) or of the continuous run
  int f0 = blockIdx.x * ldx;
  int f_end = p;
  if constexpr (MIXED) {
    const int tile = blockIdx.x;
    const int d_tiles = (p_disc + ldx - 1) / ldx;
    if (tile < d_tiles)
      f_end = p_disc;
    else
      f0 = p_disc + (tile - d_tiles) * ldx;
  }
  const int i0 = blockIdx.y * ib;
  const int j_begin = blockIdx.z * span;
  const int j_end = min(n, j_begin + span);
  const int n_stages = (j_end - j_begin + kJT - 1) / kJT;
  const int gf = f0 + 4 * g;
  const bool f_ok = gf < f_end;

  float4 a[kRI];
  float acc[kRI][4];
#pragma unroll
  for (int r = 0; r < kRI; ++r) {
    const int gi = i0 + rg + rows * r;
    a[r] = (gi < nb && f_ok)
               ? __ldg(reinterpret_cast<const float4*>(
                     xi + (long long)gi * p + gf))
               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  }
  // the kind of the thread's 4 columns; a group past the tile's end (its
  // loads are 0 and its sums unused) takes the kind of the tile's first,
  // so that its warp does not run a second branch
  bool d[4] = {false, false, false, false};
  int kind = kCont;
  if constexpr (MIXED) {
    const float4 dv =
        __ldg(reinterpret_cast<const float4*>(disc + (f_ok ? gf : f0)));
    d[0] = dv.x > 0.f;
    d[1] = dv.y > 0.f;
    d[2] = dv.z > 0.f;
    d[3] = dv.w > 0.f;
    const int n_disc = d[0] + d[1] + d[2] + d[3];
    kind = n_disc == 4 ? kDisc : n_disc == 0 ? kCont : kMix;
  }

  // one stage: W rows [ib][kLdW], then xp rows [kJT][ldx]
  auto load = [&](int st, int j0) {
    float* sw = smem + st * stage;
    float* sx = sw + w_floats;
    for (int e = tid; e < ib * (kJT / 4); e += blockDim.x) {
      const int r = e / (kJT / 4);
      const int c = (e % (kJT / 4)) * 4;
      const bool ok = i0 + r < nb && j0 + c < j_end;
      fs::cp_async16(sw + r * kLdW + c,
                     ok ? w + (long long)(i0 + r) * n + j0 + c : w, ok);
    }
    for (int r = rg; r < kJT; r += rows) {   // a thread copies its group
      const bool ok = j0 + r < j_end && f_ok;
      fs::cp_async16(sx + r * ldx + 4 * g,
                     ok ? xp + (long long)(j0 + r) * p + gf : xp, ok);
    }
  };

  load(0, j_begin);
  fs::cp_async_commit();
  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) load((s + 1) % kStages, j_begin + (s + 1) * kJT);
    fs::cp_async_commit();
    fs::cp_async_wait<1>();     // stage s has landed
    __syncthreads();
    const float* sw = smem + (s % kStages) * stage;
    const float* sx = sw + w_floats;
    if (MIXED && kind == kDisc) {
      stage_sums<kDisc>(acc, a, sw, sx, rg, rows, g, ldx, d);
    } else if (MIXED && kind == kMix) {
      stage_sums<kMix>(acc, a, sw, sx, rg, rows, g, ldx, d);
    } else {
#pragma unroll 2
      for (int jj = 0; jj < kJT; jj += 4) {
        float4 wv[kRI];
#pragma unroll
        for (int r = 0; r < kRI; ++r)
          wv[r] = *reinterpret_cast<const float4*>(
              sw + (rg + rows * r) * kLdW + jj);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 b =
              *reinterpret_cast<const float4*>(sx + (jj + q) * ldx + 4 * g);
#pragma unroll
          for (int r = 0; r < kRI; ++r) {
            const float wq = q == 0 ? wv[r].x : q == 1 ? wv[r].y
                           : q == 2 ? wv[r].z : wv[r].w;
            acc[r][0] = fmaf(fabsf(a[r].x - b.x), wq, acc[r][0]);
            acc[r][1] = fmaf(fabsf(a[r].y - b.y), wq, acc[r][1]);
            acc[r][2] = fmaf(fabsf(a[r].z - b.z), wq, acc[r][2]);
            acc[r][3] = fmaf(fabsf(a[r].w - b.w), wq, acc[r][3]);
          }
        }
      }
    }
    __syncthreads();            // the stage may be overwritten next
  }
  fs::cp_async_wait<0>();

  // rows of one thread, then row groups in order, through shared memory
  float* red = smem;            // [rows][ldx]
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < kRI; ++r) t += acc[r][c];
    red[rg * ldx + 4 * g + c] = t;
  }
  __syncthreads();
  float* out = partial + (long long)(blockIdx.y * gridDim.z + blockIdx.z) * p;
  for (int fl = tid; fl < ldx; fl += blockDim.x) {
    const int f = f0 + fl;
    if (f >= f_end) continue;
    float t = 0.f;
    for (int k = 0; k < rows; ++k) t += red[k * ldx + fl];
    // a discrete column's sum is its score: no recip
    out[f] = (MIXED && disc[f] > 0.f) ? t : t * recip[f];
  }
}

__global__ void __launch_bounds__(kMaxThreads)
accum_kernel_cont(const float* __restrict__ xi, const float* __restrict__ xp,
                  const float* __restrict__ w,
                  const float* __restrict__ recip,
                  float* __restrict__ partial, int nb, int n, int p,
                  int groups, int rows, int span) {
  accum_body<false>(xi, xp, w, recip, nullptr, partial, nb, n, p, 0, groups,
                    rows, span);
}

__global__ void __launch_bounds__(kMaxThreads, 2)
accum_kernel_mixed(const float* __restrict__ xi, const float* __restrict__ xp,
                   const float* __restrict__ w,
                   const float* __restrict__ recip,
                   const float* __restrict__ disc, float* __restrict__ partial,
                   int nb, int n, int p, int p_disc, int groups, int rows,
                   int span) {
  accum_body<true>(xi, xp, w, recip, disc, partial, nb, n, p, p_disc, groups,
                   rows, span);
}

// The launch's shared memory and grid, after checking the plan; 0 or a
// CUDA error code.
int plan_launch(int nb, int n, int p, int p_disc, int groups, int rows,
                int span, int* smem, dim3* grid) {
  if (p % 4 != 0 || n % 4 != 0 || span % 4 != 0 || span <= 0 ||
      p_disc % 4 != 0 || p_disc < 0 || p_disc > p || groups < 1 ||
      groups > kMaxGroups || rows < 1 || rows > kMaxRows ||
      groups * rows > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ldx = 4 * groups;
  const int ib = kRI * rows;
  *smem = kStages * stage_floats(groups, rows) * sizeof(float);
  *grid = dim3((p_disc + ldx - 1) / ldx + (p - p_disc + ldx - 1) / ldx,
               (nb + ib - 1) / ib, (n + span - 1) / span);
  return 0;
}

}  // namespace

// partial (itiles * spans, p) = continuous pass 2 of focal rows xi (nb, p)
// against samples xp (n, p) under weights w (nb, n), float32, row-major and
// contiguous, rows 16-byte aligned (p and n multiples of 4); recip is (p,).
// A block is `groups` float4 feature groups by `rows` row groups of 8 focal
// rows; the samples run in spans of `span` (a multiple of 4); row
// t * spans + z of partial holds focal tile t over span z.  Launches on
// `stream` and returns cudaGetLastError() of the launch.
extern "C" int fs_relief_pass2_cont(const void* xi, const void* xp,
                                    const void* w, const void* recip,
                                    void* partial, int nb, int n, int p,
                                    int groups, int rows, int span,
                                    void* stream) {
  int smem;
  dim3 grid;
  int err = plan_launch(nb, n, p, 0, groups, rows, span, &smem, &grid);
  if (err == 0) err = fs::allow_smem(accum_kernel_cont, smem);
  if (err != 0) return err;
  accum_kernel_cont<<<grid, groups * rows, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xi), static_cast<const float*>(xp),
      static_cast<const float*>(w), static_cast<const float*>(recip),
      static_cast<float*>(partial), nb, n, p, groups, rows, span);
  return static_cast<int>(cudaGetLastError());
}

// The same with Hamming diffs on the columns where disc > 0 (16-byte
// aligned too).  The feature tiles cover [0, p_disc) first, then
// [p_disc, p) (p_disc a multiple of 4, 0 for one run): a caller whose
// discrete columns are exactly the first p_disc gets blocks of one kind.
extern "C" int fs_relief_pass2_mixed(const void* xi, const void* xp,
                                     const void* w, const void* recip,
                                     const void* disc, void* partial, int nb,
                                     int n, int p, int p_disc, int groups,
                                     int rows, int span, void* stream) {
  int smem;
  dim3 grid;
  int err = plan_launch(nb, n, p, p_disc, groups, rows, span, &smem, &grid);
  if (err == 0) err = fs::allow_smem(accum_kernel_mixed, smem);
  if (err != 0) return err;
  accum_kernel_mixed<<<grid, groups * rows, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xi), static_cast<const float*>(xp),
      static_cast<const float*>(w), static_cast<const float*>(recip),
      static_cast<const float*>(disc), static_cast<float*>(partial), nb, n,
      p, p_disc, groups, rows, span);
  return static_cast<int>(cudaGetLastError());
}
