// Relief pass 2 on Hopper: per-feature scores from the pair weights
//
//   partial[t, f] = sum_{i in focal tile t} sum_j W[i, j] * diff(i, j, f)
//
// with diff as in pass 1.  The wrapper sums the partials over t in a fixed
// order, so scores are bitwise identical from run to run: no float atomics.
//
// Replaces the Pallas kernel `_accum_kernel` of
// fastselect_tpu/ops/relief_pallas.py; its continuous counterpart
// `_accum_kernel_cont` is `relief_pass2_cont.cu`.  Only MIXED = true is
// launched: this is the first port's simple kernel, kept as it was.
// The TPU kept one score block resident across a sequential grid and, for
// a Mosaic layout limit, wrote an (8, ft) block with only row 0 live; here
// blocks run in any order, so each one owns (32 features x 32 focal rows),
// loops over all j itself and writes its own partial row.
//
// What bounds it on the H100: FP32 CUDA-core throughput, as in pass 1: the
// work is O(nb * n * p) and the bytes O(nb * n + (nb + n) * p).  A lane owns
// one feature and a warp four focal rows, so the four W values of a row are
// one broadcast 16-byte shared load and each x_j value one conflict-free
// load, which feed 16 |a - b| * w products (2 FP32 instructions each in the
// continuous case: recip multiplies the finished sum once).  Each block
// stages a (32 x 64) W tile and a (64 x 32) X tile per step (16 KB).
//
// Later work (not here): the register tiling and cp.async staging of
// `relief_pass2_cont.cu`, and X pre-scaled by recip.

#include <cuda_runtime.h>

namespace {

constexpr int kFT = 32;               // features per block, one per lane
constexpr int kIT = 32;               // focal rows per block
constexpr int kJT = 64;               // samples per staged step
constexpr int kWarps = 8;
constexpr int kRows = kIT / kWarps;   // focal rows per warp
constexpr int kThreads = kWarps * 32;

template <bool MIXED>
__global__ void __launch_bounds__(kThreads)
accum_kernel(const float* __restrict__ xi, const float* __restrict__ xp,
             const float* __restrict__ w, const float* __restrict__ recip,
             const float* __restrict__ disc, float* __restrict__ partial,
             int nb, int n, int p) {
  __shared__ __align__(16) float s_w[kIT][kJT];
  __shared__ float s_xj[kJT][kFT];
  __shared__ float s_red[kWarps][kFT];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int f0 = blockIdx.x * kFT;
  const int i0 = blockIdx.y * kIT;
  const int gf = f0 + lane;
  const bool f_ok = gf < p;
  const bool disc_f = MIXED && f_ok && disc[gf] > 0.f;

  float a[kRows];
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int gi = i0 + warp * kRows + r;
    a[r] = (gi < nb && f_ok) ? xi[(long long)gi * p + gf] : 0.f;
    acc[r] = 0.f;
  }

  for (int j0 = 0; j0 < n; j0 += kJT) {
    // W rows and X rows are read 32 consecutive floats per warp: coalesced.
    // Rows past nb or n stage as W = 0, which adds nothing.
#pragma unroll
    for (int k = 0; k < kIT * kJT / kThreads; ++k) {
      const int e = tid + k * kThreads;
      const int r = e / kJT;
      const int c = e % kJT;
      const int gi = i0 + r;
      const int gj = j0 + c;
      s_w[r][c] = (gi < nb && gj < n) ? w[(long long)gi * n + gj] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kJT * kFT / kThreads; ++k) {
      const int e = tid + k * kThreads;
      const int r = e / kFT;
      const int c = e % kFT;
      const int gj = j0 + r;
      s_xj[r][c] = (gj < n && f0 + c < p) ? xp[(long long)gj * p + f0 + c]
                                          : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kJT; j += 4) {
      float b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) b[q] = s_xj[j + q][lane];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 w4 =
            *reinterpret_cast<const float4*>(&s_w[warp * kRows + r][j]);
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float dd = a[r] - b[q];
          float v = fabsf(dd);
          if (MIXED) v = disc_f ? (dd != 0.f ? 1.f : 0.f) : v;
          acc[r] = fmaf(v, wv[q], acc[r]);
        }
      }
    }
    __syncthreads();
  }

  float total = 0.f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) total += acc[r];
  s_red[warp][lane] = total;
  __syncthreads();
  if (warp == 0 && f_ok) {
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < kWarps; ++g) s += s_red[g][lane];
    partial[(long long)blockIdx.y * p + gf] = disc_f ? s : s * recip[gf];
  }
}

}  // namespace

// partial (ceil(nb / 32), p) = mixed pass 2 of focal rows xi (nb, p)
// against samples xp (n, p) under weights w (nb, n), all float32,
// row-major and contiguous; recip and disc are (p,).  Launches on `stream`
// and returns cudaGetLastError() of the launch.
extern "C" int fs_relief_pass2_mixed(const void* xi, const void* xp,
                                     const void* w, const void* recip,
                                     const void* disc, void* partial, int nb,
                                     int n, int p, void* stream) {
  const dim3 grid((p + kFT - 1) / kFT, (nb + kIT - 1) / kIT);
  accum_kernel<true><<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xi), static_cast<const float*>(xp),
      static_cast<const float*>(w), static_cast<const float*>(recip),
      static_cast<const float*>(disc), static_cast<float*>(partial), nb, n,
      p);
  return static_cast<int>(cudaGetLastError());
}
