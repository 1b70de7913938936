// MultiSURF's and SURF's pair weights on Hopper: W of one focal block
// written straight from its distance rows D, in two launches.
//
// It replaces no TPU kernel: the JAX package leaves these rules to XLA
// (fastselect_tpu/ops/relief.py `_rules_multisurf`, `_rules_surf`), and
// the port's plain version is a chain of about 25 ATen kernels, each a
// pass over a (T, n) float or bool temporary (ops/relief.py `_pair_masks`,
// `_row_shift`, `_row_mean_stats`, the near masks, their counts and
// `_sum_rules`).  For focal row i, with lab[j] the label of a valid sample
// and INT_MIN elsewhere:
//
//   vmask[j]  lab[j] != INT_MIN, vi[i] > 0 and j != iid[i]
//   hit[j]    lab[j] == yi[i]
//   Dm[j]     D[i, j] - shift[i] in D's type, on vmask
//   mu        T(sum Dm) * denom, denom = 1 / (n_real - 1)
//   thresh    MultiSURF: mu - 0.5 sqrt(max(T(sum Dm^2) * denom - mu mu, 0))
//             SURF: mu
//   near[j]   vmask[j] and Dm[j] < thresh
//   W[i, j]   coef[i] of (near, hit) on vmask, +0.0 elsewhere
//
// T is D's type (float, or double from pass 1's split path), every step
// of the threshold rounded in T as the plain version's separate kernels
// round it (no contraction into FMAs).  The two sums are taken in double
// and rounded to T: the plain version's float tree sums round in an order
// of their own, so a pair within an ulp or so of the threshold may fall
// on the other side of it; every other W is the plain version's bit for
// bit.  coef is what the plain version's sum of terms gives (0.0 plus the
// coefficient): MultiSURF -1/max(n_hit, 1) on near hits and 1/max(n_miss,
// 1) on near misses, MultiSURF* also -1/max(n_miss, 1) on far misses;
// SURF -1 on near hits, +1 on near misses, SURF* also +1 on far hits and
// -1 on far misses; +0.0 for any other kind of pair.
//
// What bounds it on the H100: bytes.  At least D is read once and W
// written once, 8 B a pair: a large-n focal block of 25,024 x 50,048
// pairs moves 10.0 GB, 2.99 ms at 3,350 GB/s.  The plain version makes
// about 25 passes over such temporaries and 17 B a pair of device memory
// at its peak.
//
// What the design does about it:
//  - the statistics launch: a block of 1,024 threads an SM walks the
//    rows, one at a time.  It reads the row once from device memory for
//    the two sums, reduces them across the block (every thread then
//    settles the same threshold), and re-reads the row for the near hits
//    and misses while it is still in L2 (132 rows of 200 KB in flight at
//    large-n: 26 MB of the 50 MB).  It writes the threshold and the four
//    coefficients of each row (4 B a pair of device memory);
//  - the weights launch: one thread a float4 of W, rows along the grid's
//    y; it reads D (evict first) and writes W as float4 (8 B a pair).
//    Together 12 B a pair: 4.49 ms a large-n block.  The statistics keep
//    a launch of their own so that the program's span around them
//    (`weight_rules.stats`) keeps timing them alone.  Measured at that
//    block (MultiSURF, float32 D, an NVIDIA H100 80GB HBM3 at 700 W):
//    2.05 ms and 3.49 ms, 81% of the 12 B bound, against 64.3 ms for the
//    plain version;
//  - the double sums of a row are taken in a fixed order (a thread's
//    stride, then a fixed shuffle tree), so W is the same from launch to
//    launch; the counts are integers.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kStatsThreads = 1024;  // one block an SM
constexpr int kStatsWarps = kStatsThreads / 32;
constexpr int kWeightsThreads = 256;
constexpr int kMaxGridY = 65535;
constexpr int kNoLabel = INT_MIN;
constexpr unsigned kFull = 0xffffffffu;

// Four consecutive values of D from a 16-byte aligned address: `cs` for
// the last read of them (evict first).
__device__ __forceinline__ void load4(const float* p, float (&v)[4],
                                      bool cs) {
  const auto* q = reinterpret_cast<const float4*>(p);
  const float4 a = cs ? __ldcs(q) : *q;
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4],
                                      bool cs) {
  const auto* q = reinterpret_cast<const double2*>(p);
  const double2 a = cs ? __ldcs(q) : q[0];
  const double2 b = cs ? __ldcs(q + 1) : q[1];
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// Each step rounded on its own, as the plain version's kernels round it.
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
template <typename T>
__device__ __forceinline__ T round_to(double a);
template <>
__device__ __forceinline__ float round_to<float>(double a) {
  return __double2float_rn(a);
}
template <>
__device__ __forceinline__ double round_to<double>(double a) {
  return a;
}

// A sample id past n is no sample's.
__device__ __forceinline__ int self_of(const int64_t* iid, int i, int n) {
  return iid[i] < n ? static_cast<int>(iid[i]) : -1;
}

// Sum of a and b over the block, in a fixed order; every thread gets
// both.  `red` holds 2 x kStatsWarps values; every thread must call it.
template <typename V>
__device__ __forceinline__ void block_sum2(V& a, V& b, V* red) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(kFull, a, o);
    b += __shfl_xor_sync(kFull, b, o);
  }
  if (lane == 0) {
    red[warp] = a;
    red[kStatsWarps + warp] = b;
  }
  __syncthreads();
  a = red[lane];
  b = red[kStatsWarps + lane];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(kFull, a, o);
    b += __shfl_xor_sync(kFull, b, o);
  }
  __syncthreads();  // red is free again
}

template <typename T>
__global__ void __launch_bounds__(kStatsThreads, 1)
threshold_stats_kernel(const T* __restrict__ d,
                       const int32_t* __restrict__ lab,
                       const int32_t* __restrict__ yi,
                       const int64_t* __restrict__ iid,
                       const float* __restrict__ vi,
                       const T* __restrict__ shift,
                       const T* __restrict__ denom_p, T* __restrict__ thr,
                       float4* __restrict__ coef, int rows, int n,
                       bool multisurf, bool star) {
  static_assert(kStatsWarps == 32, "block_sum2 reduces one value a lane");
  __shared__ double red_d[2 * kStatsWarps];
  __shared__ int red_i[2 * kStatsWarps];
  const int n4 = n / 4;
  const auto* lab4 = reinterpret_cast<const int4*>(lab);
  const T denom = *denom_p;
  for (int i = blockIdx.x; i < rows; i += gridDim.x) {
    const T* di = d + static_cast<size_t>(i) * n;
    const bool active = vi[i] > 0.f;
    const int self = self_of(iid, i, n);
    const int y = yi[i];
    const T sh = shift[i];
    double s1 = 0.0, s2 = 0.0;
    if (active) {
#pragma unroll 4
      for (int q4 = threadIdx.x; q4 < n4; q4 += kStatsThreads) {
        T v[4];
        load4(di + 4 * q4, v, !multisurf);  // SURF reads the row once
        const int4 l = __ldg(lab4 + q4);
        const int lq[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (lq[q] == kNoLabel || 4 * q4 + q == self) continue;
          const double m = static_cast<double>(sub_rn(v[q], sh));
          s1 += m;
          s2 = fma(m, m, s2);
        }
      }
    }
    block_sum2(s1, s2, red_d);
    const T mu = mul_rn(round_to<T>(s1), denom);
    T t = mu;
    if (multisurf) {
      T var = sub_rn(mul_rn(round_to<T>(s2), denom), mul_rn(mu, mu));
      var = var < T(0) ? T(0) : var;  // NaN stays NaN, as clamp_min keeps it
      t = sub_rn(mu, mul_rn(T(0.5), sqrt_rn(var)));
    }
    float4 c;
    if (multisurf) {
      int nh = 0, nm = 0;
      if (active) {
#pragma unroll 4
        for (int q4 = threadIdx.x; q4 < n4; q4 += kStatsThreads) {
          T v[4];
          load4(di + 4 * q4, v, true);
          const int4 l = __ldg(lab4 + q4);
          const int lq[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (lq[q] == kNoLabel || 4 * q4 + q == self) continue;
            if (sub_rn(v[q], sh) < t) {
              if (lq[q] == y)
                ++nh;
              else
                ++nm;
            }
          }
        }
      }
      block_sum2(nh, nm, red_i);
      const float w_hit = -__frcp_rn(static_cast<float>(max(nh, 1)));
      const float w_miss = __frcp_rn(static_cast<float>(max(nm, 1)));
      c = make_float4(w_hit, w_miss, 0.f, star ? -w_miss : 0.f);
    } else {
      c = make_float4(-1.f, 1.f, star ? 1.f : 0.f, star ? -1.f : 0.f);
    }
    if (threadIdx.x == 0) {
      thr[i] = t;
      coef[i] = c;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWeightsThreads)
threshold_weights_kernel(const T* __restrict__ d,
                         const int32_t* __restrict__ lab,
                         const int32_t* __restrict__ yi,
                         const int64_t* __restrict__ iid,
                         const float* __restrict__ vi,
                         const T* __restrict__ shift,
                         const T* __restrict__ thr,
                         const float4* __restrict__ coef,
                         float* __restrict__ w, int rows, int n) {
  const int n4 = n / 4;
  const int q4 = blockIdx.x * kWeightsThreads + threadIdx.x;
  if (q4 >= n4) return;
  const int4 l = __ldg(reinterpret_cast<const int4*>(lab) + q4);
  const int lq[4] = {l.x, l.y, l.z, l.w};
  for (int i = blockIdx.y; i < rows; i += gridDim.y) {
    float out[4] = {0.f, 0.f, 0.f, 0.f};
    if (vi[i] > 0.f) {
      T v[4];
      load4(d + static_cast<size_t>(i) * n + 4 * q4, v, true);
      const T sh = shift[i];
      const T t = thr[i];
      const float4 c = coef[i];
      const int y = yi[i];
      const int self = self_of(iid, i, n);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (lq[q] == kNoLabel || 4 * q4 + q == self) continue;
        const bool hit = lq[q] == y;
        out[q] = sub_rn(v[q], sh) < t ? (hit ? c.x : c.y)
                                      : (hit ? c.z : c.w);
      }
    }
    __stcs(reinterpret_cast<float4*>(w + static_cast<size_t>(i) * n) + q4,
           make_float4(out[0], out[1], out[2], out[3]));
  }
}

bool bad_shape(int rows, int n) { return rows <= 0 || n <= 0 || n % 4; }

template <typename T>
int launch_stats(const void* d, const void* lab, const void* yi,
                 const void* iid, const void* vi, const void* shift,
                 const void* denom, void* thr, void* coef, int rows, int n,
                 bool multisurf, bool star, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  threshold_stats_kernel<T><<<min(rows, sms), kStatsThreads, 0, stream>>>(
      static_cast<const T*>(d), static_cast<const int32_t*>(lab),
      static_cast<const int32_t*>(yi), static_cast<const int64_t*>(iid),
      static_cast<const float*>(vi), static_cast<const T*>(shift),
      static_cast<const T*>(denom), static_cast<T*>(thr),
      static_cast<float4*>(coef), rows, n, multisurf, star);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_weights(const void* d, const void* lab, const void* yi,
                   const void* iid, const void* vi, const void* shift,
                   const void* thr, const void* coef, void* w, int rows,
                   int n, cudaStream_t stream) {
  const dim3 grid((n / 4 + kWeightsThreads - 1) / kWeightsThreads,
                  min(rows, kMaxGridY));
  threshold_weights_kernel<T><<<grid, kWeightsThreads, 0, stream>>>(
      static_cast<const T*>(d), static_cast<const int32_t*>(lab),
      static_cast<const int32_t*>(yi), static_cast<const int64_t*>(iid),
      static_cast<const float*>(vi), static_cast<const T*>(shift),
      static_cast<const T*>(thr), static_cast<const float4*>(coef),
      static_cast<float*>(w), rows, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The statistics of MultiSURF's (multisurf != 0) or SURF's threshold for
// focal rows whose distance rows are D (rows, n), row-major, contiguous
// and 16-byte aligned (n a multiple of 4), of doubles when `dbl` != 0 and
// floats otherwise.  lab (n,) int32 holds each sample's label, INT_MIN
// where the sample is no one's neighbour; yi (rows,) int32 the focal
// rows' labels, iid (rows,) int64 their sample ids, vi (rows,) float32
// their validity; shift (rows,) and denom (one value) are of D's type.
// Writes thr (rows,) of D's type, each row's threshold on D - shift, and
// coef (rows, 4) float32 (16-byte aligned), the weight of a near hit, a
// near miss, a far hit and a far miss (star != 0: the starred rule).  One
// block an SM walks the rows.  Launches on `stream` and returns
// cudaGetLastError() of the launch.
extern "C" int fs_threshold_stats(const void* d, int dbl, const void* lab,
                                  const void* yi, const void* iid,
                                  const void* vi, const void* shift,
                                  const void* denom, void* thr, void* coef,
                                  int rows, int n, int multisurf, int star,
                                  void* stream) {
  if (bad_shape(rows, n)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return dbl ? launch_stats<double>(d, lab, yi, iid, vi, shift, denom, thr,
                                    coef, rows, n, multisurf, star, s)
             : launch_stats<float>(d, lab, yi, iid, vi, shift, denom, thr,
                                   coef, rows, n, multisurf, star, s);
}

// W (rows, n) float32 (16-byte aligned) from D and the operands of
// fs_threshold_stats, with its thr and coef: coef[i] of (near, hit) on
// each pair of vmask, +0.0 elsewhere.  Launches on `stream` and returns
// cudaGetLastError() of the launch.
extern "C" int fs_threshold_weights(const void* d, int dbl, const void* lab,
                                    const void* yi, const void* iid,
                                    const void* vi, const void* shift,
                                    const void* thr, const void* coef,
                                    void* w, int rows, int n, void* stream) {
  if (bad_shape(rows, n)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return dbl ? launch_weights<double>(d, lab, yi, iid, vi, shift, thr, coef,
                                      w, rows, n, s)
             : launch_weights<float>(d, lab, yi, iid, vi, shift, thr, coef,
                                     w, rows, n, s);
}
