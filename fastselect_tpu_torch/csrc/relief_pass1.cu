// Relief pass 1 on Hopper: the pairwise distance matrix
//
//   D[i, j] = sum_f diff(xi[i, f], xp[j, f])
//   diff    = 1[x_if != x_jf]           where disc[f] > 0 (MIXED only)
//           = |x_if - x_jf| * recip[f]  otherwise
//
// Replaces the Pallas kernel `_dist_kernel` of
// fastselect_tpu/ops/relief_pallas.py; its continuous counterpart
// `_dist_kernel_cont` is `relief_pass1_cont.cu`.  Only MIXED = true is
// launched: this is the first port's simple kernel, kept as it was.
//
// What bounds it on the H100: FP32 CUDA-core throughput.  The work is
// O(nb * n * p) and the bytes are O((nb + n) * p + nb * n), and an |a - b|
// sum has no tensor-core form.  Each thread keeps a 4 x 4 micro-tile of
// D in registers, so every pair of shared-memory loads feeds 16 diffs of
// 3 FP32 instructions each; the block stages 32-feature chunks of its 64
// focal rows and 64 sample rows in shared memory (16.6 KB), so each input
// element is read from device memory once per tile, not once per pair.
//
// Every thread adds its features in order f = 0, 1, ..., p-1 with
// separately rounded multiply and add (no FMA contraction), so D equals
// its plain PyTorch twin `dist_matrix_ref` bit for bit.  Ragged edges of
// nb, n and p are masked here: out-of-range features load as x = 0,
// recip = 0, disc = 0 and add +0.0.
//
// Later work (not here): the register tiling and cp.async staging of
// `relief_pass1_cont.cu`, and X pre-scaled by recip to drop the multiply.

#include <cuda_runtime.h>

namespace {

constexpr int kBI = 64;            // focal rows per block
constexpr int kBJ = 64;            // sample rows per block
constexpr int kBF = 32;            // features per shared-memory chunk
constexpr int kTX = 16;            // threads along j
constexpr int kTY = 16;            // threads along i
constexpr int kRI = kBI / kTY;     // micro-tile rows per thread
constexpr int kRJ = kBJ / kTX;     // micro-tile columns per thread
constexpr int kThreads = kTX * kTY;

template <bool MIXED>
__global__ void __launch_bounds__(kThreads)
dist_kernel(const float* __restrict__ xi, const float* __restrict__ xp,
            const float* __restrict__ recip, const float* __restrict__ disc,
            float* __restrict__ d, int nb, int n, int p) {
  // feature-major chunks; the +1 keeps the transposing stores free of
  // bank conflicts
  __shared__ float s_xi[kBF][kBI + 1];
  __shared__ float s_xj[kBF][kBJ + 1];
  __shared__ float s_recip[kBF];
  __shared__ float s_disc[kBF];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  const int i0 = blockIdx.y * kBI;
  const int j0 = blockIdx.x * kBJ;

  float acc[kRI][kRJ];
#pragma unroll
  for (int r = 0; r < kRI; ++r)
#pragma unroll
    for (int c = 0; c < kRJ; ++c) acc[r][c] = 0.f;

  for (int f0 = 0; f0 < p; f0 += kBF) {
    // a warp reads 32 consecutive features of one row: coalesced
#pragma unroll
    for (int k = 0; k < kBI * kBF / kThreads; ++k) {
      const int e = tid + k * kThreads;
      const int row = e / kBF;
      const int col = e % kBF;
      const int gf = f0 + col;
      const int gi = i0 + row;
      const int gj = j0 + row;
      s_xi[col][row] = (gi < nb && gf < p) ? xi[(long long)gi * p + gf] : 0.f;
      s_xj[col][row] = (gj < n && gf < p) ? xp[(long long)gj * p + gf] : 0.f;
    }
    if (tid < kBF) {
      const int gf = f0 + tid;
      s_recip[tid] = gf < p ? recip[gf] : 0.f;
      s_disc[tid] = (MIXED && gf < p) ? disc[gf] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int f = 0; f < kBF; ++f) {
      float a[kRI];
      float b[kRJ];
#pragma unroll
      for (int r = 0; r < kRI; ++r) a[r] = s_xi[f][ty + kTY * r];
#pragma unroll
      for (int c = 0; c < kRJ; ++c) b[c] = s_xj[f][tx + kTX * c];
      const float rc = s_recip[f];
      if (MIXED && s_disc[f] > 0.f) {   // uniform across the block
#pragma unroll
        for (int r = 0; r < kRI; ++r)
#pragma unroll
          for (int c = 0; c < kRJ; ++c)
            acc[r][c] = __fadd_rn(
                acc[r][c], __fsub_rn(a[r], b[c]) != 0.f ? 1.f : 0.f);
      } else {
#pragma unroll
        for (int r = 0; r < kRI; ++r)
#pragma unroll
          for (int c = 0; c < kRJ; ++c)
            acc[r][c] = __fadd_rn(
                acc[r][c], __fmul_rn(fabsf(__fsub_rn(a[r], b[c])), rc));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kRI; ++r) {
    const int gi = i0 + ty + kTY * r;
#pragma unroll
    for (int c = 0; c < kRJ; ++c) {
      const int gj = j0 + tx + kTX * c;
      if (gi < nb && gj < n) d[(long long)gi * n + gj] = acc[r][c];
    }
  }
}

}  // namespace

// D (nb, n) = mixed pass 1 of focal rows xi (nb, p) against samples xp
// (n, p), all float32, row-major and contiguous; recip and disc are (p,).
// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int fs_relief_pass1_mixed(const void* xi, const void* xp,
                                     const void* recip, const void* disc,
                                     void* d, int nb, int n, int p,
                                     void* stream) {
  const dim3 block(kTX, kTY);
  const dim3 grid((n + kBJ - 1) / kBJ, (nb + kBI - 1) / kBI);
  dist_kernel<true><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xi), static_cast<const float*>(xp),
      static_cast<const float*>(recip), static_cast<const float*>(disc),
      static_cast<float*>(d), nb, n, p);
  return static_cast<int>(cudaGetLastError());
}

// Message for a CUDA error code returned by the entry points.
extern "C" const char* fs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
