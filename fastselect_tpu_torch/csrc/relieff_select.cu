// ReliefF's neighbour pick on Hopper: the pair weights W of one focal
// block written straight from its distance rows D.
//
// It replaces no TPU kernel: the JAX package leaves this rule to XLA
// (fastselect_tpu/ops/relief.py `_rules_relieff_argsort`, an argsort of
// each row, and `_rules_relieff`, a `lax.top_k` of each rule's row), and
// the port's plain version is a stable sort of each masked row, ranks by
// cumsum, a scatter back through the permutation and C + 1 masked adds
// (ops/relief.py `_rules_relieff` and `_sum_rules`).  For focal row i:
//
//   members of label L   valid j (lab[j] a label, j != iid[i], vi[i] > 0)
//                        with label L, for each class L in [0, C) and for
//                        the row's own label yi[i] (which may lie past C)
//   picks of label L     its first k members in the order of the stable
//                        ascending sort of D[i, :]: by D's order-preserving
//                        key (-0.0 equal to +0.0, NaN last, as the sorts
//                        do), ties to the lower j
//   W[i, j]              vals[i, slot(j)] on a pick, +0.0 elsewhere
//
// where slot(j) is lab[j] for a class and C for a label past the classes
// that equals yi[i].  The wrapper (ops/relief.py `relieff_weights`)
// computes vals in PyTorch: the hit weight -1/h_found on the row's own
// label's slot, P(c) / (1 - P(y_i)) / k on every other class's, each as
// 0.0 + its coefficient, which is what the plain version's sum of terms
// gives.  So W equals the plain version's bit for bit.
//
// What bounds it on the H100: bytes.  D is read once and W written once,
// 8 B a pair: a focal block of 2,944 x 50,048 pairs moves 1.18 GB, at
// least 0.35 ms at 3,350 GB/s.  The plain version sorts every row in full
// (keys, int64 indices and the sort's scratch), gathers, scans and
// scatters: about 46 B a pair of device memory at its peak and 31 ms a
// block.
//
// What the design does about it:
//  - No sort and no candidate list.  A block owns a focal row at a time
//    (persistent over the rows, three blocks an SM) and finds, for every
//    label of the row at once, the key t of its k-th pick by a radix
//    select: per-label histograms of one digit of the key in shared
//    memory, then the digit that holds the k-th member, most significant
//    digit first.  Digits are 11 bits (11 + 11 + 10; 8 KB a label), for
//    groups of up to kGroup labels, each group its own passes (a 2-class
//    row is one group, 60 classes eight).  A label is settled
//    as soon as its digit's bucket is taken whole (or it has at most k
//    members); the row stops once every label is settled.  Each digit
//    re-reads the row (200 KB at large-n), mostly from L2.
//  - One last pass in index order writes the whole row as float4: a
//    member is picked when its key is below its label's t, or equal to it
//    while fewer than k - below of the label's members equal to t came
//    before it.  Only a label whose k-th member ties with later ones, in
//    full 32-bit keys, needs that count: its tied members of each 2,048
//    samples are listed in index order (a block scan) and one warp ranks
//    them by label (`__match_any_sync`), 32 at a time.  Any k works the
//    same way.
//  - Histogram counts are shared-memory atomics, one a member: integer
//    counts, so the result does not depend on their order.  The 11-bit
//    first digit spreads large-n's distances over enough buckets that
//    summing a warp's equal buckets first (`__match_any_sync`) cost more
//    than it saved (2.27 ms a block with it and 8-bit digits, 1.12 ms
//    without it, with 11-bit digits and three blocks an SM, on an NVIDIA
//    H100 80GB HBM3 at 700 W).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 3;  // registers capped to keep three an SM
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4 * kThreads;  // samples a step: a float4 a thread
constexpr int kAll = INT_MAX;         // take every member at the threshold
constexpr unsigned kFull = 0xffffffffu;
// Digits of the key, most significant first: 11 bits (11 + 11 + 10), for
// groups of up to kGroup labels' histograms (8 KB a label; 74 KB of
// shared memory a block at kGroup, three blocks an SM).
constexpr int kDigit = 11;
constexpr int kLevels = (32 + kDigit - 1) / kDigit;
constexpr int kBins = 1 << kDigit;
constexpr int kGroup = 8;

// The sorts' order as an unsigned key: -0.0 and +0.0 equal, NaN last.
__device__ __forceinline__ uint32_t order_key(float x) {
  if (isnan(x)) return 0xffffffffu;
  uint32_t u = __float_as_uint(x);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The label slot of sample j for a focal row of label y and sample id
// `self`, minus g0 (the group's first slot): -1 when j is no member.
__device__ __forceinline__ int slot_of(int label, int y, int n_classes,
                                       int j, int self, int g0) {
  if (j == self) return -1;
  const int s = (label >= 0 && label < n_classes)
                    ? label
                    : (label == y ? n_classes : -1);
  return s < 0 ? -1 : s - g0;
}

// Digit `level` of a key: kDigit bits from the top, the last what is left.
__device__ __forceinline__ int digit_shift(int level) {
  return max(0, 32 - kDigit * (level + 1));
}
__device__ __forceinline__ uint32_t digit_mask(int level) {
  const int width = 32 - kDigit * level - digit_shift(level);
  return ((1u << width) - 1u) << digit_shift(level);
}

struct Smem {
  uint32_t* hist;  // group x bins
  uint32_t* pre;   // per slot: the threshold's settled high bits
  uint32_t* msk;   // per slot: which bits are settled
  int* need;       // per slot: picks still to place at pre (0: settled)
  int* take;       // per slot: members equal to pre to pick (kAll: all)
  int* cnt;        // per slot: tied members met so far (last pass)
  uint32_t* ties;  // kChunk: tied members of a step, index order
  int* warp_sums;  // kWarps
};

__device__ __forceinline__ Smem carve(unsigned char* base, int group) {
  Smem s;
  auto* p = reinterpret_cast<uint32_t*>(base);
  s.hist = p;
  p += group * kBins;
  s.pre = p;
  p += group;
  s.msk = p;
  p += group;
  s.need = reinterpret_cast<int*>(p);
  p += group;
  s.take = reinterpret_cast<int*>(p);
  p += group;
  s.cnt = reinterpret_cast<int*>(p);
  p += group;
  s.ties = p;
  p += kChunk;
  s.warp_sums = reinterpret_cast<int*>(p);
  return s;
}

size_t smem_bytes(int group) {
  return sizeof(uint32_t) *
         (static_cast<size_t>(group) * (kBins + 5) + kChunk + kWarps);
}

// Exclusive prefix sum of v over the block, in thread order; *total gets
// the sum.  Every thread must call it.
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, t, o);
      if (lane >= o) t += y;
    }
    if (lane < kWarps) warp_sums[lane] = t;
  }
  __syncthreads();
  *total = warp_sums[kWarps - 1];
  return (warp == 0 ? 0 : warp_sums[warp - 1]) + x - v;
}

// Settles what it can of slots [0, group) at digit `level` from the
// digit's histograms: each unsettled slot takes the digit of its need-th
// member.  One warp a slot, a lane a run of kBins / 32 digits.
__device__ void settle(const Smem& sm, int group, int level, int k) {
  constexpr int kRun = kBins / 32;
  const int lane = threadIdx.x % 32;
  for (int s = threadIdx.x / 32; s < group; s += kWarps) {
    const int need = sm.need[s];
    if (need == 0) continue;
    const uint32_t* h = sm.hist + s * kBins + lane * kRun;
    int sum = 0;
#pragma unroll 8
    for (int b = 0; b < kRun; ++b) sum += static_cast<int>(h[b]);
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    if (level == 0 && total <= k) {  // at most k members: all of them
      if (lane == 0) {
        sm.take[s] = kAll;
        sm.need[s] = 0;
      }
      continue;
    }
    int before = incl - sum;
    if (before < need && need <= incl) {  // one lane: the need-th member's
      for (int b = 0; b < kRun; ++b) {
        const int c = static_cast<int>(h[b]);
        if (before + c >= need) {
          const int rest = need - before;
          sm.pre[s] |= static_cast<uint32_t>(lane * kRun + b)
                       << digit_shift(level);
          sm.msk[s] |= digit_mask(level);
          if (rest == c) {  // the bucket is taken whole
            sm.take[s] = kAll;
            sm.need[s] = 0;
          } else if (level == kLevels - 1) {  // the first `rest` ties
            sm.take[s] = rest;
            sm.need[s] = 0;
          } else {
            sm.need[s] = rest;
          }
          break;
        }
        before += c;
      }
    }
  }
}

// For each label of focal row i: the key of its k-th member (by digits,
// settled in sm.pre / sm.msk / sm.take), over slots [g0, g0 + group).
__device__ void select_row(const Smem& sm, const float4* __restrict__ d4,
                           const int4* __restrict__ lab4, int n4, int y,
                           int self, int n_classes, int g0, int group,
                           int k) {
  for (int s = threadIdx.x; s < group; s += kThreads) {
    sm.pre[s] = 0u;
    sm.msk[s] = 0u;
    sm.need[s] = k;
    sm.take[s] = 0;
  }
  for (int level = 0; level < kLevels; ++level) {
    const int shift = digit_shift(level);
    const uint32_t digit = digit_mask(level) >> shift;
    for (int e = threadIdx.x; e < group * kBins; e += kThreads)
      sm.hist[e] = 0u;
    __syncthreads();
    for (int q4 = threadIdx.x; q4 < n4; q4 += kThreads) {
      const float4 dv = d4[q4];
      const int4 lv = __ldg(lab4 + q4);
      const float dq[4] = {dv.x, dv.y, dv.z, dv.w};
      const int lq[4] = {lv.x, lv.y, lv.z, lv.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int s = slot_of(lq[q], y, n_classes, 4 * q4 + q, self, g0);
        if (s < 0 || s >= group || sm.need[s] == 0) continue;
        const uint32_t key = order_key(dq[q]);
        if ((key & sm.msk[s]) == sm.pre[s])
          atomicAdd(sm.hist + s * kBins + ((key >> shift) & digit), 1u);
      }
    }
    __syncthreads();
    settle(sm, group, level, k);
    __syncthreads();
    const bool open = threadIdx.x < group && sm.need[threadIdx.x] > 0;
    if (!__syncthreads_or(open)) break;
  }
}

// The last pass over focal row i for slots [g0, g0 + group): the whole
// row as float4 when `whole` (zeros off the picks), else the picks alone.
__device__ void write_row(const Smem& sm, const float4* __restrict__ d4,
                          const int4* __restrict__ lab4,
                          const float* __restrict__ vals, float* __restrict__ w,
                          int n4, int y, int self, int n_classes, int g0,
                          int group, bool active, bool whole) {
  const int lane = threadIdx.x % 32;
  // a label whose k-th key ties with later members: count its ties
  const bool tied = __syncthreads_or(active && threadIdx.x < group &&
                                     sm.take[threadIdx.x] != kAll);
  if (tied)
    for (int s = threadIdx.x; s < group; s += kThreads) sm.cnt[s] = 0;
  for (int base = 0; base < n4; base += kThreads) {
    const int q4 = base + threadIdx.x;
    const bool in = q4 < n4;
    float4 dv = make_float4(0.f, 0.f, 0.f, 0.f);
    int4 lv = make_int4(-1, -1, -1, -1);
    if (in && active) {
      dv = d4[q4];
      lv = __ldg(lab4 + q4);
    }
    const float dq[4] = {dv.x, dv.y, dv.z, dv.w};
    const int lq[4] = {lv.x, lv.y, lv.z, lv.w};
    float out[4] = {0.f, 0.f, 0.f, 0.f};
    int slot[4];
    unsigned pick = 0u, tie = 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      slot[q] = -1;
      if (!(in && active)) continue;
      const int s = slot_of(lq[q], y, n_classes, 4 * q4 + q, self, g0);
      if (s < 0 || s >= group) continue;
      slot[q] = s;
      const uint32_t kb = order_key(dq[q]) & sm.msk[s];
      const uint32_t pre = sm.pre[s];
      if (kb < pre || (kb == pre && sm.take[s] == kAll))
        pick |= 1u << q;
      else if (kb == pre)
        tie |= 1u << q;
    }
    if (tied && __syncthreads_or(tie != 0u)) {
      // list this step's ties in index order, rank them by label in one
      // warp, read the verdicts back
      int total;
      int at = block_scan(__popc(tie), sm.warp_sums, &total);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (tie & (1u << q))
          sm.ties[at++] = (static_cast<uint32_t>(slot[q]) << 1);
      __syncthreads();
      if (threadIdx.x < 32) {
        for (int e0 = 0; e0 < total; e0 += 32) {
          const int e = e0 + lane;
          const bool ok = e < total;
          const int s = ok ? static_cast<int>(sm.ties[e] >> 1) : -1 - lane;
          const unsigned peers = __match_any_sync(kFull, s);
          const int rank = __popc(peers & ((1u << lane) - 1u));
          if (ok && sm.cnt[s] + rank < sm.take[s]) sm.ties[e] |= 1u;
          __syncwarp();
          if (ok && lane == 31 - __clz(peers)) sm.cnt[s] += __popc(peers);
          __syncwarp();
        }
      }
      __syncthreads();
      at -= __popc(tie);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (tie & (1u << q)) {
          if (sm.ties[at] & 1u) pick |= 1u << q;
          ++at;
        }
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (pick & (1u << q)) out[q] = vals[g0 + slot[q]];
    if (!in) continue;
    if (whole) {
      reinterpret_cast<float4*>(w)[q4] =
          make_float4(out[0], out[1], out[2], out[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (pick & (1u << q)) w[4 * q4 + q] = out[q];
    }
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
relieff_select_kernel(const float* __restrict__ d,
                      const int32_t* __restrict__ lab,
                      const int32_t* __restrict__ yi,
                      const int64_t* __restrict__ iid,
                      const float* __restrict__ vi,
                      const float* __restrict__ vals, float* __restrict__ w,
                      int rows, int n, int n_classes, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int slots = n_classes + 1;
  const int group = min(slots, kGroup);
  const Smem sm = carve(smem_raw, group);
  const int n4 = n / 4;
  const auto* lab4 = reinterpret_cast<const int4*>(lab);
  for (int i = blockIdx.x; i < rows; i += gridDim.x) {
    const auto* d4 =
        reinterpret_cast<const float4*>(d + static_cast<size_t>(i) * n);
    float* wi = w + static_cast<size_t>(i) * n;
    const float* vr = vals + static_cast<size_t>(i) * slots;
    const bool active = vi[i] > 0.f;
    const int y = yi[i];
    // a sample id past n is no sample's
    const int self = iid[i] < n ? static_cast<int>(iid[i]) : -1;
    for (int g0 = 0; g0 < slots; g0 += group) {
      const int gs = min(group, slots - g0);
      if (active)
        select_row(sm, d4, lab4, n4, y, self, n_classes, g0, gs, k);
      write_row(sm, d4, lab4, vr, wi, n4, y, self, n_classes, g0, gs, active,
                g0 == 0);
      if (!active) break;
      __syncthreads();
    }
  }
}

}  // namespace

// W (rows, n) float32 = ReliefF's pair weights of focal rows whose
// distance rows are D (rows, n) float32, both row-major, contiguous and
// 16-byte aligned (n a multiple of 4).  lab (n,) int32 holds each sample's
// label, or INT_MIN where the sample is no one's neighbour; yi (rows,)
// int32 the focal rows' labels, iid (rows,) int64 their sample ids, vi
// (rows,) float32 their validity (0: a row of zeros); vals (rows,
// n_classes + 1) float32 the value written on a pick of each slot (the
// classes, then the row's own label when it lies past them).  k >= 1
// neighbours a label.  kBlocksPerSm blocks an SM of the current device
// walk the rows.  Launches on `stream` and returns cudaGetLastError() of
// the launch.
extern "C" int fs_relieff_weights(const void* d, const void* lab,
                                  const void* yi, const void* iid,
                                  const void* vi, const void* vals, void* w,
                                  int rows, int n, int n_classes, int k,
                                  void* stream) {
  if (rows <= 0 || n <= 0 || n % 4 != 0 || n_classes <= 0 || k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = min(rows, sms * kBlocksPerSm);
  const size_t smem = smem_bytes(min(n_classes + 1, kGroup));
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(relieff_select_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  relieff_select_kernel<<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d), static_cast<const int32_t*>(lab),
      static_cast<const int32_t*>(yi), static_cast<const int64_t*>(iid),
      static_cast<const float*>(vi), static_cast<const float*>(vals),
      static_cast<float*>(w), rows, n, n_classes, k);
  return static_cast<int>(cudaGetLastError());
}
