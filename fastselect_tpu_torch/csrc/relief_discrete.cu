// Relief's all-discrete engine on Hopper: the two fusions that XLA makes of
// every feature window of the JAX package's discrete engine
//
//   window_onehot    the int8 one-hot GEMM operand of one window of codes
//                    (fastselect_tpu/ops/relief_discrete.py `_codes_window`
//                    :300 and `_onehot_flat` :55, fused by XLA into the
//                    operand of the dot in the scans of `_match_rows`,
//                    `_accumulate_discrete`, `_accumulate_plan` and
//                    `_accumulate_plan_gather`):
//                      hot[r, c * wp + f] = 1[code(r, off + f) == c]
//                    for f < w, and 0 for w <= f < wp (the GEMM's padding),
//                    as rows (flat) or transposed, rows contiguous;
//   window_partials  pass 2's epilogue of one window (`:596-603`,
//                    `:700-707`, `:390-397`): from the int32 products
//                    q_k = M_k @ onehot of the plan's operands,
//                      v[i, f]  = sum_k coeff_k[i] * float(q_k[i, ci[i, f] * wp + f])
//                      part[f]  = total_w - sum_i v[i, f]
//                    where an operand of several segments sums their
//                    products in int32 first, and on the exact-int path
//                    every term and sum is an integer.
//
// What bounds them on the H100: bytes.  The one-hot reads a byte (or a
// quarter of one, packed) and writes S bytes a code; the epilogue reads
// every q once (with S = 3 random states about 96% of the 32-byte sectors
// of each q row hold a needed value, so it reads the whole products) and
// does a few operations a value.
//
// What the design does about it:
//  - window_onehot: a thread expands four consecutive features of a row
//    into one 32-bit word a state (`__vcmpeq4`), so every store is a word
//    and a warp writes 128 consecutive bytes of an output row.  Packed
//    codes are unpacked as they are read, and rows come through an
//    optional int64 index (the gather route's class order), so no
//    unpacked or gathered copy of the window exists.  The transposed form
//    stages a tile of 128 rows by 64 features in shared memory, then each
//    warp writes 128 consecutive rows of one (state, feature) output row:
//    reads and writes are both coalesced.
//  - window_partials: threads own features (32 a block, consecutive, so
//    each q row is read coalesced) and 8 warps split the block's focal
//    rows; a grid row (blockIdx.y) takes a fixed span of focal rows, so
//    the grid fills the card.  A thread reads each row's focal code, then
//    the one value of each product at that state, four rows in flight.
//    It adds v in plan order with separately rounded multiply and add, as
//    the plain version's p_sum does, sums its rows in order, the 8 warps
//    are summed in order through shared memory, and a second small kernel
//    adds the spans in order and takes total_w less the sum.  No atomics:
//    the bits depend on the shape alone, the same on every run and route.
//    The products' and coefficients' addresses come in a small int64
//    table in device memory, so any number of operands and segments fits
//    and no stacked copy of the products is made.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// window_onehot
// ---------------------------------------------------------------------------

constexpr int kHotThreads = 128;           // flat: 512 features a block
constexpr int kTRows = 128;                // transposed tile: rows
constexpr int kTFeats = 64;                // transposed tile: features
constexpr int kTPitch = kTRows + 4;        // bytes a staged feature row
constexpr int kTThreads = 256;

// The code of feature g of a row: a byte, or BITS bits of byte g / per.
template <int BITS>
__device__ __forceinline__ uint32_t code_at(const uint8_t* __restrict__ row,
                                            unsigned g) {
  if constexpr (BITS == 0) {
    return row[g];
  } else {
    constexpr unsigned kPer = 8 / BITS;
    return (row[g / kPer] >> (BITS * (g % kPer))) & ((1u << BITS) - 1u);
  }
}

// Codes of features f..f+3 of a window as the bytes of a word, feature f
// lowest; features at or past w read 0xFF, which matches no state.
template <int BITS>
__device__ __forceinline__ uint32_t load4(const uint8_t* __restrict__ row,
                                          int off, int f, int w) {
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t code = f + j < w ? code_at<BITS>(row, off + f + j) : 0xFFu;
    word |= code << (8 * j);
  }
  return word;
}

// Byte j of the result is 1 where byte j of `codes` equals c, else 0.
__device__ __forceinline__ uint32_t match4(uint32_t codes, int c) {
  return __vcmpeq4(codes, 0x01010101u * static_cast<uint32_t>(c)) &
         0x01010101u;
}

__device__ __forceinline__ void store4(uint8_t* dst, uint32_t word,
                                       int valid) {
  if (valid >= 4 && (reinterpret_cast<uintptr_t>(dst) & 3) == 0) {
    *reinterpret_cast<uint32_t*>(dst) = word;
  } else {
    for (int j = 0; j < 4 && j < valid; ++j) dst[j] = (word >> (8 * j)) & 0xFF;
  }
}

__device__ __forceinline__ const uint8_t* row_of(const uint8_t* codes,
                                                 int ld_codes,
                                                 const int64_t* rows, int r) {
  const int64_t src = rows == nullptr ? r : rows[r];
  return codes + src * static_cast<int64_t>(ld_codes);
}

// out[r * ld_out + c * wp + f]: block (row r = blockIdx.x, 512 features).
template <int BITS>
__global__ void __launch_bounds__(kHotThreads)
onehot_kernel(const uint8_t* __restrict__ codes, int ld_codes,
              const int64_t* __restrict__ rows, int off, int w, int wp,
              int n_states, uint8_t* __restrict__ out, int ld_out) {
  const int r = blockIdx.x;
  const int f = 4 * (blockIdx.y * kHotThreads + threadIdx.x);
  if (f >= wp) return;
  const uint32_t word =
      load4<BITS>(row_of(codes, ld_codes, rows, r), off, f, w);
  uint8_t* dst = out + static_cast<int64_t>(r) * ld_out + f;
  for (int c = 0; c < n_states; ++c)
    store4(dst + static_cast<int64_t>(c) * wp, match4(word, c), wp - f);
}

// out[(c * wp + f) * ld_out + r]: block (128 rows, 64 features).
template <int BITS>
__global__ void __launch_bounds__(kTThreads)
onehot_t_kernel(const uint8_t* __restrict__ codes, int ld_codes,
                const int64_t* __restrict__ rows, int n_rows, int off, int w,
                int wp, int n_states, uint8_t* __restrict__ out,
                int ld_out) {
  __shared__ __align__(16) uint8_t tile[kTFeats][kTPitch];
  const int r0 = blockIdx.x * kTRows;
  const int f0 = blockIdx.y * kTFeats;
  constexpr int kQuads = kTFeats / 4;
  for (int idx = threadIdx.x; idx < kTRows * kQuads; idx += kTThreads) {
    const int rl = idx / kQuads, q = idx % kQuads;
    const int r = r0 + rl, f = f0 + 4 * q;
    const uint32_t word =
        r < n_rows && f < wp
            ? load4<BITS>(row_of(codes, ld_codes, rows, r), off, f, w)
            : 0xFFFFFFFFu;
#pragma unroll
    for (int j = 0; j < 4; ++j) tile[4 * q + j][rl] = (word >> (8 * j)) & 0xFF;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = r0 + 4 * lane;
  if (r >= n_rows) return;
  for (int job = warp; job < n_states * kTFeats; job += kTThreads / 32) {
    const int c = job / kTFeats, fl = job % kTFeats, f = f0 + fl;
    if (f >= wp) continue;
    const uint32_t word = *reinterpret_cast<const uint32_t*>(&tile[fl][4 * lane]);
    store4(out + (static_cast<int64_t>(c) * wp + f) * ld_out + r,
           match4(word, c), n_rows - r);
  }
}

template <int BITS>
int launch_onehot(const uint8_t* codes, int ld_codes, const int64_t* rows,
                  int n_rows, int off, int w, int wp, int n_states,
                  uint8_t* out, int ld_out, bool transpose,
                  cudaStream_t s) {
  if (transpose) {
    const dim3 grid((n_rows + kTRows - 1) / kTRows,
                    (wp + kTFeats - 1) / kTFeats);
    onehot_t_kernel<BITS><<<grid, kTThreads, 0, s>>>(
        codes, ld_codes, rows, n_rows, off, w, wp, n_states, out, ld_out);
  } else {
    const dim3 grid(n_rows, (wp + 4 * kHotThreads - 1) / (4 * kHotThreads));
    onehot_kernel<BITS><<<grid, kHotThreads, 0, s>>>(
        codes, ld_codes, rows, off, w, wp, n_states, out, ld_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// window_partials
// ---------------------------------------------------------------------------

constexpr int kPFeats = 32;                // features a block, one a lane
constexpr int kPWarps = 8;                 // row groups a block
constexpr int kUnroll = 4;                 // focal rows in flight a thread

// The table of one launch, int64 in device memory: n_products product
// addresses (int32 (n_rows, n_states * wp) each), then n_operands
// coefficient addresses ((n_rows,), or 0 for the coefficient 1), then
// n_operands + 1 segment starts: operand k sums products
// [first[k], first[k + 1]).
struct Table {
  const int64_t* __restrict__ t;
  int n_products, n_operands;
  __device__ __forceinline__ const int32_t* q(int j) const {
    return reinterpret_cast<const int32_t*>(__ldg(t + j));
  }
  __device__ __forceinline__ const void* coeff(int k) const {
    return reinterpret_cast<const void*>(__ldg(t + n_products + k));
  }
  __device__ __forceinline__ int first(int k) const {
    return static_cast<int>(__ldg(t + n_products + n_operands + k));
  }
};

// partial[y, f] = the sum of v[i, f] over focal rows [y * span, (y + 1) *
// span), in row order within each warp and then warp order.
template <bool INT, int BITS>
__global__ void __launch_bounds__(kPFeats * kPWarps)
partials_kernel(const Table ops,
                const uint8_t* __restrict__ ci, int ld_ci, int off,
                int n_rows, int w, int wp, int n_states, int span,
                std::conditional_t<INT, int32_t, float>* __restrict__ partial) {
  using Acc = std::conditional_t<INT, int32_t, float>;
  __shared__ Acc red[kPWarps][kPFeats];
  const int lane = threadIdx.x % kPFeats, warp = threadIdx.x / kPFeats;
  const int f = blockIdx.x * kPFeats + lane;
  const int i0 = blockIdx.y * span;
  const int i1 = min(n_rows, i0 + span);
  const int64_t ld_q = static_cast<int64_t>(n_states) * wp;
  Acc acc = 0;
  if (f < w) {
    for (int i = i0 + warp; i < i1; i += kUnroll * kPWarps) {
      int64_t at[kUnroll];
      bool on[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int iu = i + u * kPWarps;
        const uint32_t c =
            iu < i1 ? code_at<BITS>(ci + static_cast<int64_t>(iu) * ld_ci,
                                    off + f)
                    : 0xFFu;
        on[u] = c < static_cast<uint32_t>(n_states);
        at[u] = iu * ld_q + static_cast<int64_t>(c) * wp + f;
      }
      Acc v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = 0;
      for (int k = 0, j1 = ops.first(0); k < ops.n_operands; ++k) {
        int32_t s[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) s[u] = 0;
        const int j0 = j1;
        j1 = ops.first(k + 1);
        for (int j = j0; j < j1; ++j) {
          const int32_t* q = ops.q(j);
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (on[u]) s[u] += __ldg(q + at[u]);
        }
        const void* coeff = ops.coeff(k);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int iu = i + u * kPWarps;
          if constexpr (INT) {
            v[u] += coeff == nullptr
                        ? s[u]
                        : s[u] * static_cast<const int32_t*>(coeff)[on[u] ? iu : 0];
          } else {
            const float t =
                coeff == nullptr
                    ? static_cast<float>(s[u])
                    : __fmul_rn(static_cast<float>(s[u]),
                                static_cast<const float*>(coeff)[on[u] ? iu : 0]);
            v[u] = __fadd_rn(v[u], t);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!on[u]) continue;
        if constexpr (INT) {
          acc += v[u];
        } else {
          acc = __fadd_rn(acc, v[u]);
        }
      }
    }
  }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp != 0 || f >= w) return;
  Acc t = red[0][lane];
#pragma unroll
  for (int y = 1; y < kPWarps; ++y) {
    if constexpr (INT) {
      t += red[y][lane];
    } else {
      t = __fadd_rn(t, red[y][lane]);
    }
  }
  partial[static_cast<int64_t>(blockIdx.y) * w + f] = t;
}

// out[f] = total_w - the spans' partials added in order.
template <bool INT>
__global__ void partials_finish_kernel(
    const std::conditional_t<INT, int32_t, float>* __restrict__ partial,
    int spans, int w, const void* __restrict__ total_w,
    float* __restrict__ out) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= w) return;
  auto t = partial[f];
  for (int y = 1; y < spans; ++y) {
    if constexpr (INT) {
      t += partial[static_cast<int64_t>(y) * w + f];
    } else {
      t = __fadd_rn(t, partial[static_cast<int64_t>(y) * w + f]);
    }
  }
  if constexpr (INT) {
    out[f] = static_cast<float>(*static_cast<const int64_t*>(total_w) -
                                static_cast<int64_t>(t));
  } else {
    out[f] = __fsub_rn(*static_cast<const float*>(total_w), t);
  }
}

template <bool INT, int BITS>
int launch_partials(const Table& ops, const uint8_t* ci, int ld_ci,
                    int off, int n_rows, int w, int wp, int n_states,
                    const void* total_w, void* partial, int spans, int span,
                    float* out, cudaStream_t s) {
  using Acc = std::conditional_t<INT, int32_t, float>;
  const dim3 grid((w + kPFeats - 1) / kPFeats, spans);
  partials_kernel<INT, BITS><<<grid, kPFeats * kPWarps, 0, s>>>(
      ops, ci, ld_ci, off, n_rows, w, wp, n_states, span,
      static_cast<Acc*>(partial));
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  partials_finish_kernel<INT><<<(w + 255) / 256, 256, 0, s>>>(
      static_cast<const Acc*>(partial), spans, w, total_w, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool INT>
int dispatch_partials(int bits, const Table& ops, const uint8_t* ci,
                      int ld_ci, int off, int n_rows, int w, int wp,
                      int n_states, const void* total_w, void* partial,
                      int spans, int span, float* out, cudaStream_t s) {
  switch (bits) {
    case 0:
      return launch_partials<INT, 0>(ops, ci, ld_ci, off, n_rows, w, wp,
                                     n_states, total_w, partial, spans, span,
                                     out, s);
    case 1:
      return launch_partials<INT, 1>(ops, ci, ld_ci, off, n_rows, w, wp,
                                     n_states, total_w, partial, spans, span,
                                     out, s);
    case 2:
      return launch_partials<INT, 2>(ops, ci, ld_ci, off, n_rows, w, wp,
                                     n_states, total_w, partial, spans, span,
                                     out, s);
    case 4:
      return launch_partials<INT, 4>(ops, ci, ld_ci, off, n_rows, w, wp,
                                     n_states, total_w, partial, spans, span,
                                     out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The one-hot of features [off, off + w) of n_rows rows of codes: int8
// codes (bits 0) or codes packed 8 / bits a byte little-endian (off a
// multiple of 8 / bits), rows ld_codes bytes apart, row r read from row
// rows[r] (int64) or, with rows null, row r.  Flat (transpose 0):
// out[r * ld_out + c * wp + f]; transposed: out[(c * wp + f) * ld_out + r];
// int8 0/1 for c < n_states and f < wp, 0 past w.  Launches on `stream` and
// returns cudaGetLastError() of the launch.
extern "C" int fs_window_onehot(const void* codes, int ld_codes,
                                const void* rows, int n_rows, int off, int w,
                                int wp, int bits, int n_states, void* out,
                                int ld_out, int transpose, void* stream) {
  if (n_rows <= 0 || w <= 0 || wp < w || n_states <= 0 || n_states > 255)
    return static_cast<int>(cudaErrorInvalidValue);
  auto c = static_cast<const uint8_t*>(codes);
  auto r = static_cast<const int64_t*>(rows);
  auto o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 0:
      return launch_onehot<0>(c, ld_codes, r, n_rows, off, w, wp, n_states,
                              o, ld_out, transpose != 0, s);
    case 1:
      return launch_onehot<1>(c, ld_codes, r, n_rows, off, w, wp, n_states,
                              o, ld_out, transpose != 0, s);
    case 2:
      return launch_onehot<2>(c, ld_codes, r, n_rows, off, w, wp, n_states,
                              o, ld_out, transpose != 0, s);
    case 4:
      return launch_onehot<4>(c, ld_codes, r, n_rows, off, w, wp, n_states,
                              o, ld_out, transpose != 0, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out (w,) float32 = pass 2's partials of one window.  table is the int64
// device table of Table above (n_products products, n_operands operands);
// the coefficients are float32 (int32 with int_mode).  The focal codes ci
// are read as fs_window_onehot reads codes (bits, off, rows ld_ci bytes
// apart).  total_w is a float32 scalar on the device (int64 with
// int_mode).  partial is scratch for spans x w values of 4 bytes: grid
// row y sums focal rows [y * span, (y + 1) * span).  Launches on `stream`
// and returns cudaGetLastError() of the launches.
extern "C" int fs_window_partials(const void* table, int n_products,
                                  int n_operands, int int_mode,
                                  const void* ci, int ld_ci, int off,
                                  int bits, int n_rows, int w, int wp,
                                  int n_states, const void* total_w,
                                  void* partial, int spans, int span,
                                  void* out, void* stream) {
  if (table == nullptr || n_products < n_operands || n_operands <= 0 ||
      n_rows <= 0 || w <= 0 || wp < w || spans <= 0 || span <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Table ops{static_cast<const int64_t*>(table), n_products,
                  n_operands};
  auto c = static_cast<const uint8_t*>(ci);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return int_mode
             ? dispatch_partials<true>(bits, ops, c, ld_ci, off, n_rows, w,
                                       wp, n_states, total_w, partial, spans,
                                       span, o, s)
             : dispatch_partials<false>(bits, ops, c, ld_ci, off, n_rows, w,
                                        wp, n_states, total_w, partial, spans,
                                        span, o, s);
}
