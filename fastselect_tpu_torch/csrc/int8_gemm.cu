// The discrete engine's int8 products on Hopper: one GEMM for every product
// of the Relief discrete engine (ops/relief_discrete.py `int8_gemm`)
//
//   C  = A B^T      (pass 2's products, the symmetric tier's match rows)
//   C += A B^T      (pass 1: each window's match counts added in place)
//
// A (M, K) and B (N, K) are int8 with K contiguous (B's rows may lie
// further apart: pass 2 cuts a class segment out of the wider one-hot),
// C (M, N) is int32 with unit column stride; every sum is exact.
//
// What it replaces: `torch._int_mm`, cuBLASLt's int8 kernels, which on an
// H100 are sm_80 `mma.sync` kernels (cutlass_80_tensorop_i16832gemm_s8),
// followed in pass 1 by an int32 add of each window's product into the
// counts.  No Pallas kernel is replaced: the JAX package leaves these
// products to XLA's `dot_general` (fastselect_tpu/ops/relief_discrete.py).
//
// What bounds it on the H100: operations, 2 M N K at the dense int8 rate of
// 1,979 TOP/s.  At the engine's shapes a tile of C does 2 * 128 * 256 * K
// operations for (128 + 256) K bytes of operands, about 170 operations a
// byte, which L2 turns into far more: the operands are not the limit.  The
// accumulating form also reads and writes C once a call, 1 GiB a pass-1
// window at 4,096 x 32,768, which the engine amortises by taking wide
// windows (`pass1_width`).
//
// What the design does about it:
//  - `wgmma.mma_async` m64n256k32 s8.s8 -> s32, the only path to Hopper's
//    full tensor-core rate: two consumer warpgroups each own 64 rows of a
//    128 x 256 tile of C in 128 registers a thread, both operands read from
//    shared memory through descriptors;
//  - one producer warp keeps TMA loads (`cp.async.bulk.tensor`) of 128-byte
//    K slices of A and B in flight through a ring of four stages in shared
//    memory, 48 KB a stage, with full and empty `mbarrier`s; TMA writes the
//    tiles in the 128-byte swizzle that the descriptors name, so neither
//    side spends an instruction on addresses or meets a bank conflict;
//  - the consumers keep one group of wgmmas in flight and free a stage as
//    soon as the group that read it has ended;
//  - persistent blocks, one an SM, walk the tiles with M fastest, so the
//    blocks in flight share B's rows and all of A in L2, and the producer
//    loads the next tile while the consumers run the epilogue;
//  - the epilogue hands C to TMA a chunk at a time through shared memory:
//    a reduce-add (`cp.reduce.async.bulk.tensor`, done at L2) for the
//    accumulating form, a store for the other, so reading and writing C
//    overlaps the next tile's products instead of stalling them; each
//    element of C is added once a call, and integer sums are exact in any
//    order;
//  - ragged M, N and K edges: TMA fills rows and K bytes past the operands
//    with zeros (they add nothing) and drops the rows and 16-byte pieces
//    of a chunk past C; it stores whole 16-byte pieces of a row, so C's
//    width is a multiple of 4 (the engine's widths are of 16).

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 128;            // rows of C a tile (two warpgroups)
constexpr int kBN = 256;            // columns of C a tile (one wgmma)
constexpr int kBK = 128;            // K bytes a stage: one swizzle row
constexpr int kStages = 4;
constexpr int kABytes = kBM * kBK;  // 16 KB
constexpr int kBBytes = kBN * kBK;  // 32 KB
constexpr int kConsumers = 2;       // warpgroups
constexpr int kThreads = kConsumers * 128 + 32;  // and one producer warp
constexpr int kCCols = 32;          // int32 columns of C a chunk: 128 bytes
constexpr int kCBytes = 64 * kCCols * 4;         // a warpgroup's chunk
constexpr int kSmem = kStages * (kABytes + kBBytes) + kConsumers * 2 * kCBytes
                      + 2 * kStages * 8 + 1024;
// a barrier wait longer than this many cycles (about 10 s) traps: a fault in
// the pipeline ends the launch with an error instead of hanging the card
constexpr long long kWaitCycles = 20000000000LL;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool bar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  if (bar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!bar_try(bar, parity)) {
    if (clock64() - t0 > kWaitCycles) asm volatile("trap;\n");
  }
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// One TMA load of the box at (k0, row0) of `map` into shared memory at
// `dst`, counted on `bar` as it lands.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int k0, int row0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(k0), "r"(row0)
      : "memory");
}

// Add the chunk in shared memory at `src` into C at (col0, row0) of
// `map_c`, or write it there; rows and 16-byte pieces past C are dropped.
template <bool ACCUMULATE>
__device__ __forceinline__ void tma_store(const CUtensorMap* map_c,
                                          uint32_t src, int col0, int row0) {
  if (ACCUMULATE) {
    asm volatile(
        "cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.bulk_group"
        " [%0, {%2, %3}], [%1];\n"
        :: "l"(reinterpret_cast<uint64_t>(map_c)), "r"(src), "r"(col0),
           "r"(row0)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
        " [%0, {%2, %3}], [%1];\n"
        :: "l"(reinterpret_cast<uint64_t>(map_c)), "r"(src), "r"(col0),
           "r"(row0)
        : "memory");
  }
}

// Wait until at most N of this thread's bulk copies still read shared
// memory (N = 0 at the end: until all have also landed).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared_v2(uint32_t addr, int32_t x,
                                             int32_t y) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n"
               :: "r"(addr), "r"(x), "r"(y) : "memory");
}

// A barrier of warpgroup wg's 128 threads alone (barrier 0 is the block's).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(wg + 1) : "memory");
}

// The wgmma descriptor of a K-major tile in shared memory at `addr`, rows
// of 128 bytes in the 128-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B),
// 8-row groups 1,024 bytes apart.  The leading byte offset is unused: the
// 32 bytes of K of one wgmma lie inside one swizzle row, and the next 32
// are reached by moving the start address.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma boundary.
__device__ __forceinline__ void fence_acc(int32_t (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// d (+)= A B^T over 32 bytes of K: A 64 x 32 and B 256 x 32 in shared
// memory; with `accumulate` 0, d = A B^T.
__device__ __forceinline__ void wgmma_m64n256k32(int32_t (&d)[128],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// A warpgroup's 64 x 256 block of C leaves through shared memory in eight
// chunks of 64 rows by 32 columns (128 bytes a row, in the 128-byte
// swizzle), two buffers in turn: the warpgroup writes a chunk, one thread
// hands it to TMA, which adds it into C (`cp.reduce.async.bulk.tensor`
// .add, done at L2) or writes it, and the warpgroup goes on while the copy
// drains; a buffer is rewritten only once TMA has read it.  Register
// 4 j + 2 h + e of a thread holds row 16 (warp % 4) + 8 h + lane / 4 and
// column 8 j + 2 (lane % 4) + e of the block.
template <bool ACCUMULATE>
__device__ __forceinline__ void store_tile(const int32_t (&d)[128],
                                           const CUtensorMap* map_c,
                                           uint32_t bufs, int wg, int row0,
                                           int col0) {
  const int t = threadIdx.x % 128;
  const int row = (t / 32) * 16 + (t % 32) / 4;
  const int col = 2 * (t % 4);
#pragma unroll
  for (int q = 0; q < kBN / kCCols; ++q) {
    const uint32_t buf = bufs + (q % 2) * kCBytes;
    if (t == 0) bulk_wait_read<1>();
    warpgroup_sync(wg);
#pragma unroll
    for (int jj = 0; jj < kCCols / 8; ++jj) {
      const int j = q * (kCCols / 8) + jj;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t off = (row + 8 * h) * 128 + (8 * jj + col) * 4;
        st_shared_v2(buf + (off ^ (((off >> 7) & 7) << 4)),
                     d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    warpgroup_sync(wg);
    if (t == 0) {
      tma_store<ACCUMULATE>(map_c, buf, col0 + q * kCCols, row0);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
}

template <bool ACCUMULATE>
__global__ void __launch_bounds__(kThreads, 1)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const __grid_constant__ CUtensorMap map_c, int m, int n,
                     int k) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzled tiles start on 1,024-byte boundaries
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sa = base;                             // kStages A tiles
  const uint32_t sb = base + kStages * kABytes;         // kStages B tiles
  const uint32_t sc = sb + kStages * kBBytes;           // C chunks
  const uint32_t full = sc + kConsumers * 2 * kCBytes;  // kStages barriers
  const uint32_t empty = full + kStages * 8;            // kStages barriers

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full + 8 * s, 1);
      bar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles_m = (m + kBM - 1) / kBM;
  const int tiles = tiles_m * ((n + kBN - 1) / kBN);
  const int k_tiles = (k + kBK - 1) / kBK;

  if (warp == 4 * kConsumers) {
    // the producer: one thread keeps the ring full
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t % tiles_m) * kBM;
        const int n0 = (t / tiles_m) * kBN;
        for (int kt = 0; kt < k_tiles; ++kt) {
          bar_wait(empty + 8 * stage, phase ^ 1u);
          bar_expect(full + 8 * stage, kABytes + kBBytes);
          tma_load(sa + stage * kABytes, &map_a, full + 8 * stage,
                   kt * kBK, m0);
          tma_load(sb + stage * kBBytes, &map_b, full + 8 * stage,
                   kt * kBK, n0);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of a tile
  const int wg = warp / 4;
  const uint32_t a_rows = wg * 64 * kBK;
  int32_t d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t % tiles_m) * kBM;
    const int n0 = (t / tiles_m) * kBN;
    int prev = -1;
    fence_acc(d);
    for (int kt = 0; kt < k_tiles; ++kt) {
      bar_wait(full + 8 * stage, phase);
      const uint32_t a = sa + stage * kABytes + a_rows;
      const uint32_t b = sb + stage * kBBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        wgmma_m64n256k32(d, smem_desc(a + 32 * kk), smem_desc(b + 32 * kk),
                         (kt > 0 || kk > 0) ? 1 : 0);
      wgmma_commit();
      fence_acc(d);
      if (prev >= 0) {
        // the group that read the previous stage has ended: free it
        wgmma_wait<1>();
        fence_acc(d);
        if (threadIdx.x % 128 == 0) bar_arrive(empty + 8 * prev);
      }
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1u;
      }
    }
    wgmma_wait<0>();
    fence_acc(d);
    if (threadIdx.x % 128 == 0) bar_arrive(empty + 8 * prev);
    store_tile<ACCUMULATE>(d, &map_c, sc + wg * 2 * kCBytes, wg,
                           m0 + wg * 64, n0);
  }
  if (threadIdx.x % 128 == 0) bulk_wait_all();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the CUDA runtime, so
// the library does not link against libcuda; null where it is missing.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The TMA map of a (rows, cols) matrix of int8 (`int32` false) or int32
// with rows `ld` bytes apart, moved in boxes of `box_cols` by `box_rows` in
// the 128-byte swizzle; loads past the matrix give zeros, stores past it
// are dropped.
int make_map(CUtensorMap* map, const void* ptr, bool int32, int cols,
             int rows, long long ld, int box_cols, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, int32 ? CU_TENSOR_MAP_DATA_TYPE_INT32 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      2, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <bool ACCUMULATE>
int launch(const CUtensorMap& map_a, const CUtensorMap& map_b,
           const CUtensorMap& map_c, int m, int n, int k,
           cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      int8_gemm_kernel<ACCUMULATE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device, sms;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int tiles = ((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
  int8_gemm_kernel<ACCUMULATE>
      <<<tiles < sms ? tiles : sms, kThreads, kSmem, stream>>>(
          map_a, map_b, map_c, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// c (m, n) int32, ldc elements a row: c = a b^T, or c += a b^T with
// `accumulate`, for int8 a (m, k) and b (n, k) with lda and ldb bytes a
// row.  The three bases and row strides must be 16-byte aligned, and n a
// multiple of 4.
extern "C" int fs_int8_gemm(const void* a, int lda, const void* b, int ldb,
                            void* c, int ldc, int m, int n, int k,
                            int accumulate, void* stream) {
  const auto addr = reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b) |
                    reinterpret_cast<uintptr_t>(c);
  if (m <= 0 || n <= 0 || k <= 0 || lda < k || ldb < k || ldc < n ||
      addr % 16 != 0 || lda % 16 != 0 || ldb % 16 != 0 || ldc % 4 != 0 ||
      n % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a, map_b, map_c;
  int err = make_map(&map_a, a, false, k, m, lda, kBK, kBM);
  if (err == 0) err = make_map(&map_b, b, false, k, n, ldb, kBK, kBN);
  if (err == 0) err = make_map(&map_c, c, true, n, m, 4LL * ldc, kCCols, 64);
  if (err != 0) return err;
  auto s = static_cast<cudaStream_t>(stream);
  return accumulate ? launch<true>(map_a, map_b, map_c, m, n, k, s)
                    : launch<false>(map_a, map_b, map_c, m, n, k, s);
}
