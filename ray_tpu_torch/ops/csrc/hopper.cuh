// Hopper (sm_90a) building blocks of the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu): TMA tensor maps and tile loads, mbarriers,
// wgmma shared-memory descriptors and the wgmma products with their fences,
// and the packing of f32 accumulators into bf16 operands.
//
// Shared-memory tiles. A "panel" is a [rows][min(D, 64)] bf16 tile, what
// one TMA box writes: its rows are 32, 64 or 128 bytes, and TMA stores them
// with the swizzle of that width (16-byte chunk c of row r lands at chunk
// c ^ (r mod 8) within each 8-row group, folded to the row's chunks), which
// is the layout the wgmma descriptor's layout type of the same width reads.
// D = 128 is two panels, one after the other. Every panel starts 1024-byte
// aligned, so the swizzle phase of a row is its index.
//
// wgmma operands (PTX ISA, "Matrix Descriptor"; units are bytes):
//   - K-major (the product's K dimension contiguous, as Q and K are stored
//     for S = Q K^T): rows at `row_bytes`, 8-row groups at SBO = 8 row_bytes;
//     a k16 slice starts 32 bytes further along the row (LBO unused).
//   - MN-major (N contiguous, as V is stored for O += P V; read with the
//     transpose bit): the K dimension runs down the rows (8-row groups at
//     SBO = 8 row_bytes), N across the panel; the next panel of N is LBO
//     away; a k16 slice starts 16 rows further down.
// The f32 accumulator of m64nNk16 gives warp w of the warpgroup rows
// [16w, 16w + 16), laid out per 8-column chunk i as mma.sync's m16n8 C
// fragment (d[4i..4i+3]: (g, 8i+2t), (g, 8i+2t+1), (g+8, ..), (g+8, ..),
// g = lane / 4, t = lane % 4). A register A operand of m64nNk16 is
// mma.sync's m16n8k16 A fragment of the warp's 16 rows, so two neighbouring
// accumulator chunks, packed to bf16 (pack_bf16), are the A operand of the
// next product.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time (cudaGetDriverEntryPoint*),
// so the library links against the CUDA runtime only.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
    }
  }
  return fn;
}

constexpr int panel_cols(int D) { return D < 64 ? D : 64; }

// A tensor map over one [B, T, heads, D] bf16 tensor (the last dim
// contiguous, other strides in elements, multiples of 8) whose box is one
// panel: `rows` consecutive positions of one (batch, head), min(D, 64)
// columns, swizzled by the row's bytes. Coordinates are (column, position,
// head, batch); positions at or past T read as zeros.
inline cudaError_t make_panel_map(CUtensorMap* map, const void* ptr, int B, int T, int heads,
                                  int D, long long sb, long long st, long long sh, int rows) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int cols = panel_cols(D);
  const CUtensorMapSwizzle swizzle = cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st) * 2, static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Raises a kernel's dynamic shared-memory limit once per process.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool* done) {
  if (*done || bytes <= 48 * 1024) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err == cudaSuccess) *done = true;
  return err;
}

// Heads a block group visits together: as many as keep `bytes_per_head`
// of operands each within half the L2, so that the blocks of one head,
// which read the same K/V (or Q/dO), find them there.
inline int l2_head_group(long long bytes_per_head, int n_heads) {
  static int l2 = 0;
  if (l2 == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev) != cudaSuccess || l2 <= 0) {
      l2 = 50 << 20;
    }
  }
  const long long group = (l2 / 2) / (bytes_per_head > 0 ? bytes_per_head : 1);
  return static_cast<int>(group < 1 ? 1 : group < n_heads ? group : n_heads);
}

// ---------------------------------------------------------------- device

// The (head, tile) of linear block `block`: heads in groups of `group`;
// within a group, tile 0 of every head, then tile 1, and so on.
struct HeadTile {
  int head;
  int tile;
};

__device__ __forceinline__ HeadTile head_tile(int block, int n_tiles, int n_heads, int group) {
  const int span = group * n_tiles;
  const int first = block / span * group;
  const int rest = block - first * n_tiles;
  const int g = min(group, n_heads - first);
  return {first + rest % g, rest / g};
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the other threads and to TMA.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrives and adds `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the phase of parity `parity` has completed. A phase that has
// not completed after ~2^34 cycles (seconds) can only be a bug: trap, so
// the launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// One panel box of `map` at (col, pos, head, batch) into shared memory at
// `dst`; completes on `bar` with the box's bytes (zeros past the edge count).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int pos, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(pos), "r"(head), "r"(batch), "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                               int row_bytes) {
  const uint64_t layout = row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// Operand of a k16 slice of a K-major tile: `addr` is the first row's
// address plus the slice's byte offset along the row.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr, int row_bytes) {
  return wgmma_desc(addr, 16, 8 * row_bytes, row_bytes);
}

// Operand of a k16 slice of an MN-major tile: `addr` is the slice's first
// row; `panel_bytes` is the distance to the next panel of N.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr, int row_bytes,
                                                 uint32_t panel_bytes) {
  return wgmma_desc(addr, panel_bytes, 8 * row_bytes, row_bytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// 2^x in one MUFU instruction (exp2f adds a range fix-up around it).
// Results below 2^-126 flush to zero: a probability that small is zero to
// every bound the kernels are held to.
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The sum of x over the four lanes of a quad (lanes 4i .. 4i + 3), which
// share the rows of an accumulator.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Two f32 values as one register of two bf16 (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous products that write it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= A B for one m64nNk16 bf16 product with f32 accumulation.
// wgmma_ss: A and B from shared memory, both K-major; d is overwritten
// unless `accumulate`. wgmma_rs: A from registers, B MN-major (transposed);
// d accumulates.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int accumulate);
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

}  // namespace
