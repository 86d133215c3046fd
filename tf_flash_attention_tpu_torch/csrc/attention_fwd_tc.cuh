// The tensor-core forward of the op path for Hopper (sm_90a): the tile body
// of fa_flash_fwd (kTable, <- ops/forward.py::_fwd_kernel) and fa_banded_fwd
// (kBanded, <- ops/forward_banded.py::_banded_kernel) on bf16 and fp16
// inputs.  Included by attention_kernels.cu and band_kernels.cu after
// attention_common.cuh; float32 inputs stay on the scalar body there (full
// float32 products: TF32 would not hold the float32 limit).
//
// What bounds the forward on this card is the tensor cores' rate (989
// TFLOP/s bf16): at d 128 a query row does 4 d = 512 flops per visible key
// against 2 d bytes of K/V read per key per 128-row CTA.  The design keeps
// the tensor cores fed:
//   CTA      one per (query row b, 128 query rows, 256-column chunk of v_d):
//            two consumer warpgroups of 64 rows and one producer warp.  The
//            CTA walks its schedule row as the scalar body does (kTable: the
//            kv_table / kv_counts / needs_mask row; kBanded: the four band
//            ints) in stages of BN keys.  Query tiles launch last-first, so
//            a causal row's long tiles start first and the short ones fill
//            the tail.
//   operands stay in the input type in shared memory, in slabs of 64
//            columns (128 bytes a row) in the 128-byte swizzle that wgmma's
//            descriptors read: Q once, K and V in a ring of two stages.
//   loads    the producer issues TMA copies (cp.async.bulk.tensor, 3-d maps
//            (cols, rows, batch) so rows past q_len / k_len and columns past
//            d / v_d arrive as zeros) completing on mbarriers; where a row
//            pitch is not a multiple of 16 bytes (d or v_d not a multiple of
//            8) the producer warp stages the same layout with plain loads.
//            Consumers release a stage on its empty barrier once their
//            products have read it.
//   products S = Q K^T: wgmma m64nBNk16, both operands in shared memory,
//            unrolled over the class's width (d padded with zeros to 128,
//            256 or 512: 128-, 64- or 32-key stages) so the products
//            pipeline.  O += P V: wgmma m64nVNk16 with P from registers (the
//            S accumulator fragments rounded to T pairs) and V MN-major
//            through the descriptor's transpose bit.  The two wide classes
//            (VN = 256) hold 128 accumulators a thread, and ptxas serializes
//            their products for want of registers.
//   softmax  in registers on the accumulator fragments, in the log2 domain
//            as the scalar body: row max and sum across each quad by
//            shuffles, m and l in registers, no score tile in shared memory
//            and no barrier per tile.  p is rounded to T for PV while l sums
//            the float32 p, as the JAX kernels do.  Masked stages run a body
//            compiled with visible() per element (the orders of the thread's
//            rows and columns computed once a stage); interior stages run one
//            compiled without it: a single body with a run-time test paid the
//            predicate on every stage.  Masked logits take the finite 0xFA
//            value; dead rows get O = 0, l = 0, m = NEG_INF.
// The tensor map encoder comes from the driver through
// cudaGetDriverEntryPoint, so the library needs no -lcuda.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <string.h>

#include <type_traits>

#include "attention_common.cuh"

namespace {
namespace tc {

constexpr int kBM = 128;                     // query rows per CTA
constexpr int kConsumers = 256;              // two warpgroups
constexpr int kThreads = kConsumers + 32;    // and the producer warp
constexpr int kSlabCols = 64;                // columns per 128-byte swizzled row
constexpr int kRowBytes = 128;
// the 64-column slabs of Q and K of each class (by its stage of BN keys):
// d <= 128, <= 256, <= 512
__host__ __device__ constexpr int slabs_of(int bn) { return bn == 128 ? 2 : bn == 64 ? 4 : 8; }
constexpr int kStages = 2;  // the K/V ring (a third stage measured no faster)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// generic-proxy writes to shared memory become visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// one TMA box (64 columns x rows x 1) of a 3-d map at (col, row, batch)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(batch)
      : "memory");
}

// ---- wgmma ----
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from moving accumulator reads across the asynchronous
// products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (in 16-byte units); tiles are 1024-byte aligned
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | static_cast<uint64_t>(1) << 62;
}

// D (64 x 32, float) += A B^T, A and B K-major in shared memory
template <typename T>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db) {
  if constexpr (std::is_same<T, bf16>::value) {
    asm volatile(
        "{ .reg .pred p; setp.ne.b32 p, %18, 0; "
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0; }"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{ .reg .pred p; setp.ne.b32 p, %18, 0; "
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0; }"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
}

// D (64 x 64, float) += A B^T, A and B K-major in shared memory
template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  if constexpr (std::is_same<T, bf16>::value) {
    asm volatile(
        "{ .reg .pred p; setp.ne.b32 p, %34, 0; "
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0; }"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{ .reg .pred p; setp.ne.b32 p, %34, 0; "
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0; }"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
}

// D (64 x 128, float) += A B^T, A and B K-major in shared memory
template <typename T>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db) {
  if constexpr (std::is_same<T, bf16>::value) {
    asm volatile(
        "{ .reg .pred p; setp.ne.b32 p, %66, 0; "
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0; }"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{ .reg .pred p; setp.ne.b32 p, %66, 0; "
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0; }"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
}

// D (64 x 128, float) += A B, A from registers (fragments of T pairs), B
// MN-major in shared memory (the transpose bit)
template <typename T>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t db) {
  if constexpr (std::is_same<T, bf16>::value) {
    asm volatile(
        "{ .reg .pred p; setp.ne.b32 p, %69, 0; "
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1; }"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{ .reg .pred p; setp.ne.b32 p, %69, 0; "
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1; }"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

// D (64 x 256, float) += A B, A from registers (fragments of T pairs), B
// MN-major in shared memory (the transpose bit)
template <typename T>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t* a, uint64_t db) {
  if constexpr (std::is_same<T, bf16>::value) {
    asm volatile(
        "{ .reg .pred p; setp.ne.b32 p, %133, 0; "
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1; }"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{ .reg .pred p; setp.ne.b32 p, %133, 0; "
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1; }"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

template <int N, typename T>
__device__ __forceinline__ void mma_qk(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 32) wgmma_ss_n32<T>(d, da, db);
  else if constexpr (N == 64) wgmma_ss_n64<T>(d, da, db);
  else wgmma_ss_n128<T>(d, da, db);
}
template <int N, typename T>
__device__ __forceinline__ void mma_pv(float (&d)[N / 2], const uint32_t* a, uint64_t db) {
  if constexpr (N == 128) wgmma_rs_n128<T>(d, a, db);
  else wgmma_rs_n256<T>(d, a, db);
}

// two floats as one register of T pairs (the lower column in the low half)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float x, float y) {
  uint32_t r;
  if constexpr (std::is_same<T, bf16>::value) {
    __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    r = *reinterpret_cast<uint32_t*>(&h);
  } else {
    __half2 h = __floats2half2_rn(x, y);
    r = *reinterpret_cast<uint32_t*>(&h);
  }
  return r;
}

// byte offset of element (r, c) in a swizzled tile of `rows` rows, slabs of
// 64 columns one after the other
__device__ __forceinline__ int swz(int r, int c, int rows) {
  const int cc = c & (kSlabCols - 1);
  return (c >> 6) * rows * kRowBytes + r * kRowBytes + ((((cc >> 3) ^ (r & 7))) << 4) +
         (cc & 7) * 2;
}

// staging without TMA (threads `id` of `n`): rows [row0, row0 + rows) of a
// (n_rows, cols) matrix, columns [col0, col0 + slabs * 64), zero outside
template <typename T>
__device__ __forceinline__ void stage_plain(unsigned char* dst, const T* src, int row0, int rows,
                                            int n_rows, int col0, int slabs, int cols, int id,
                                            int n = 32) {
  const int width = slabs * kSlabCols;
  for (int i = id; i < rows * width; i += n) {
    const int r = i / width, c = i - r * width, gr = row0 + r, gc = col0 + c;
    *reinterpret_cast<T*>(dst + swz(r, c, rows)) =
        gr < n_rows && gc < cols ? src[static_cast<size_t>(gr) * cols + gc] : from_f<T>(0.f);
  }
}

// calls f(c0, masked) for every BN-key stage of the CTA's walk, in order
template <int WALK, int BN, typename F>
__device__ __forceinline__ void for_each_stage(const AttnArgs& a, int qi, F&& f) {
  const int bkv = a.block_kv, k_len = a.rule.k_len;
  auto block = [&](int blk, bool masked) {
    const int end = min((blk + 1) * bkv, k_len);
    for (int c0 = blk * bkv; c0 < end; c0 += BN) f(c0, masked);
  };
  if constexpr (WALK == kTable) {
    const int n_steps = a.counts[qi];
    for (int step = 0; step < n_steps; ++step)
      block(a.table[qi * a.num_steps + step], a.needs[qi * a.num_steps + step] != 0);
  } else {  // kBanded: masked prefix [seg0, i0), interior [i0, i1), masked suffix
    const int* seg = a.table + 4 * qi;
    for (int blk = seg[0]; blk < seg[3]; ++blk) block(blk, blk < seg[1] || blk >= seg[2]);
  }
}

template <typename T, int WALK, int BN, int VN>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_tc_kernel(const __grid_constant__ AttnArgs a, const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, int tma) {
  constexpr int VS = VN / kSlabCols;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* Qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int d = a.d, v_d = a.v_d, q_len = a.rule.q_len, k_len = a.rule.k_len;
  constexpr int ds = slabs_of(BN);  // Q and K slabs: d padded to the class's width
  const int k_bytes = ds * BN * kRowBytes, stage_bytes = k_bytes + VS * BN * kRowBytes;
  unsigned char* stages = Qs + ds * kBM * kRowBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(stages + kStages * stage_bytes);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int tid = threadIdx.x;
  const int b = blockIdx.x, row0 = (gridDim.y - 1 - blockIdx.y) * kBM, vc0 = blockIdx.z * VN;
  const int qi = row0 / a.block_q, bkv_row = b / a.g;
  if (tid == 0) {
    mbar_init(q_full, tma ? 1 : 32);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, tma ? 1 : 32);
      mbar_init(empty + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // ---- the producer warp ----
    const int lane = tid - kConsumers;
    const T* kb = static_cast<const T*>(a.k) + static_cast<size_t>(bkv_row) * k_len * d;
    const T* vb = static_cast<const T*>(a.v) + static_cast<size_t>(bkv_row) * k_len * v_d;
    if (tma) {
      if (lane != 0) return;
      mbar_expect_tx(q_full, ds * kBM * kRowBytes);
      for (int s = 0; s < ds; ++s)
        tma_load(Qs + s * kBM * kRowBytes, &qmap, q_full, s * kSlabCols, row0, b);
    } else {
      stage_plain(Qs, static_cast<const T*>(a.q) + static_cast<size_t>(b) * q_len * d, row0, kBM,
                  q_len, 0, ds, d, lane);
      fence_proxy_async();
      mbar_arrive(q_full);
    }
    int it = 0;
    for_each_stage<WALK, BN>(a, qi, [&](int c0, bool) {
      const int st = it % kStages;
      if (it >= kStages) mbar_wait(empty + st, ((it / kStages) & 1) ^ 1);
      unsigned char* ks = stages + st * stage_bytes;
      if (tma) {
        mbar_expect_tx(full + st, stage_bytes);
        for (int s = 0; s < ds; ++s)
          tma_load(ks + s * BN * kRowBytes, &kmap, full + st, s * kSlabCols, c0, bkv_row);
        for (int s = 0; s < VS; ++s)
          tma_load(ks + k_bytes + s * BN * kRowBytes, &vmap, full + st, vc0 + s * kSlabCols, c0,
                   bkv_row);
      } else {
        stage_plain(ks, kb, c0, BN, k_len, 0, ds, d, lane);
        stage_plain(ks + k_bytes, vb, c0, BN, k_len, vc0, VS, v_d, lane);
        fence_proxy_async();
        mbar_arrive(full + st);
      }
      ++it;
    });
    return;
  }

  // ---- the consumer warpgroups: rows row0 + 64 wg + [0, 64) ----
  const int wg = tid / 128, w = (tid / 32) & 3, lane = tid & 31;
  const int r_base = row0 + 64 * wg + 16 * w + (lane >> 2);  // and r_base + 8
  float o_acc[VN / 2];
#pragma unroll
  for (int i = 0; i < VN / 2; ++i) o_acc[i] = 0.f;
  float m_run[2] = {neg_inf(), neg_inf()}, l_part[2] = {0.f, 0.f};
  const uint64_t q_desc = make_desc(Qs + 64 * wg * kRowBytes, 16, 1024);
  mbar_wait(q_full, 0);

  // one stage; MASKED (a compile-time tag) applies the rule predicate, the
  // interior stages compile without it
  int it = 0;
  auto body = [&](int c0, auto masked_tag) {
    constexpr bool MASKED = decltype(masked_tag)::value;
    const int st = it % kStages;
    unsigned char* ks = stages + st * stage_bytes;
    mbar_wait(full + st, (it / kStages) & 1);

    // S = Q K^T (log2-domain logits: q arrives prescaled): every k-step of
    // the class, unrolled so the products pipeline (Q and K past d are zero)
    float s[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    const uint64_t k_desc = make_desc(ks, 16, 1024);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * ds; ++kk) {
      const int slab = kk >> 2, off = (kk & 3) * 32;
      mma_qk<BN, T>(s, q_desc + ((slab * kBM * kRowBytes + off) >> 4),
                    k_desc + ((slab * BN * kRowBytes + off) >> 4));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // element i of the fragment: row r_base + 8 ((i >> 1) & 1), column
    // c0 + 8 (i >> 2) + 2 (lane & 3) + (i & 1); the orders of the thread's
    // two rows and BN / 4 columns come once a stage
    if constexpr (MASKED) {
      const SeqPos rows[2] = {q_pos_of(a.rule, r_base), q_pos_of(a.rule, r_base + 8)};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const SeqPos col = k_pos_of(a.rule, c0 + 8 * j + 2 * (lane & 3) + e);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (!visible(a.rule, rows[h], col)) s[4 * j + 2 * h + e] = neg_inf();
        }
      }
    }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m_run[h] - mx[h]);
      m_run[h] = mx[h];
    }
    // masked logits hold NEG_INF: exp2(NEG_INF - m) == 0 for a live row; a
    // row with no visible key yet is repaired at the end
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int h = (i >> 1) & 1;
      s[i] = exp2f(s[i] - m_run[h]);
      rs[h] += s[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_part[h] = alpha[h] * l_part[h] + rs[h];
#pragma unroll
    for (int i = 0; i < VN / 2; ++i) o_acc[i] *= alpha[(i >> 1) & 1];
    // P as the A fragments of BN / 16 k-slices, rounded to T
    uint32_t p[BN / 4];
#pragma unroll
    for (int i = 0; i < BN / 4; ++i) p[i] = pack2<T>(s[2 * i], s[2 * i + 1]);

    // O += P V
    const uint64_t v_desc = make_desc(ks + k_bytes, BN * kRowBytes, 1024);
    fence_regs(o_acc);
    fence_regs(p);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      mma_pv<VN, T>(o_acc, p + 4 * kk, v_desc + ((kk * 16 * kRowBytes) >> 4));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o_acc);
    mbar_arrive(empty + st);
    ++it;
  };
  for_each_stage<WALK, BN>(a, qi, [&](int c0, bool masked) {
    if (masked)
      body(c0, std::true_type{});
    else
      body(c0, std::false_type{});
  });

  // the forward finalize (forward.py:225-243), as fwd_finalize
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_part[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = r_base + 8 * h;
    if (row >= q_len) continue;
    const bool dead = m_run[h] <= neg_inf();
    if (dead) l = 0.f;
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    const size_t orow = static_cast<size_t>(b) * q_len + row;
    T* o = static_cast<T*>(a.o) + orow * v_d;
#pragma unroll
    for (int j = 0; j < VN / 8; ++j) {
      const int c = vc0 + 8 * j + 2 * (lane & 3);
      const float x = dead ? 0.f : o_acc[4 * j + 2 * h] * inv;
      const float y = dead ? 0.f : o_acc[4 * j + 2 * h + 1] * inv;
      if (c < v_d) o[c] = from_f<T>(x);
      if (c + 1 < v_d) o[c + 1] = from_f<T>(y);
    }
    if (blockIdx.z == 0 && (lane & 3) == 0) {
      a.l[orow] = l;
      a.m[orow] = dead ? neg_inf() : m_run[h] * INV_LOG2E;
    }
  }
}

// The building blocks on one tile, for the card tests: one warpgroup
// stages a (64 x 64), k (64 x 64) and v (64 x 128) as the forward does and
// computes s = a k^T (the S product, N = 64) and o = T(s) v (the PV
// product, P from registers, V through the transpose bit), both float32.
template <typename T>
__global__ void __launch_bounds__(128) tile_check_kernel(const T* a, const T* k, const T* v,
                                                         float* s_out, float* o_out) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* As = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* Ks = As + 64 * kRowBytes;
  unsigned char* Vs = Ks + 64 * kRowBytes;
  const int tid = threadIdx.x, w = tid / 32, lane = tid & 31;
  stage_plain(As, a, 0, 64, 64, 0, 1, 64, tid, 128);
  stage_plain(Ks, k, 0, 64, 64, 0, 1, 64, tid, 128);
  stage_plain(Vs, v, 0, 64, 64, 0, 2, 128, tid, 128);
  fence_proxy_async();
  __syncthreads();
  float s[32], o[64];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  const uint64_t da = make_desc(As, 16, 1024), dk = make_desc(Ks, 16, 1024);
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_qk<64, T>(s, da + ((kk * 32) >> 4), dk + ((kk * 32) >> 4));
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
  uint32_t p[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) p[i] = pack2<T>(s[2 * i], s[2 * i + 1]);
  const uint64_t dv = make_desc(Vs, 64 * kRowBytes, 1024);
  fence_regs(o);
  fence_regs(p);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_pv<128, T>(o, p + 4 * kk, dv + ((kk * 16 * kRowBytes) >> 4));
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(o);
  const int r = 16 * w + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 32; ++i)
    s_out[(r + 8 * ((i >> 1) & 1)) * 64 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1)] = s[i];
#pragma unroll
  for (int i = 0; i < 64; ++i)
    o_out[(r + 8 * ((i >> 1) & 1)) * 128 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1)] = o[i];
}

template <typename T>
int tile_check(const void* a, const void* k, const void* v, float* s, float* o,
               cudaStream_t stream) {
  const int smem = 1024 + 4 * 64 * kRowBytes;
  tile_check_kernel<T><<<1, 128, smem, stream>>>(static_cast<const T*>(a),
                                                 static_cast<const T*>(k),
                                                 static_cast<const T*>(v), s, o);
  return cudaGetLastError();
}

// ---- host side ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &got);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &got);
#endif
    if (err == cudaSuccess && got == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (cols, rows, batch) map of a contiguous (batch, rows, cols) tensor of T,
// boxes of 64 columns x box_rows, 128-byte swizzle, zeros out of bounds
template <typename T>
bool tensor_map(CUtensorMap* map, const void* ptr, int cols, int rows, int batch, int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(cols) * rows * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kSlabCols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapDataType ty = std::is_same<T, bf16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                              : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  return fn(map, ty, 3, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

size_t fwd_tc_smem(int bn, int vn) {
  const int ds = slabs_of(bn);
  return 1024 + static_cast<size_t>(ds) * kBM * kRowBytes +
         static_cast<size_t>(kStages) * (ds + vn / kSlabCols) * bn * kRowBytes +
         8 * (1 + 2 * kStages);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int WALK, int BN, int VN>
int fwd_tc(const AttnArgs& a, cudaStream_t stream) {
  if (a.d < 1 || a.v_d < 1 || a.d > kSlabCols * slabs_of(BN) || a.g < 1 || a.B % a.g ||
      a.block_q % kBM || a.block_kv % BN || a.block_kv % 128 || a.rule.q_len < 1)
    return cudaErrorInvalidValue;
  const size_t smem = fwd_tc_smem(BN, VN);
  if (smem > static_cast<size_t>(MAX_SMEM)) return cudaErrorInvalidValue;
  const int B_kv = a.B / a.g, q_len = a.rule.q_len, k_len = a.rule.k_len;
  CUtensorMap qm, km, vm;
  memset(&qm, 0, sizeof(qm));
  memset(&km, 0, sizeof(km));
  memset(&vm, 0, sizeof(vm));
  const bool tma = a.d % 8 == 0 && a.v_d % 8 == 0 && aligned16(a.q) && aligned16(a.k) &&
                   aligned16(a.v) && k_len > 0;
  if (tma && !(tensor_map<T>(&qm, a.q, a.d, q_len, a.B, kBM) &&
               tensor_map<T>(&km, a.k, a.d, k_len, B_kv, BN) &&
               tensor_map<T>(&vm, a.v, a.v_d, k_len, B_kv, BN)))
    return cudaErrorInvalidValue;
  auto kernel = fwd_tc_kernel<T, WALK, BN, VN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B, blocks(q_len, kBM), blocks(a.v_d, VN));
  kernel<<<grid, kThreads, smem, stream>>>(a, qm, km, vm, tma ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace tc

// the forward of kTable and kBanded: bf16 and fp16 on the tensor-core body
// (its class by d and v_d), float32 on the scalar body
template <typename T, int WALK>
int fwd_any(const AttnArgs& a, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    return fwd_scalar_any<T, WALK>(a, s);
  } else {
    if (a.d <= 128 && a.v_d <= 128) return tc::fwd_tc<T, WALK, 128, 128>(a, s);
    if (a.d <= 256) return tc::fwd_tc<T, WALK, 64, 256>(a, s);
    return tc::fwd_tc<T, WALK, 32, 256>(a, s);
  }
}

}  // namespace
