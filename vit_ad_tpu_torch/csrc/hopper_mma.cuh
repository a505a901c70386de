// Hopper (sm_90a) building blocks of the port's warpgroup GEMM kernels: the
// PTX of mbarriers, the Tensor Memory Accelerator (TMA), warpgroup matrix
// multiply (wgmma) and register rebalancing, each behind one device function.
// Included by mlp_block.cu.
//
// Shared-memory operands of wgmma are K-major tiles of 64 bf16 (128 bytes) per
// row in the 128-byte-swizzled layout that a TMA load with
// CU_TENSOR_MAP_SWIZZLE_128B writes: row r starts at byte 128 r of a tile
// aligned to 1024 bytes, and the 16-byte chunk c of a row is stored at chunk
// c ^ (r % 8). `operand_descriptor` describes such a tile to wgmma; a step of
// 16 along the contraction advances the descriptor's address by 32 bytes.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vitad_hopper {

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ----------------------------------------------------------------

__device__ __forceinline__ void barrier_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals) : "memory");
}

// makes the initialised barriers visible to the TMA unit
__device__ __forceinline__ void barrier_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void barrier_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one arrival that also announces `bytes` of TMA traffic to wait for
__device__ __forceinline__ void barrier_arrive_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase of parity `parity` has completed. A fresh
// barrier passes parity 1 at once and blocks on parity 0 until its first
// completion. A wait that outlasts 2^24 polls (seconds; a healthy one takes
// microseconds) is a lost arrival or a failed copy: trap, so that the launch
// ends in an error and not in a hang.
__device__ __forceinline__ void barrier_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t polls = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done == 0 && ++polls == (1u << 24)) __trap();
  } while (done == 0);
}

// ---- TMA ---------------------------------------------------------------------

// Copy the box of `map` whose first element is (col, row) into shared memory
// at `dst`; the bytes are counted on `bar`. Elements outside the tensor arrive
// as zeros. One thread executes it.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// Copy a box from shared memory at `src` to the tensor of `map` at (col, row);
// elements outside the tensor are not written. One thread executes it, after
// `async_proxy_fence` and a barrier have ordered the writers of `src` before
// it; the thread then commits its copies and may wait for them.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int col,
                                             int row) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(col), "r"(row)
               : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until every committed store of this thread has read its shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// orders this thread's earlier writes to shared memory before later reads of
// them by the TMA unit (the async proxy)
__device__ __forceinline__ void async_proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier of the 128 threads of warpgroup `w` (named barrier w + 1; 0 is
// __syncthreads's)
__device__ __forceinline__ void warpgroup_sync(int w) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(w + 1) : "memory");
}

// ---- register rebalancing between warpgroups -----------------------------------

template <int kRegs>
__device__ __forceinline__ void registers_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void registers_acquire() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// ---- wgmma -------------------------------------------------------------------

// Descriptor of a K-major, 128-byte-swizzled bf16 tile at shared address
// `tile` (1024-byte aligned, plus 32 bytes per step of 16 along K): address
// and offsets in units of 16 bytes; leading offset unused by this layout (1),
// stride between groups of 8 rows 1024 bytes, layout type 1 = 128-byte swizzle.
__device__ __forceinline__ uint64_t operand_descriptor(uint32_t tile) {
  return static_cast<uint64_t>((tile & 0x3FFFFu) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most kPending committed groups are still running
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// keeps the compiler from moving uses of an accumulator across a wgmma wait
template <int N>
__device__ __forceinline__ void accumulator_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A . B^T for one 64 x 192 x 16 step: A [64, 16] and B [192, 16] from
// shared memory through their descriptors, bf16 in, f32 accumulate; scale_d = 0
// overwrites d instead of adding to it. Thread (warp w of the warpgroup, lane
// 4 g + t) holds, for j < 24: d[4 j + 0..1] = row 16 w + g, columns
// 8 j + 2 t + {0, 1}; d[4 j + 2..3] = row 16 w + g + 8, the same columns.
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96], uint64_t desc_a, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 0;\n"
      "}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

}  // namespace vitad_hopper
