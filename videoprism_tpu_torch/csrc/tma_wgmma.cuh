// The Hopper machinery the two GEMMs share (gemm_bf16.cu, int8_blocks.cu):
// mbarriers, TMA tile loads through tensor maps, wgmma shared-memory
// descriptors and fences, and the named barriers of the ping-pong
// consumer warpgroups.  The tensor maps are encoded on the host through
// cuTensorMapEncodeTiled, reached with cudaGetDriverEntryPoint (no link
// against libcuda).
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace vp {
namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Spins until the barrier's phase of this parity completes; traps (a
// launch error, not a hung card) if that takes more than ~10 s.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    if (clock64() - start > 20000000000LL) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}
// One [box] tile of a 2-D tensor map at (inner, outer) into shared memory,
// completing its bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(inner), "r"(outer)
      : "memory");
}

// The same from a 3-D tensor map at (inner, mid, outer).
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map, uint64_t* bar,
                                          int inner, int mid, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(inner), "r"(mid), "r"(outer)
      : "memory");
}
// Makes this thread's shared-memory stores visible to the async proxy
// (wgmma's and TMA's reads), before a barrier that orders them.
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Named barrier `id` over the two consumer warpgroups (256 threads): sync
// waits for the other warpgroup's arrival, arrive does not wait.
__device__ __forceinline__ void consumer_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void consumer_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A 2-D [outer, inner] matrix of `type` with a row pitch of `pitch_bytes`,
// read in boxes of [box_outer, box_inner] with 128-byte swizzle (a box row
// is 128 bytes); out-of-bounds reads are zeros.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, int inner,
                int outer, long pitch_bytes, int box_inner, int box_outer) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 3-D [outer, mid, inner] tensor with byte strides mid_stride and
// outer_stride, read in boxes of [box_outer, 1, box_inner] with 128-byte
// swizzle (the box lands in shared memory as a 2-D [box_outer, box_inner]
// box does); out-of-bounds reads are zeros, so a box that runs past `inner`
// reads zeros there even where the next `mid` slice follows in memory.
bool tensor_map3(CUtensorMap* map, CUtensorMapDataType type, const void* base, int inner,
                 int mid, int outer, long mid_stride, long outer_stride, int box_inner,
                 int box_outer) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(mid),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(mid_stride),
                                 static_cast<cuuint64_t>(outer_stride)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_inner), 1,
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
}  // namespace vp
