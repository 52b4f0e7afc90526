// Hopper (sm_90a) building blocks shared by the kernels of this directory:
// mbarriers, 2D TMA loads and the tensor maps they read, 1D bulk copies,
// wgmma's fences and
// its descriptor of a 128-byte-swizzled K-major tile, and the exact int8 ->
// bf16 widening of two codes at a time.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SMEM_MAX = 232448;  // a block's limit on sm_90

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// 2D TMA load of the box at (x, y) (x innermost) into shared memory;
// completion is counted in bytes on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

// an L2 policy for bytes that are read once: they are the first to leave
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// 1D bulk copy of `bytes` contiguous bytes from global to shared memory,
// no tensor map: both addresses and the size are multiples of 16; completion
// is counted in bytes on `bar`; `policy` is the L2 policy of the bytes read
__device__ __forceinline__ void bulk_load_1d(void* dst, const void* src,
                                             uint32_t bytes, uint64_t* bar,
                                             uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

// wgmma descriptor of a K-major tile (bf16 or int8) written by TMA with the
// 128-byte swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO);
// the k-step j (16 bf16 or 32 int8 values) starts 32 * j bytes into the row
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// all but the newest committed group are complete
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

__device__ __forceinline__ uint32_t lds_u32(uint32_t saddr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(saddr));
  return v;
}

// two signed codes (bytes s and s + 1 of w, `sel` = 0x4140 | s | (s + 1) << 8)
// -> a bf16x2, exactly. 0x4300 | (byte & 0x7f) is 128 + the low seven bits;
// adding -128 (byte >= 0) or -256 (byte < 0) in bf16 gives the code, which
// has at most 8 significant bits
__device__ __forceinline__ uint32_t widen2(uint32_t w, uint32_t sel) {
  uint32_t t, out;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(t) : "r"(w), "r"(0u), "r"(sel));
  const uint32_t hi = (t & 0x007f007fu) | 0x43004300u;
  const uint32_t lo = (t & 0x00800080u) ^ 0xC300C300u;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(out) : "r"(hi), "r"(lo));
  return out;
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, reached through the runtime so
// that the library links against no libcuda
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a 2D row-major [rows, cols] map with boxes of [box_rows, box_cols]; reads
// past either end are filled with zeros
inline bool make_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                     const void* base, uint64_t rows, uint64_t cols,
                     uint32_t box_rows, uint32_t box_cols,
                     CUtensorMapSwizzle swz) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
