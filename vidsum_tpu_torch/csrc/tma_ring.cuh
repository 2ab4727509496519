// The pieces of a TMA-filled shared-memory ring feeding Hopper's warpgroup
// products, shared by the serving GEMMs: gemm_bias_epilogue.cu's bf16
// kernel and int8_gemm.cu's int8 kernel.
//
// Device side: mbarriers (init, arrive, arrive with a transaction count, a
// parity wait that traps instead of hanging), one TMA box load into shared
// memory completing on a barrier, the wgmma shared-memory descriptor of a
// K-major tile in the 128-byte swizzle, and wgmma's fence / commit / wait.
// Host side: 2-D tensor maps in the 128-byte swizzle (one box row = one
// 128-byte swizzle row: 64 bf16 or 128 int8 values), encoded by
// cuTensorMapEncodeTiled fetched through the CUDA runtime (no -lcuda) and
// cached process-wide.
#pragma once

#include <cuda.h>  // CUtensorMap and its encoder's types only: nothing links libcuda
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace vs {
namespace tma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Waits for the completion of the barrier's phase of the given parity. A
// phase that never completes (a load that never lands) traps after 2^28
// polls (seconds), so that the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

// One box of a 2-D tensor map (coordinates: column c0, row c1) into shared
// memory; its bytes complete on the barrier's transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// start address >> 4, leading byte offset unused (1), stride byte offset
// 1024 >> 4 between 8-row groups, layout type 1 (SWIZZLE_128B). The k slice
// of one product (32 bytes: 16 bf16 or 32 int8) starts at +32 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)64 << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------------- host: tensor maps
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a (rows, cols) matrix of `type` (elements of `elem` bytes)
// with row stride ld (elements), in boxes of box_rows rows x one 128-byte
// swizzle row (128 / elem columns); out-of-range elements load as 0.
// Encoded into `out` (64-byte aligned, as the encoder requires) and cached
// process-wide by (pointer, type, shape, stride, box) in statically aligned
// storage under a mutex: serving threads launch too, and thread-local
// storage of a dlopen'ed library need not keep a map's 64-byte alignment.
struct MapEntry {
  CUtensorMap map;
  const void* p;
  int type, rows, cols, ld, box_rows;
};
constexpr int kMapCache = 16;
alignas(64) inline MapEntry g_maps[kMapCache];
inline int g_next_map = 0;
inline std::mutex g_maps_mu;

inline bool tensor_map(CUtensorMap* out, CUtensorMapDataType type, int elem,
                       const void* p, int rows, int cols, int ld,
                       int box_rows) {
  if (reinterpret_cast<uintptr_t>(out) % 64) return false;
  std::lock_guard<std::mutex> lock(g_maps_mu);
  for (const MapEntry& e : g_maps)
    if (e.p == p && e.type == (int)type && e.rows == rows && e.cols == cols &&
        e.ld == ld && e.box_rows == box_rows) {
      *out = e.map;
      return true;
    }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * elem};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem), (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  if (encode(out, type, 2, const_cast<void*>(p), dims, strides, box,
             elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  MapEntry& e = g_maps[g_next_map];
  g_next_map = (g_next_map + 1) % kMapCache;
  e.map = *out;
  e.p = p;
  e.type = (int)type;
  e.rows = rows;
  e.cols = cols;
  e.ld = ld;
  e.box_rows = box_rows;
  return true;
}

}  // namespace tma
}  // namespace vs
