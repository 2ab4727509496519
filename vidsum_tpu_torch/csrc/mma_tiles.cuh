// mma_tiles: what the tensor-core attention kernels share for streaming
// 64-row tiles through shared memory on sm_90a: 16-byte cp.async copies and
// their groups, the staging loop of a tile of rows, the scan of a key
// padding mask for the 64-key tiles that hold an unpadded key, 2^x on the
// MUFU unit, and the mma.sync m16n8k16 fragment loads and products of
// padded row-major tiles (FlashAttention-2's register layout). Included by
// attention_train_mma.cuh (the bf16 training attention) and
// masked_attention.cu (the bf16 serving attention).
#pragma once

#include "common.cuh"

namespace vs {

constexpr int kKeyTile = 64;  // rows of a streamed tile
constexpr int kLdsPad = 8;    // bf16 of padding per shared-memory row
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// 4 bytes at a 4-byte aligned address (through L1)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 2^x on the MUFU unit (-inf -> 0, NaN stays NaN)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

__device__ __forceinline__ bool has_zero_byte(unsigned w) {
  return ((w - 0x01010101u) & ~w & 0x80808080u) != 0u;
}

// true when one of the 16 mask bytes at p (16-byte aligned) is 0: a key
// that is not padded
__device__ __forceinline__ bool any_live16(const unsigned char* p) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  return has_zero_byte(w.x) || has_zero_byte(w.y) || has_zero_byte(w.z) ||
         has_zero_byte(w.w);
}

// Rows r0 .. r0 + rows - 1 of a head's (N, DH) matrix of E (bf16, or int8
// codes) at row stride sn into dst, each row padded by 16 bytes (DH + 16 /
// sizeof(E) elements), from THREADS threads; rows at or past N are zeros.
// With vec (16-byte aligned rows) by 16-byte cp.async copies, not
// committed; without, by plain loads through registers (any row stride).
template <int DH, int THREADS, typename E = __nv_bfloat16>
__device__ __forceinline__ void stage_rows(E* dst, const E* head,
                                           long long sn, int r0, int rows,
                                           int N, bool vec = true) {
  constexpr int kPer = 16 / sizeof(E);  // elements per 16-byte chunk
  constexpr int kChunks = DH / kPer;    // chunks per row (DH >= kPer)
  for (int c = threadIdx.x; c < rows * kChunks; c += THREADS) {
    const int r = c / kChunks, cc = (c % kChunks) * kPer;
    E* d = dst + r * (DH + kPer) + cc;
    const E* s = head + (long long)(r0 + r) * sn + cc;
    if (r0 + r >= N) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else if (vec) {
      cp_async16(d, s);
    } else {
      uint4 raw;
      E* vals = reinterpret_cast<E*>(&raw);
#pragma unroll
      for (int j = 0; j < kPer; ++j) vals[j] = s[j];
      *reinterpret_cast<uint4*>(d) = raw;
    }
  }
}

// Warp 0 writes the 64-key tiles of mask row mrow (N keys) that hold an
// unpadded key, in order, to tiles[] and their count to *count; a row with
// no unpadded key keeps every tile if all_if_none, else none. vec says the
// row starts on a 16-byte boundary (its whole tiles are read as 16-byte
// words; a ragged last tile, or every tile without vec, byte by byte). The
// caller synchronises before reading them.
__device__ __forceinline__ void live_tiles(const unsigned char* mrow, int N,
                                           int* tiles, int* count,
                                           bool all_if_none,
                                           bool vec = true) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int ntiles = (N + kKeyTile - 1) / kKeyTile;
  int n = 0;
  for (int c0 = 0; c0 < ntiles; c0 += 32) {
    const int tile = c0 + lane;
    const int k0 = tile * kKeyTile;
    bool live = false;
    if (tile < ntiles) {
      if (vec && k0 + kKeyTile <= N) {
#pragma unroll
        for (int i = 0; i < kKeyTile / 16; ++i)
          live |= any_live16(mrow + k0 + 16 * i);
      } else {
        const int k1 = min(k0 + kKeyTile, N);
        for (int key = k0; key < k1; ++key) live |= mrow[key] == 0;
      }
    }
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    if (live) tiles[n + __popc(bal & ((1u << lane) - 1u))] = tile;
    n += __popc(bal);
  }
  if (n == 0 && all_if_none) {
    for (int t = lane; t < ntiles; t += 32) tiles[t] = t;
    n = ntiles;
  }
  if (lane == 0) *count = n;
}

// The A fragment (16 x 16, rows r and r + 8 of a padded row-major tile) of
// the k16 step ks
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int r,
                                       int ks, int t) {
  a[0] = ld_pair(tile + r * LD + ks * 16 + 2 * t);
  a[1] = ld_pair(tile + (r + 8) * LD + ks * 16 + 2 * t);
  a[2] = ld_pair(tile + r * LD + ks * 16 + 8 + 2 * t);
  a[3] = ld_pair(tile + (r + 8) * LD + ks * 16 + 8 + 2 * t);
}

// acc[ni] += A . X^T over the k16 steps, X the rows ni*8 + g of a padded
// row-major tile: the B fragment of an n8 tile is one row's pairs
__device__ __forceinline__ void mma_rows(float (&acc)[4],
                                         const uint32_t (&a)[4],
                                         const __nv_bfloat16* xrow, int ks,
                                         int t) {
  mma_bf16_16816(acc, a[0], a[1], a[2], a[3],
                 ld_pair(xrow + ks * 16 + 2 * t),
                 ld_pair(xrow + ks * 16 + 8 + 2 * t));
}

// acc[nd] += A . Y for a 16-row k chunk of a padded row-major tile Y (rows
// k, columns n): the transposing ldmatrix gives each n8 tile's B fragment
template <int DH>
__device__ __forceinline__ void mma_cols(float (&acc)[DH / 8][4],
                                         const uint32_t (&a)[4],
                                         const __nv_bfloat16* ychunk,
                                         int lane) {
  const __nv_bfloat16* row = ychunk + (lane & 15) * (DH + kLdsPad);
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd) {
    uint32_t b0, b1;
    ldmatrix_x2_trans(b0, b1, row + nd * 8);
    mma_bf16_16816(acc[nd], a[0], a[1], a[2], a[3], b0, b1);
  }
}

// A fragment of the 16-column chunk kc from accumulator-layout values
// v[ni][e] (row g + 8 (e >> 1), column ni*8 + 2t + (e & 1)), rounded to bf16
template <int NI>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4],
                                       const float (&v)[NI][4], int kc) {
  a[0] = pack_bf16(v[2 * kc][0], v[2 * kc][1]);
  a[1] = pack_bf16(v[2 * kc][2], v[2 * kc][3]);
  a[2] = pack_bf16(v[2 * kc + 1][0], v[2 * kc + 1][1]);
  a[3] = pack_bf16(v[2 * kc + 1][2], v[2 * kc + 1][3]);
}

}  // namespace vs
