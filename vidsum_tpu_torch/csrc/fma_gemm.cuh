// fma_gemm: the exact-f32 GEMM mainloop on the FMA units (no TF32) that the
// training block's products (block_train.cu's bt_gemm_kernel, TPU kernels
// 9-12) and the serving block's f32 products (gemm_bias_epilogue.cu's
// gemm_f32_kernel, TPU kernels 1/2 in f32) share, for sm_90a.
//
// C[m, n] = sum_k A[m*sam + k*sak] * B[k*sbk + n*sbn] over a BM x BN CTA tile
// of 256 threads, R x R outputs a thread: R = 8 on 128 x 128 tiles, or R = 4 on
// 64 x 64 tiles, four times as many CTAs for grids that the large tiles leave
// short of the SMs. Thread (ty, tx) = (tid / (BN / R), tid % (BN / R)) holds
// rows {4 ty + i + q BM / (R / 4)} and columns {4 tx + j + q BN / (R / 4)} (i,
// j < 4, q < R / 4): each k step's R + R operands read as R / 2 float4 from
// k-major shared tiles (at R = 8, 16 FMAs a 16-byte read; a warp's reads hit
// distinct banks or broadcast). The k tiles, 16 deep, are double buffered: the
// next tile's loads are in flight during the current tile's FMAs, with one
// __syncthreads a tile. Each output is one thread's f32 FMAs in increasing k,
// whatever the tile shape, the grid or the load mode, so a row's result depends
// on its own operands only.
//
// How an operand's GBK x ROWS tile reaches its k-major tile S[k][r] (r the
// m index of A, the n index of B), by the operand's layout:
//   kVecR  rows contiguous (unit stride along r, the other stride a multiple
//          of 4, a 16-byte base): 16-byte cp.async, the ragged edge
//          zero-filled by the copy's source size
//   kVecK  k contiguous (likewise along k): 16-byte loads into registers,
//          stored transposed once the current tile's products are issued
//   kAny   any strides or alignment: scalar loads into registers
#pragma once

#include "common.cuh"

namespace vs {
namespace fma_gemm {

constexpr int kThreads = 256;
// 16-deep k tiles: half the barriers of 8 deep, still 128 registers a
// thread with no spill
constexpr int GBK = 16, GPAD = 4;
static_assert(GBK % 8 == 0, "whole 16-byte chunks per thread");

enum Load : int { kVecR = 0, kVecK = 1, kAny = 2 };

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}

// The load mode of an operand with strides sr (along its m / n rows) and
// sk (along k): 16-byte loads need the contiguous dimension's unit stride,
// the other stride a multiple of 4 and a 16-byte aligned base.
inline int load_mode(const float* p, long long sr, long long sk) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return kAny;
  if (sr == 1 && sk % 4 == 0) return kVecR;
  if (sk == 1 && sr % 4 == 0) return kVecK;
  return kAny;
}

// One operand X[r * sr + k * sk] over rows [r0, r0 + ROWS) of `rows`; the
// registers hold the next tile between issue() and store().
template <int MODE, int ROWS>
struct Operand {
  static_assert(ROWS == 64 || ROWS == 128 || ROWS == 256, "a power of two");
  static constexpr int LD = ROWS + GPAD;  // a padded k row, 16-byte aligned
  static constexpr int kq = GBK / 4;      // 16-byte chunks along k (kVecK)
  // log2 of ROWS and of its 16-byte chunks: index arithmetic by shifts
  static constexpr int kLog = ROWS == 64 ? 6 : ROWS == 128 ? 7 : 8;
  static constexpr int kChunks = ROWS * GBK / 4 / kThreads;  // per thread
  static constexpr int kElems = ROWS * GBK / kThreads;       // per thread
  static_assert(kChunks >= 1, "every thread moves a whole chunk");
  const float* __restrict__ p;
  long long sr, sk;
  int rows, r0;
  float v[kElems];

  __device__ __forceinline__ void issue(float (*S)[LD], int k0, int ke) {
    const int tid = threadIdx.x;
    if (MODE == kVecR || MODE == kVecK) {
#pragma unroll
      for (int q = 0; q < kChunks; ++q) {
        const int f = tid + kThreads * q;
        if (MODE == kVecR) {
          const int k = f >> (kLog - 2), r = (f & (ROWS / 4 - 1)) * 4;
          const int gr = r0 + r, gk = k0 + k;
          const int n = gk < ke ? max(0, min(4, rows - gr)) : 0;
          cp_async16(&S[k][r], n > 0 ? p + gr + (long long)gk * sk : p,
                     4 * n);
        } else {
          const int r = f / kq, k = (f % kq) * 4;
          const int gr = r0 + r, gk = k0 + k;
          const float* src = p + (long long)gr * sr + gk;
          if (gr < rows && gk + 4 <= ke) {
            const float4 t = __ldg(reinterpret_cast<const float4*>(src));
            v[4 * q] = t.x;
            v[4 * q + 1] = t.y;
            v[4 * q + 2] = t.z;
            v[4 * q + 3] = t.w;
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              v[4 * q + c] = gr < rows && gk + c < ke ? src[c] : 0.f;
          }
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kElems; ++i) {
        const int f = tid + kThreads * i;
        const int gr = r0 + (f & (ROWS - 1)), gk = k0 + (f >> kLog);
        v[i] = gr < rows && gk < ke ? p[gr * sr + gk * sk] : 0.f;
      }
    }
  }

  __device__ __forceinline__ void store(float (*S)[LD]) {
    const int tid = threadIdx.x;
    if (MODE == kVecK) {
      // (a warp's 8 rows x 4 k groups, at most 2 to a bank)
#pragma unroll
      for (int q = 0; q < kChunks; ++q) {
        const int f = tid + kThreads * q;
#pragma unroll
        for (int c = 0; c < 4; ++c) S[(f % kq) * 4 + c][f / kq] = v[4 * q + c];
      }
    } else if (MODE == kAny) {
#pragma unroll
      for (int i = 0; i < kElems; ++i) {
        const int f = tid + kThreads * i;
        S[f >> kLog][f & (ROWS - 1)] = v[i];
      }
    }
  }
};

// acc[i][j] = sum over k in [kb, ke), in increasing order, of A[row(i)][k]
// B[k][col(j)], row(i) = m0 + (i / 4) (BM / (R / 4)) + 4 ty + i % 4 and
// col(j) = n0 + (j / 4) (BN / (R / 4)) + 4 tx + j % 4 (the thread mapping
// above); As and Bs are the kernel's double-buffered shared tiles,
// __shared__ __align__(16) float As[2][GBK][BM + GPAD], Bs[2][GBK][BN +
// GPAD].
template <int BM, int BN, int R, int AMODE, int BMODE>
__device__ __forceinline__ void mainloop(float (&acc)[R][R],
                                         float (*As)[GBK][BM + GPAD],
                                         float (*Bs)[GBK][BN + GPAD],
                                         const float* A, long long sam,
                                         long long sak, int M, int m0,
                                         const float* B, long long sbn,
                                         long long sbk, int N, int n0,
                                         int kb, int ke) {
  static_assert((R == 4 || R == 8) && BM * BN == R * R * kThreads &&
                    BN / R == 16,
                "R x R outputs a thread, 16 threads across a tile");
  constexpr int RB = R / 4;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int tiles = (ke - kb + GBK - 1) / GBK;
  Operand<AMODE, BM> a{A, sam, sak, M, m0};
  Operand<BMODE, BN> b{B, sbn, sbk, N, n0};
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.f;

  a.issue(As[0], kb, ke);
  b.issue(Bs[0], kb, ke);
  asm volatile("cp.async.commit_group;" ::: "memory");
  a.store(As[0]);
  b.store(Bs[0]);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  for (int t = 0; t < tiles; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < tiles;
    if (more) {
      a.issue(As[cur ^ 1], kb + (t + 1) * GBK, ke);
      b.issue(Bs[cur ^ 1], kb + (t + 1) * GBK, ke);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < GBK; ++kk) {
      // A's float4 first, then B's (the order bt_gemm measured fastest in)
      float4 a4[RB], b4[RB];
#pragma unroll
      for (int q = 0; q < RB; ++q)
        a4[q] = *reinterpret_cast<const float4*>(
            &As[cur][kk][q * (BM / RB) + 4 * ty]);
#pragma unroll
      for (int q = 0; q < RB; ++q)
        b4[q] = *reinterpret_cast<const float4*>(
            &Bs[cur][kk][q * (BN / RB) + 4 * tx]);
      float av[R], bv[R];
#pragma unroll
      for (int q = 0; q < RB; ++q) {
        av[4 * q] = a4[q].x, av[4 * q + 1] = a4[q].y;
        av[4 * q + 2] = a4[q].z, av[4 * q + 3] = a4[q].w;
        bv[4 * q] = b4[q].x, bv[4 * q + 1] = b4[q].y;
        bv[4 * q + 2] = b4[q].z, bv[4 * q + 3] = b4[q].w;
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {
      a.store(As[cur ^ 1]);
      b.store(Bs[cur ^ 1]);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
  }
}

}  // namespace fma_gemm
}  // namespace vs
