// gemm_bias_epilogue: Y = X . W^T + b with f32 accumulation and a fused
// epilogue, for sm_90a.
//
// Replaces (with masked_attention.cu) the row-wise products of the TPU
// kernels vidsum_tpu/ops/block_kernel.py::_block_kernel and
// ::_block_kernel_grouped. The TPU kernel keeps x, K, V and every weight of
// a block in VMEM for one program; one block's weights alone are ~1.6 MB in
// bf16 at d=256, far past an SM's 227 KB of shared memory, so the block is
// split into a chain of kernels and each product gets its epilogue here:
//   EPI_NONE    y = acc + b                      (QKV as one d->3d product)
//   EPI_RELU    y = max(acc + b, 0)               (fc1)
//   EPI_RES_LN  y = LN(acc + b + residual)        (proj + LN1, fc2 + LN2)
// The LayerNorm runs in f32 with eps and biased variance, as
// block_kernel.py::_layernorm_f32 does. In bf16 a row of d <= 256 lies in
// one CTA tile, so its statistics never leave the CTA; a wider row (d 384
// and up), and in f32 every row, is written pre-LN in f32 by the GEMM
// (EPI_RES, y = acc + b + residual, into out_f) and normalised in place by
// common.cuh's layernorm_rows_kernel (past d 1,024 its looping
// layernorm_rows_wide_kernel), the same f32 math in a second launch.
//
// Layouts: X (M, K) with row stride ldx and W (N, K) with row stride ldw
// (nn.Linear's weight layout), both K-contiguous, in T; bias, LN scale/shift
// and an f32 residual in f32; a T residual in T; residual and outputs (M, N)
// contiguous. Outputs: out_t in T and/or out_f in f32, either may be null.
// Every output element is summed in a fixed k order, the same in every tile
// shape, so a row's result does not depend on M, on the CTA shape or on the
// other rows (served scores equal solo scores bit for bit).
//
// Bound on the card: at the flagship block (B=32, N=512, d=256) the four
// products are 24*d^2*B*N = 25.8 GFLOP against ~18 MB of operands, far above
// the H100's ~295 FLOP/byte ridge, so the bound is operations: ~26 us at the
// bf16 tensor-core peak. Design against it (bf16, gemm_bf16_wgmma_kernel):
// Hopper's warpgroup products (wgmma.mma_async m64nNk16, N = 128 or 256, f32
// accumulate) read both operands from a 4-stage ring of 64-deep shared-memory
// tiles in the 128-byte swizzle; one thread of a producer warpgroup fills
// the ring by TMA (cp.async.bulk.tensor, completion on an mbarrier per stage)
// while one or two consumer warpgroups run the products, each releasing a
// stage through a second mbarrier once its products are done; the producer
// warpgroup hands its registers to the consumers (setmaxnreg). TMA rather than cp.async: one
// thread moves a whole 16-32 KB tile with no address arithmetic, and the
// tensor maps are encoded on the host (cuTensorMapEncodeTiled, fetched
// through cudaGetDriverEntryPoint so the library needs no -lcuda) and cached
// by pointer and shape, so a call costs no more host time than a launch. A
// CTA is 128 x BN (two consumer warpgroups of 64 rows) or, where that grid
// leaves SMs idle, 64 x BN (one): ops/block_kernel.gemm_cta_rows picks it,
// and each warpgroup's 64 rows run the same products either way. The
// epilogue passes the tile through shared memory so that bias, residual,
// LayerNorm and stores run along whole rows (coalesced; a row of up to 256
// columns reduces within one warp).
// The fallback, gemm_bf16_mma_kernel (mma.sync m16n8k16, a 32-deep shared
// tile, the next tile prefetched into registers), takes what TMA cannot:
// K or a row stride not a multiple of 8 elements, or X / W not on a 16-byte
// boundary; ops/block_kernel.gemm_takes_wgmma is the predicate and
// gemm_bias_epilogue.fallback_launches counts those calls. f32 stays exact
// (no TF32) on the FMA units (67 TFLOP/s peak; 25.8 GFLOP take 0.39 ms):
// gemm_f32_kernel, the training GEMM's double-buffered mainloop
// (fma_gemm.cuh) under the serving epilogues, with no split-k, so that
// every output is one thread's FMAs in increasing k at every M; a
// LayerNorm row of any d goes through the row kernel.
#include "common.cuh"
#include "fma_gemm.cuh"
#include "tma_ring.cuh"

namespace {

using namespace vs::tma;

constexpr int kThreads = 256;  // 8 warps

enum Epilogue : int { EPI_NONE = 0, EPI_RELU = 1, EPI_RES_LN = 2,
                      EPI_RES = 3 /* internal: the pre-LN row */ };

// ---------------------------------------------------------------------------
// f32 on the FMA units, exact (no TF32): fma_gemm.cuh's mainloop, which the
// training block's bt_gemm shares, over X (M, K) and W (N, K), both
// K-contiguous: 16-byte loads into registers, stored k-major and transposed
// under the current tile's FMAs (MODE kVecK), or scalar loads through the
// same pipeline for operands off 16 bytes (kAny: K or a row stride not a
// multiple of 4, or a misaligned base; ops/block_kernel.gemm_takes_vec4 is
// the predicate and gemm_bias_epilogue.fallback_launches counts those
// calls). 128 x 128 CTAs of 8 x 8 outputs a thread (R 8), or, where that
// grid leaves SMs idle, 64 x 64 CTAs of 4 x 4 (R 4; ops/block_kernel.
// gemm_f32_tile picks it from the grid): every output is the same FMAs in
// the same k order either way, so a row's bits do not depend on M. The
// epilogue runs on the accumulators: bias, ReLU, or the residual of the
// pre-LN row (a LayerNorm row always goes through out_f and common.cuh's
// row kernel, whose arithmetic is the same at every M; it measured faster
// than a 64 x 256 tile holding the row, at (32, 512) and (8, 256)), four
// contiguous columns a store. Launch bounds ask for two CTAs an SM (128
// registers a thread), one for the scalar loads' address arithmetic.
namespace fg = vs::fma_gemm;

template <int BM, int R, int MODE, int EPI>
__global__ void __launch_bounds__(kThreads, MODE == fg::kAny ? 1 : 2)
gemm_f32_kernel(const float* __restrict__ X, const float* __restrict__ W,
                const float* __restrict__ bias,
                const float* __restrict__ resid, float* __restrict__ out_t,
                float* __restrict__ out_f, int M, int N, int K, int ldx,
                int ldw) {
  constexpr int BN = R * R * kThreads / BM, RB = R / 4;
  static_assert(EPI != EPI_RES_LN, "LayerNorm rows take the row kernel");
  __shared__ __align__(16) float As[2][fg::GBK][BM + fg::GPAD];
  __shared__ __align__(16) float Bs[2][fg::GBK][BN + fg::GPAD];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;  // BN / R 16
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[R][R];
  fg::mainloop<BM, BN, R, MODE, MODE>(acc, As, Bs, X, ldx, 1, M, m0, W, ldw,
                                      1, N, n0, 0, K);

  const bool vec4 = (N & 3) == 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int m = m0 + (i >> 2) * (BM / RB) + 4 * ty + (i & 3);
    if (m >= M) continue;
#pragma unroll
    for (int jq = 0; jq < RB; ++jq) {
      const int nq = n0 + jq * (BN / RB) + 4 * tx;
      if (nq >= N) continue;
      const size_t o = (size_t)m * N + nq;
      float y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = nq + j;
        y[j] = acc[i][4 * jq + j];
        if (n < N) {
          y[j] += bias[n];
          if (EPI == EPI_RELU) y[j] = fmaxf(y[j], 0.f);
          if (EPI == EPI_RES) y[j] += resid[o + j];
        }
      }
      if (vec4 && nq + 4 <= N) {
        const float4 w4 = make_float4(y[0], y[1], y[2], y[3]);
        if (out_t != nullptr) *reinterpret_cast<float4*>(out_t + o) = w4;
        if (out_f != nullptr) *reinterpret_cast<float4*>(out_f + o) = w4;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (nq + j >= N) continue;
          if (out_t != nullptr) out_t[o + j] = y[j];
          if (out_f != nullptr) out_f[o + j] = y[j];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 fallback on mma.sync, for operands TMA cannot take. A CTA of 8 warps
// (WARPS_M x WARPS_N) computes a (32*WARPS_M) x (64*WARPS_N) tile; each warp
// a 32 x 64 block as 2 x 8 m16n8k16 products per 16-deep k step. X and W
// tiles are staged in shared memory 32 deep, K contiguous, rows padded by 8
// bf16 (20 words), so every fragment load of a warp hits 32 distinct banks;
// the next tile's global loads are issued into registers before the current
// tile's products. The LayerNorm's row sums add within a thread, across the
// four lanes of a row (shuffles), then across the WARPS_N warps of the row
// (shared memory), in a fixed order, so a row's result does not depend on M.
constexpr int kMmaBK = 32;
constexpr int kMmaLds = kMmaBK + 8;
constexpr int WARPS_M = 2, WARPS_N = 4;  // a 64 x 256 CTA tile

template <int EPI>
__global__ void __launch_bounds__(kThreads)
gemm_bf16_mma_kernel(const __nv_bfloat16* __restrict__ X,
                     const __nv_bfloat16* __restrict__ W,
                     const float* __restrict__ bias,
                     const __nv_bfloat16* __restrict__ resid_t,
                     const float* __restrict__ resid_f,
                     const float* __restrict__ ln_g,
                     const float* __restrict__ ln_b,
                     __nv_bfloat16* __restrict__ out_t,
                     float* __restrict__ out_f, int M, int N, int K, int ldx,
                     int ldw, float eps, bool vec) {
  static_assert(WARPS_M * WARPS_N == 8, "8 warps");
  constexpr int BM = 32 * WARPS_M;
  constexpr int BN = 64 * WARPS_N;
  __shared__ __align__(16) __nv_bfloat16 Xs[BM][kMmaLds];
  __shared__ __align__(16) __nv_bfloat16 Ws[BN][kMmaLds];
  __shared__ float red[2][WARPS_N][BM];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // a 32-deep tile is (BM + BN) rows of four 16-byte chunks
  constexpr int kChunks = (BM + BN) * 4;
  constexpr int kPerThread = (kChunks + kThreads - 1) / kThreads;
  uint4 staged[kPerThread];
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = threadIdx.x + i * kThreads;
      if (c >= kChunks) continue;
      const bool is_x = c < BM * 4;
      const int r = (is_x ? c : c - BM * 4) >> 2;
      const int kc = (c & 3) * 8;
      const int grow = (is_x ? m0 : n0) + r;
      const int rows = is_x ? M : N;
      const __nv_bfloat16* src =
          (is_x ? X : W) + (size_t)grow * (is_x ? ldx : ldw) + k0 + kc;
      if (vec && grow < rows && k0 + kc + 8 <= K) {
        staged[i] = *reinterpret_cast<const uint4*>(src);
      } else {
        __nv_bfloat16* vals = reinterpret_cast<__nv_bfloat16*>(&staged[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          vals[j] = (grow < rows && k0 + kc + j < K) ? src[j] : zero;
      }
    }
  };
  load_tile(0);
  for (int k0 = 0; k0 < K; k0 += kMmaBK) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = threadIdx.x + i * kThreads;
      if (c >= kChunks) continue;
      const int r = (c < BM * 4 ? c : c - BM * 4) >> 2;
      __nv_bfloat16* dst = c < BM * 4 ? &Xs[r][(c & 3) * 8]
                                      : &Ws[r][(c & 3) * 8];
      *reinterpret_cast<uint4*>(dst) = staged[i];
    }
    __syncthreads();
    if (k0 + kMmaBK < K) load_tile(k0 + kMmaBK);
#pragma unroll
    for (int kk = 0; kk < kMmaBK; kk += 16) {
      uint32_t a[2][4], b[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + g;
        a[mi][0] = vs::ld_pair(&Xs[r][kk + 2 * t]);
        a[mi][1] = vs::ld_pair(&Xs[r + 8][kk + 2 * t]);
        a[mi][2] = vs::ld_pair(&Xs[r][kk + 8 + 2 * t]);
        a[mi][3] = vs::ld_pair(&Xs[r + 8][kk + 8 + 2 * t]);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int n = wn * 64 + ni * 8 + g;
        b[ni][0] = vs::ld_pair(&Ws[n][kk + 2 * t]);
        b[ni][1] = vs::ld_pair(&Ws[n][kk + 8 + 2 * t]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
          vs::mma_bf16_16816(acc[mi][ni], a[mi][0], a[mi][1], a[mi][2],
                             a[mi][3], b[ni][0], b[ni][1]);
    }
    __syncthreads();
  }

  // element (mi, ni, e) sits at local row wm*32 + mi*16 + g + 8*(e >> 1)
  // and column wn*64 + ni*8 + 2t + (e & 1)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + wn * 64 + ni * 8 + 2 * t + (e & 1);
        float y = col < N ? acc[mi][ni][e] + bias[col] : 0.f;
        if (EPI == EPI_RELU) y = fmaxf(y, 0.f);
        if (EPI == EPI_RES_LN || EPI == EPI_RES) {
          const int row = m0 + wm * 32 + mi * 16 + g + 8 * (e >> 1);
          if (col < N && row < M) {
            const size_t o = (size_t)row * N + col;
            y += resid_f != nullptr ? resid_f[o]
                                    : __bfloat162float(resid_t[o]);
          }
        }
        acc[mi][ni][e] = y;
      }

  if (EPI == EPI_RES_LN) {
    float mean[2][2] = {}, inv[2][2] = {};
    // pass 0: row sums -> mean; pass 1: squared deviations -> variance
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float s = 0.f;
#pragma unroll
          for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int col = n0 + wn * 64 + ni * 8 + 2 * t + c;
              const float v = acc[mi][ni][2 * h + c];
              const float dv = pass == 0 ? v : v - mean[mi][h];
              s += col < N ? (pass == 0 ? dv : dv * dv) : 0.f;
            }
          s = vs::group_sum<4>(s);
          if (t == 0) red[pass][wn][wm * 32 + mi * 16 + g + 8 * h] = s;
        }
      __syncthreads();
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + mi * 16 + g + 8 * h;
          float s = 0.f;
#pragma unroll
          for (int w = 0; w < WARPS_N; ++w) s += red[pass][w][r];
          if (pass == 0)
            mean[mi][h] = s / (float)N;
          else
            inv[mi][h] = 1.f / sqrtf(s / (float)N + eps);
        }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + wn * 64 + ni * 8 + 2 * t + (e & 1);
          if (col < N)
            acc[mi][ni][e] = (acc[mi][ni][e] - mean[mi][e >> 1]) *
                                 inv[mi][e >> 1] * ln_g[col] + ln_b[col];
        }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 32 + mi * 16 + g + 8 * (e >> 1);
        const int col = n0 + wn * 64 + ni * 8 + 2 * t + (e & 1);
        if (row >= M || col >= N) continue;
        const size_t o = (size_t)row * N + col;
        if (out_f != nullptr) out_f[o] = acc[mi][ni][e];
        if (out_t != nullptr) out_t[o] = __float2bfloat16(acc[mi][ni][e]);
      }
}

// ---------------------------------------------------------------------------
// bf16 on Hopper's warpgroup products. Shared memory per stage: the X tile
// (BM rows) then the W tile (BN rows), each row 64 bf16 = one 128-byte
// swizzle row, as TMA's SWIZZLE_128B writes it and a wgmma descriptor of
// that layout reads it: 8-row groups of 1024 bytes (the stride byte offset),
// the 16-deep k slice kk at +32 kk bytes, tiles on 1024-byte boundaries.
constexpr int kStages = 4;
constexpr int kWgBK = 64;

template <int BM, int BN>
struct WgTiles {
  static constexpr int kA = BM * kWgBK * 2;
  static constexpr int kStage = kA + BN * kWgBK * 2;
  // the ring, 2 kStages mbarriers, and the slack that aligns the ring to
  // 1024 bytes
  static constexpr int kSmem = kStages * kStage + 2 * kStages * 8 + 1024;
};

// keeps the compiler from moving accesses of an accumulator register across
// the asynchronous products that write it
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// D (64 x 256, f32) += A (64 x 16) . B (256 x 16)^T, A and B bf16, both
// K-major in 128-byte-swizzled shared memory (descriptors da, db)
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// the same with B 128 x 16
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 256)
    wgmma_n256(d, da, db);
  else
    wgmma_n128(d, da, db);
}

// A CTA of BM / 64 consumer warpgroups (warps 0 .. BM/16 - 1; warpgroup c
// takes rows 64c .. 64c + 63 of the tile) and one producer warpgroup (the
// last; one of its threads issues the loads), over a BM x BN tile of Y:
// grid (ceil(N / BN), ceil(M / BM)). At BM 128 the producer warpgroup hands
// its registers to the consumers (setmaxnreg 40 / 232), whose 128
// accumulators a thread would spill under the 168 registers of 384 threads.
// The epilogue stages the tile through the (by then idle) ring as f32 rows
// of BN + 8 floats, and each warp finishes the 16 rows it wrote: lane l
// holds columns 2l + 64i and 2l + 64i + 1, so bias, residual and outputs
// move as coalesced rows, and a LayerNorm row reduces in lane order and
// then across the warp (the same order in every tile shape).
template <int BM, int BN, int EPI>
__global__ void __launch_bounds__(2 * BM + 128, 1)
gemm_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                       const __grid_constant__ CUtensorMap tmw,
                       const float* __restrict__ bias,
                       const __nv_bfloat16* __restrict__ resid_t,
                       const float* __restrict__ resid_f,
                       const float* __restrict__ ln_g,
                       const float* __restrict__ ln_b,
                       __nv_bfloat16* __restrict__ out_t,
                       float* __restrict__ out_f, int M, int N, int K,
                       float eps) {
  using Tiles = WgTiles<BM, BN>;
  constexpr int kConsumers = BM / 64;
  constexpr int kLd = BN + 8;  // epilogue row stride (floats)
  static_assert(BM * kLd * 4 <= kStages * Tiles::kStage,
                "the epilogue tile fits in the ring");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = ring + kStages * Tiles::kStage;  // + 8 s
  const uint32_t empty = full + 8 * kStages;             // + 8 s
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kt_end = (K + kWgBK - 1) / kWgBK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {
    // producer: one thread keeps up to kStages tiles in flight
    if constexpr (BM == 128)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == kConsumers * 128) {
      for (int kt = 0; kt < kt_end; ++kt) {
        const int s = kt % kStages;
        mbar_wait(empty + 8 * s, ((kt / kStages) & 1) ^ 1);
        const uint32_t a = ring + s * Tiles::kStage;
        mbar_arrive_tx(full + 8 * s, Tiles::kStage);
        tma_load(a, &tmx, kt * kWgBK, m0, full + 8 * s);
        tma_load(a + Tiles::kA, &tmw, kt * kWgBK, n0, full + 8 * s);
      }
    }
  } else {
    if constexpr (BM == 128)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int wg = warp >> 2;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < kt_end; ++kt) {
      const int s = kt % kStages;
      mbar_wait(full + 8 * s, (kt / kStages) & 1);
      const uint32_t a = ring + s * Tiles::kStage + wg * 64 * 128;
      const uint32_t b = ring + s * Tiles::kStage + Tiles::kA;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk)
        wgmma_tile<BN>(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk));
      wgmma_commit();
      // the previous stage's products are done: hand its tiles back
      wgmma_wait<1>();
      if (kt > 0) mbar_arrive(empty + 8 * ((kt - 1) % kStages));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);

    // every consumer warpgroup is done reading the ring: it takes the tile.
    // acc[4j + 2h + c] sits at tile row 64 wg + 16 (warp % 4) + g + 8h and
    // column 8j + 2t + c (the m64nNk16 accumulator layout)
    named_bar_sync(1, kConsumers * 128);
    float* tile = reinterpret_cast<float*>(smem_raw + (ring - smem_u32(smem_raw)));
    const int r0 = wg * 64 + (warp & 3) * 16;
    {
      const int g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(tile + (r0 + g + 8 * h) * kLd + 8 * j +
                                     2 * t) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
    __syncwarp();

    const bool pairs = (N & 1) == 0;  // aligned 4 / 8-byte column pairs
    for (int r = 0; r < 16; ++r) {
      const int row = m0 + r0 + r;
      if (row >= M) break;  // warp-uniform
      const float* src = tile + (r0 + r) * kLd;
      const size_t o = (size_t)row * N;
      float y[BN / 32];
#pragma unroll
      for (int i = 0; i < BN / 64; ++i) {
        const float2 v = *reinterpret_cast<const float2*>(src + 2 * lane +
                                                          64 * i);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = n0 + 2 * lane + 64 * i + c;
          float x = col < N ? (c ? v.y : v.x) + bias[col] : 0.f;
          if (EPI == EPI_RELU) x = fmaxf(x, 0.f);
          if ((EPI == EPI_RES_LN || EPI == EPI_RES) && col < N)
            x += resid_f != nullptr ? resid_f[o + col]
                                    : __bfloat162float(resid_t[o + col]);
          y[2 * i + c] = x;
        }
      }
      if (EPI == EPI_RES_LN) {
        // the whole row lies in this tile (n0 = 0, N <= BN)
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < BN / 32; ++i) sum += y[i];
        const float mean = vs::group_sum<32>(sum) / (float)N;
        float var = 0.f;
#pragma unroll
        for (int i = 0; i < BN / 32; ++i) {
          const float dv = y[i] - mean;
          var += 2 * lane + 64 * (i >> 1) + (i & 1) < N ? dv * dv : 0.f;
        }
        const float inv = 1.f / sqrtf(vs::group_sum<32>(var) / (float)N + eps);
#pragma unroll
        for (int i = 0; i < BN / 32; ++i) {
          const int col = 2 * lane + 64 * (i >> 1) + (i & 1);
          if (col < N) y[i] = (y[i] - mean) * inv * ln_g[col] + ln_b[col];
        }
      }
#pragma unroll
      for (int i = 0; i < BN / 64; ++i) {
        const int col = n0 + 2 * lane + 64 * i;
        if (col >= N) continue;
        if (pairs) {
          if (out_f != nullptr)
            *reinterpret_cast<float2*>(out_f + o + col) =
                make_float2(y[2 * i], y[2 * i + 1]);
          if (out_t != nullptr)
            *reinterpret_cast<__nv_bfloat162*>(out_t + o + col) =
                __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
        } else {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            if (col + c >= N) continue;
            if (out_f != nullptr) out_f[o + col + c] = y[2 * i + c];
            if (out_t != nullptr)
              out_t[o + col + c] = __float2bfloat16(y[2 * i + c]);
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------------ launch
struct GemmArgs {
  const void* x;
  const void* w;
  const float* bias;
  const void* resid_t;
  const float* resid_f;
  const float* ln_g;
  const float* ln_b;
  void* out_t;
  float* out_f;
  int M, N, K, ldx, ldw, epi;
  float eps;
};

template <int BM, int BN, int EPI>
cudaError_t launch_wgmma_tile(const GemmArgs& g, const CUtensorMap& tx,
                              const CUtensorMap& tw, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  constexpr int smem = WgTiles<BM, BN>::kSmem;
  auto kernel = gemm_bf16_wgmma_kernel<BM, BN, EPI>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM);
  kernel<<<grid, 2 * BM + 128, smem, stream>>>(
      tx, tw, g.bias, static_cast<const bf*>(g.resid_t), g.resid_f, g.ln_g,
      g.ln_b, static_cast<bf*>(g.out_t), g.out_f, g.M, g.N, g.K, g.eps);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_wgmma_epi(const GemmArgs& g, const CUtensorMap& tx,
                             const CUtensorMap& tw, cudaStream_t stream) {
  switch (g.epi) {
    case EPI_NONE:
      return launch_wgmma_tile<BM, BN, EPI_NONE>(g, tx, tw, stream);
    case EPI_RELU:
      return launch_wgmma_tile<BM, BN, EPI_RELU>(g, tx, tw, stream);
    case EPI_RES_LN:
      return launch_wgmma_tile<BM, BN, EPI_RES_LN>(g, tx, tw, stream);
    case EPI_RES:
      return launch_wgmma_tile<BM, BN, EPI_RES>(g, tx, tw, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t launch_wgmma(const GemmArgs& g, int bm, int bn,
                         cudaStream_t stream) {
  // TMA: 16-byte aligned bases and row strides
  if (g.K % 8 || g.ldx % 8 || g.ldw % 8 ||
      reinterpret_cast<uintptr_t>(g.x) % 16 ||
      reinterpret_cast<uintptr_t>(g.w) % 16)
    return cudaErrorInvalidValue;
  alignas(64) CUtensorMap tx, tw;
  constexpr CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!tensor_map(&tx, bf16, 2, g.x, g.M, g.K, g.ldx, bm) ||
      !tensor_map(&tw, bf16, 2, g.w, g.N, g.K, g.ldw, bn))
    return cudaErrorInvalidValue;
  if (bm == 128 && bn == 256)
    return launch_wgmma_epi<128, 256>(g, tx, tw, stream);
  if (bm == 128 && bn == 128)
    return launch_wgmma_epi<128, 128>(g, tx, tw, stream);
  if (bm == 64 && bn == 256)
    return launch_wgmma_epi<64, 256>(g, tx, tw, stream);
  if (bm == 64 && bn == 128)
    return launch_wgmma_epi<64, 128>(g, tx, tw, stream);
  return cudaErrorInvalidValue;
}

cudaError_t launch_mma(const GemmArgs& g, cudaStream_t stream) {
  constexpr int BM = 32 * WARPS_M, BN = 64 * WARPS_N;
  const dim3 grid((g.M + BM - 1) / BM, (g.N + BN - 1) / BN);
  using bf = __nv_bfloat16;
  const bf* X = static_cast<const bf*>(g.x);
  const bf* Wt = static_cast<const bf*>(g.w);
  const bf* R = static_cast<const bf*>(g.resid_t);
  bf* O = static_cast<bf*>(g.out_t);
  // 16-byte staging loads need 16-byte aligned rows
  const bool vec = g.K % 8 == 0 && g.ldx % 8 == 0 && g.ldw % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(g.x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g.w) % 16 == 0;
#define VS_MMA(E)                                                            \
  gemm_bf16_mma_kernel<E><<<grid, kThreads, 0, stream>>>(                    \
      X, Wt, g.bias, R, g.resid_f, g.ln_g, g.ln_b, O, g.out_f, g.M, g.N, g.K, \
      g.ldx, g.ldw, g.eps, vec)
  switch (g.epi) {
    case EPI_NONE: VS_MMA(EPI_NONE); break;
    case EPI_RELU: VS_MMA(EPI_RELU); break;
    case EPI_RES_LN: VS_MMA(EPI_RES_LN); break;
    case EPI_RES: VS_MMA(EPI_RES); break;
    default: return cudaErrorInvalidValue;
  }
#undef VS_MMA
  return cudaGetLastError();
}

template <int BM, int R, int MODE, int EPI>
cudaError_t launch_f32_tile(const GemmArgs& g, cudaStream_t stream) {
  constexpr int BN = R * R * kThreads / BM;
  const dim3 grid((g.M + BM - 1) / BM, (g.N + BN - 1) / BN);
  const float* resid = g.resid_f != nullptr
                           ? g.resid_f
                           : static_cast<const float*>(g.resid_t);
  gemm_f32_kernel<BM, R, MODE, EPI><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(g.x), static_cast<const float*>(g.w), g.bias,
      resid, static_cast<float*>(g.out_t), g.out_f, g.M, g.N, g.K, g.ldx,
      g.ldw);
  return cudaGetLastError();
}

template <int BM, int R, int MODE>
cudaError_t launch_f32_epi(const GemmArgs& g, cudaStream_t stream) {
  switch (g.epi) {
    case EPI_NONE: return launch_f32_tile<BM, R, MODE, EPI_NONE>(g, stream);
    case EPI_RELU: return launch_f32_tile<BM, R, MODE, EPI_RELU>(g, stream);
    case EPI_RES: return launch_f32_tile<BM, R, MODE, EPI_RES>(g, stream);
    default: return cudaErrorInvalidValue;
  }
}

// tile 128: 128 x 128 CTAs (R 8); 64: 64 x 64 (R 4)
cudaError_t launch_f32(const GemmArgs& g, int tile, cudaStream_t stream) {
  // 16-byte loads need K and the row strides a multiple of 4 floats and
  // 16-byte aligned bases (ops/block_kernel.gemm_takes_vec4)
  const bool vec = g.K % 4 == 0 && g.ldx % 4 == 0 && g.ldw % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(g.x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g.w) % 16 == 0;
  if (tile == 128)
    return vec ? launch_f32_epi<128, 8, fg::kVecK>(g, stream)
               : launch_f32_epi<128, 8, fg::kAny>(g, stream);
  if (tile == 64)
    return vec ? launch_f32_epi<64, 4, fg::kVecK>(g, stream)
               : launch_f32_epi<64, 4, fg::kAny>(g, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// cta_rows: 128 or 64 takes the wgmma kernel (bf16) with tile_n (128 or
// 256) columns a CTA; 0 takes the FMA kernel (f32) or the mma.sync fallback
// (bf16). In f32, tile_n is the FMA kernel's square tile (128 or 64), and
// every residual+LayerNorm row goes through the pre-LN f32 buffer and the
// row kernel. ldx / ldw: the row strides of x and w in elements.
extern "C" int vs_gemm_bias_epilogue(const void* x, const void* w,
                                     const float* bias, const void* resid_t,
                                     const float* resid_f, const float* ln_g,
                                     const float* ln_b, void* out_t,
                                     float* out_f, int M, int N, int K,
                                     int ldx, int ldw, int epilogue,
                                     int dtype, int cta_rows, int tile_n,
                                     float eps, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || ldx < K || ldw < K ||
      epilogue < EPI_NONE || epilogue > EPI_RES_LN)
    return (int)cudaErrorInvalidValue;
  if (epilogue == EPI_RES_LN && resid_t == nullptr && resid_f == nullptr)
    return (int)cudaErrorInvalidValue;
  const bool wgmma = cta_rows != 0;
  if (wgmma && (dtype != vs::kBF16 || (cta_rows != 64 && cta_rows != 128) ||
                (tile_n != 128 && tile_n != 256)))
    return (int)cudaErrorInvalidValue;
  if (dtype == vs::kF32 && tile_n != 128 && tile_n != 64)
    return (int)cudaErrorInvalidValue;
  // a LayerNorm row wider than one CTA tile (256 columns; the wgmma
  // kernel's tile_n; in f32 every row) goes through out_f (required) and a
  // row kernel
  const int ln_cols = dtype == vs::kF32 ? 0 : (wgmma ? tile_n : 256);
  const bool wide = epilogue == EPI_RES_LN && N > ln_cols;
  if (wide && out_f == nullptr) return (int)cudaErrorInvalidValue;
  const GemmArgs g{x, w, bias, resid_t, resid_f, ln_g, ln_b,
                   wide ? nullptr : out_t, out_f, M, N, K, ldx, ldw,
                   wide ? (int)EPI_RES : epilogue, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == vs::kF32 && !wgmma)
    err = launch_f32(g, tile_n, s);
  else if (dtype == vs::kBF16)
    err = wgmma ? launch_wgmma(g, cta_rows, tile_n, s) : launch_mma(g, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess || !wide) return (int)err;
  return (int)(dtype == vs::kF32
                   ? vs::launch_layernorm_rows<float>(out_f, ln_g, ln_b, out_t,
                                                      nullptr, nullptr, M, N,
                                                      eps, s)
                   : vs::launch_layernorm_rows<__nv_bfloat16>(
                         out_f, ln_g, ln_b, out_t, nullptr, nullptr, M, N,
                         eps, s));
}

// Dynamic shared memory of the wgmma kernel's (cta_rows, tile_n) shape, in
// bytes (for the build report).
extern "C" int vs_gemm_wgmma_smem(int cta_rows, int tile_n) {
  if (cta_rows == 128 && tile_n == 256) return WgTiles<128, 256>::kSmem;
  if (cta_rows == 128 && tile_n == 128) return WgTiles<128, 128>::kSmem;
  if (cta_rows == 64 && tile_n == 256) return WgTiles<64, 256>::kSmem;
  if (cta_rows == 64 && tile_n == 128) return WgTiles<64, 128>::kSmem;
  return 0;
}
