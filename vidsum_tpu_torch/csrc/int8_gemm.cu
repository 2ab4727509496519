// int8_gemm: the W8A8 products of the int8 scoring path for sm_90a, and the
// per-row int8 quantizer that feeds them.
//
// Replaces (with masked_attention.cu) the row-wise products of the TPU
// kernels vidsum_tpu/ops/block_kernel_int8.py::_block_kernel_int8 and
// ::_block_kernel_int8_grouped, and the int8 probe kernel
// scripts/probe_int8_mxu.py::_mm_kernel_int8. As in the bf16 block
// (gemm_bias_epilogue.cu), a block's weights do not fit an SM's shared memory,
// so the TPU's one-program block becomes a chain of launches, each product
// with its epilogue:
//   EPI_DEQ     y = acc * (sx[m] * sw[n]) + b[n]      (QKV, embed, dense route)
//   EPI_RELU    y = max(acc * (sx sw) + b, 0)         (fc1)
//   EPI_RES_LN  y = LN(acc * (sx sw) + b + residual)  (proj + LN1, fc2 + LN2),
//               optionally also the row's int8 codes and scale (LN1 -> fc1);
//               a row wider than the CTA tile (d 384 and up) is written
//               pre-LN in f32 (EPI_RES, into out_f) and normalised,
//               quantised and rounded by common.cuh's layernorm_rows_kernel
//               (past d 1,024 layernorm_rows_wide_kernel), with the same
//               IEEE-rounded operations
//   EPI_SHIFT   y = int8(acc >> 8)                    (the probe, kernel 18b)
// X (M, K) and W (N, K) are int8 codes, both K-contiguous (W in nn.Linear's
// (out, in) layout) on 16-byte boundaries, sx (M,) and sw (N,) their f32
// scales; K % 32 == 0 (ops/quant.int8_gemm pads other K with zero codes,
// which add nothing). Accumulation is exact s32 (K * 127^2 < 2^31 for K <
// 133,000). The f32 glue is rounded after every operation (common.cuh:
// dequant, quant_code), as the plain PyTorch version's separate tensor ops
// round it, so the int8 codes a kernel emits equal the plain version's; what
// can differ is only the f32 summation order of the LayerNorm moments.
//
// Bound on the card: a product does 2 M N K int8 operations and moves its
// operands and outputs once. At the flagship block (B=32, N=512, d=256) the
// four products are 24*d^2*B*N = 25.8 G operations, 13 us at the int8
// tensor-core peak (1,979 TOP/s), against ~175 MB (fc1's f32 ReLU output,
// 67 MB, written and read again by the quantizer, and the f32 pre-LN rows),
// 52 us at 3.35 TB/s: bytes bound the block's products, operations bound a
// large square product (the probe's 2048^3 and 8192^3). Design against
// both (int8_gemm_wgmma_kernel): Hopper's warpgroup products
// (wgmma.mma_async m64nNk32, s32 from s8 x s8, N = 128 or 256) read both
// operands K-major from a 4-stage ring of 128-deep tiles in the 128-byte
// swizzle (one swizzle row holds 128 int8 K values, so a stage is four k32
// products, and the descriptors step 32 bytes a product as the bf16 kernel's
// do); one thread of a producer warpgroup fills the ring by TMA (tensor maps
// cached by pointer and shape, tma_ring.cuh) while one or two consumer
// warpgroups (64 or 128 rows) run the products and hand each stage back
// through an mbarrier; the producer gives its registers to the consumers
// (setmaxnreg 40 / 232), whose 128 s32 accumulators a thread at N 256 would
// not fit otherwise. The elementwise epilogues run on the accumulators in
// wgmma's fragment layout: a thread holds two rows' columns 8j + 2t + c, so
// the dequantisation, bias, ReLU and residual need no exchange and the
// stores are 32 contiguous bytes a row per lane quad (whole sectors). A
// LayerNorm row of up to 256 columns goes through the idle ring as f32 and
// one lane quad finishes it (moments and absmax in each lane's column
// order, then two quad shuffles), in the same order for every row in every
// tile shape (reducing it in the accumulators' own lane quad would keep 128
// values and the LayerNorm's temporaries a thread, and spills). Every
// output is an exact s32 sum and a row's LayerNorm does not see the other
// rows, so a row's result does not depend on M or on the tile (served
// scores equal solo scores bit for bit). ops/quant.int8_gemm_tile picks the
// tile from the grid; operands off 16 bytes are copied onto them by the
// wrapper (int8_gemm.fallback_launches). What still holds the block's
// products back (PERF.md): one CTA an SM, whose epilogue (all of it after
// the last k tile) is latency-bound and overlaps no loads.
//
// The quantizer runs one warp per row: the row's absmax (a max, exact in any
// order), then the codes. Inputs f32 or bf16 (a bf16 value widens exactly).
#include "common.cuh"
#include "tma_ring.cuh"

namespace {

using namespace vs::tma;

enum Epilogue : int { EPI_DEQ = 0, EPI_RELU = 1, EPI_RES_LN = 2,
                      EPI_SHIFT = 3, EPI_RES = 4 /* internal: pre-LN row */ };

// Shared memory per stage: the X tile (BM rows) then the W tile (BN rows),
// each row 128 int8 = one 128-byte swizzle row as TMA's SWIZZLE_128B writes
// it: 8-row groups of 1024 bytes (the descriptors' stride byte offset), the
// k32 slice kk at +32 kk bytes, tiles on 1024-byte boundaries.
constexpr int kStages = 4;
constexpr int kBK = 128;

template <int BM, int BN>
struct Tiles {
  static constexpr int kA = BM * kBK;
  static constexpr int kStage = kA + BN * kBK;
  // the ring, 2 kStages mbarriers, and the slack that aligns the ring to
  // 1024 bytes
  static constexpr int kSmem = kStages * kStage + 2 * kStages * 8 + 1024;
};

// keeps the compiler from moving accesses of an accumulator register across
// the asynchronous products that write it
__device__ __forceinline__ void reg_fence(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// D (64 x 256, s32) += A (64 x 32) . B (256 x 32)^T, A and B int8, both
// K-major in 128-byte-swizzled shared memory (descriptors da, db)
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
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
      "}, %128, %129, p;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

// the same with B 128 x 32
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
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
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (BN == 256)
    wgmma_s8_n256(d, da, db);
  else
    wgmma_s8_n128(d, da, db);
}

// What a launch reads and writes besides its two tensor maps. out_t and
// resid_t are bf16 (an f32 caller's out_t and residual travel as out_f and
// resid_f).
struct Args {
  const float* sx;
  const float* sw;
  const float* bias;
  const __nv_bfloat16* resid_t;
  const float* resid_f;
  const float* ln_g;
  const float* ln_b;
  __nv_bfloat16* out_t;
  float* out_f;
  int8_t* out_q;
  float* out_s;
  int M, N, K;
  float eps;
};

// v[col], v[col + 1] (0 past n)
__device__ __forceinline__ float2 col_pair(const float* v, int col, int n) {
  return make_float2(col < n ? v[col] : 0.f, col + 1 < n ? v[col + 1] : 0.f);
}

// The residual at row `row`, columns col and col + 1 (0 past M or N).
__device__ __forceinline__ float2 resid_pair(const Args& a, int row, int col,
                                             bool pairs) {
  float2 r = make_float2(0.f, 0.f);
  if (row >= a.M || col >= a.N) return r;
  const size_t o = (size_t)row * a.N + col;
  if (a.resid_f != nullptr && pairs) return
      *reinterpret_cast<const float2*>(a.resid_f + o);
  r.x = a.resid_f != nullptr ? a.resid_f[o] : __bfloat162float(a.resid_t[o]);
  if (col + 1 < a.N)
    r.y = a.resid_f != nullptr ? a.resid_f[o + 1]
                               : __bfloat162float(a.resid_t[o + 1]);
  return r;
}

// The values of the accumulators (a0, a1) at columns col and col + 1:
// dequantised with the row's and the columns' scales, plus the bias, then
// ReLU (EPI_RELU) or plus the residual r (EPI_RES); each operation
// IEEE-rounded; 0 past n.
template <int EPI>
__device__ __forceinline__ float2 pre_pair(int a0, int a1, float sx,
                                           float2 sw, float2 b, float2 r,
                                           int col, int n) {
  float v[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (col + c >= n) continue;
    v[c] = vs::dequant(c ? a1 : a0, sx, c ? sw.y : sw.x, c ? b.y : b.x);
    if (EPI == EPI_RELU) v[c] = fmaxf(v[c], 0.f);
    if (EPI == EPI_RES) v[c] = __fadd_rn(v[c], c ? r.y : r.x);
  }
  return make_float2(v[0], v[1]);
}

// Stores the pair v at element o (column col) into out_f and, rounded to
// bf16, out_t, where asked for; pairs: N even, so the pair is 8 / 4-byte
// aligned.
__device__ __forceinline__ void store_pair(const Args& a, size_t o, int col,
                                           float2 v, bool pairs) {
  if (pairs) {
    if (a.out_f != nullptr) *reinterpret_cast<float2*>(a.out_f + o) = v;
    if (a.out_t != nullptr)
      *reinterpret_cast<__nv_bfloat162*>(a.out_t + o) =
          __floats2bfloat162_rn(v.x, v.y);
    return;
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (col + c >= a.N) continue;
    const float x = c ? v.y : v.x;
    if (a.out_f != nullptr) a.out_f[o + c] = x;
    if (a.out_t != nullptr) a.out_t[o + c] = __float2bfloat16(x);
  }
}

// A CTA of BM / 64 consumer warpgroups (warps 0 .. BM/16 - 1; warpgroup c
// takes rows 64c .. 64c + 63 of the tile) and one producer warpgroup (the
// last; one of its threads issues the loads), over a BM x BN tile of Y:
// grid (ceil(N / BN), ceil(M / BM)). acc[4j + 2h + c] of a consumer thread
// sits at tile row 64 wg + 16 (warp % 4) + g + 8h and column 8j + 2t + c (g
// = lane / 4, t = lane % 4; the m64nNk32 accumulator layout).
template <int BM, int BN, int EPI>
__global__ void __launch_bounds__(2 * BM + 128, 1)
int8_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                       const __grid_constant__ CUtensorMap tmw,
                       const Args a) {
  using T = Tiles<BM, BN>;
  constexpr int kConsumers = BM / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = ring + kStages * T::kStage;  // + 8 s
  const uint32_t empty = full + 8 * kStages;         // + 8 s
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kt_end = (a.K + kBK - 1) / kBK;

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
        const uint32_t x = ring + s * T::kStage;
        mbar_arrive_tx(full + 8 * s, T::kStage);
        tma_load(x, &tmx, kt * kBK, m0, full + 8 * s);
        tma_load(x + T::kA, &tmw, kt * kBK, n0, full + 8 * s);
      }
    }
    return;
  }
  if constexpr (BM == 128)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int wg = warp >> 2;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full + 8 * s, (kt / kStages) & 1);
    const uint32_t x = ring + s * T::kStage + wg * 64 * kBK;
    const uint32_t w = ring + s * T::kStage + T::kA;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      wgmma_s8<BN>(acc, sw128_desc(x + 32 * kk), sw128_desc(w + 32 * kk));
    wgmma_commit();
    // the previous stage's products are done: hand its tiles back
    wgmma_wait<1>();
    if (kt > 0) mbar_arrive(empty + 8 * ((kt - 1) % kStages));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);

  const int g = lane >> 2, t = lane & 3;
  const int r0 = m0 + wg * 64 + (warp & 3) * 16 + g;  // and r0 + 8
  const int M = a.M, N = a.N;
  const bool pairs = (N & 1) == 0;  // aligned 2 / 4 / 8-byte column pairs
  if constexpr (EPI == EPI_SHIFT) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        if (row >= M || col >= N) continue;
        // arithmetic shift, then the low 8 bits (XLA's int32 -> int8)
        const int8_t v0 = static_cast<int8_t>(acc[4 * j + 2 * h] >> 8);
        const int8_t v1 = static_cast<int8_t>(acc[4 * j + 2 * h + 1] >> 8);
        int8_t* o = a.out_q + (size_t)row * N + col;
        if (pairs)
          *reinterpret_cast<char2*>(o) = make_char2(v0, v1);
        else {
          o[0] = v0;
          if (col + 1 < N) o[1] = v1;
        }
      }
    }
  } else {
    float rsx[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rsx[h] = r0 + 8 * h < M ? a.sx[r0 + 8 * h] : 0.f;
    // column groups whose loads (scales, bias, residual) are issued
    // together, ahead of the group's stores: the compiler may not move a
    // load past a store that could alias it
    constexpr int kChunk = 4;
    if constexpr (EPI != EPI_RES_LN) {
      // elementwise: each column pair is finished and stored at once
#pragma unroll
      for (int j0 = 0; j0 < BN / 8; j0 += kChunk) {
        float2 sw[kChunk], b[kChunk], r[kChunk][2];
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const int col = n0 + 8 * (j0 + jj) + 2 * t;
          sw[jj] = col_pair(a.sw, col, N);
          b[jj] = col_pair(a.bias, col, N);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            r[jj][h] = EPI == EPI_RES ? resid_pair(a, r0 + 8 * h, col, pairs)
                                      : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const int j = j0 + jj, col = n0 + 8 * j + 2 * t;
          if (col >= N) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r0 + 8 * h;
            if (row >= M) continue;
            store_pair(a, (size_t)row * N + col, col,
                       pre_pair<EPI>(acc[4 * j + 2 * h],
                                     acc[4 * j + 2 * h + 1], rsx[h], sw[jj],
                                     b[jj], r[jj][h], col, N),
                       pairs);
          }
        }
      }
    } else {
      // the whole row lies in this tile (n0 = 0, N <= BN). The dequantised
      // rows go through the ring (idle once every consumer warpgroup's
      // products are done) as f32 rows of BN + 8 floats, and the warp
      // finishes the 16 rows it wrote, a lane quad a row, reading the
      // residual as whole row segments: a row's moments and absmax reduce
      // in each lane's column order, then across its quad, in the same
      // order in every tile shape. (Reducing the rows in the lane quads
      // that hold them in the accumulators keeps 128 values and the
      // LayerNorm's temporaries a thread, and spills at 256 columns.)
      constexpr int kLd = BN + 8;
      static_assert(BM * kLd * 4 <= kStages * T::kStage,
                    "the epilogue tile fits in the ring");
      named_bar_sync(1, kConsumers * 128);
      float* tile =
          reinterpret_cast<float*>(smem_raw + (ring - smem_u32(smem_raw)));
      const int tr0 = wg * 64 + (warp & 3) * 16;  // the warp's first row
      const float2 zero = make_float2(0.f, 0.f);
#pragma unroll
      for (int j0 = 0; j0 < BN / 8; j0 += kChunk) {
        float2 sw[kChunk], b[kChunk];
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          sw[jj] = col_pair(a.sw, 8 * (j0 + jj) + 2 * t, N);
          b[jj] = col_pair(a.bias, 8 * (j0 + jj) + 2 * t, N);
        }
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const int j = j0 + jj, col = 8 * j + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(tile + (tr0 + g + 8 * h) * kLd + col) =
                pre_pair<EPI_DEQ>(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1],
                                  rsx[h], sw[jj], b[jj], zero, col, N);
        }
      }
      __syncwarp();
      // each lane quad finishes one row, eight rows of the warp's 16 at a
      // time: lane t holds columns 16i + 4t .. 16i + 4t + 3, i < BN / 16
      const bool codes = a.out_q != nullptr;
      const bool quads = (N & 3) == 0;  // aligned 16 / 8 / 4-byte stores
      constexpr int kPer = BN / 4;      // values a lane
#pragma unroll 1
      for (int r8 = 0; r8 < 16; r8 += 8) {
        const int tr = tr0 + r8 + g;
        const int row = m0 + tr;
        float z[kPer];
#pragma unroll
        for (int i = 0; i < kPer / 4; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(
              tile + tr * kLd + 16 * i + 4 * t);
          // plus the residual (row-major: the quad reads 64 bytes of f32
          // or 32 of bf16 a group)
          const int col = 16 * i + 4 * t;
          float r[4] = {0.f, 0.f, 0.f, 0.f};
          if (row < M && col < N) {
            const size_t o = (size_t)row * N + col;
            if (quads && a.resid_f != nullptr) {
              const float4 w = *reinterpret_cast<const float4*>(a.resid_f + o);
              r[0] = w.x, r[1] = w.y, r[2] = w.z, r[3] = w.w;
            } else if (quads) {
              const uint2 w = *reinterpret_cast<const uint2*>(a.resid_t + o);
              const float2 lo = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(&w.x));
              const float2 hi = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(&w.y));
              r[0] = lo.x, r[1] = lo.y, r[2] = hi.x, r[3] = hi.y;
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (col + e < N)
                  r[e] = a.resid_f != nullptr
                             ? a.resid_f[o + e]
                             : __bfloat162float(a.resid_t[o + e]);
            }
          }
          z[4 * i] = __fadd_rn(v.x, r[0]);
          z[4 * i + 1] = __fadd_rn(v.y, r[1]);
          z[4 * i + 2] = __fadd_rn(v.z, r[2]);
          z[4 * i + 3] = __fadd_rn(v.w, r[3]);
        }
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < kPer; ++e)
          if (16 * (e / 4) + 4 * t + e % 4 < N) s = __fadd_rn(s, z[e]);
        const float mean = __fdiv_rn(vs::group_sum<4>(s), (float)N);
        float q = 0.f;
#pragma unroll
        for (int e = 0; e < kPer; ++e)
          if (16 * (e / 4) + 4 * t + e % 4 < N) {
            const float dv = __fsub_rn(z[e], mean);
            q = __fadd_rn(q, __fmul_rn(dv, dv));
          }
        const float inv = __fdiv_rn(
            1.f, __fsqrt_rn(__fadd_rn(
                     __fdiv_rn(vs::group_sum<4>(q), (float)N), a.eps)));
        float mx = 0.f;
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const int col = 16 * (e / 4) + 4 * t + e % 4;
          if (col >= N) continue;
          z[e] = __fadd_rn(
              __fmul_rn(__fmul_rn(__fsub_rn(z[e], mean), inv), a.ln_g[col]),
              a.ln_b[col]);
          mx = fmaxf(mx, fabsf(z[e]));
        }
        // the row's int8 codes and scale for the next product
        const float scale = vs::quant_scale(vs::group_max<4>(mx));
        if (row >= M) continue;
        if (codes && t == 0) a.out_s[row] = scale;
        const float qinv = codes ? __fdiv_rn(1.f, scale) : 0.f;
#pragma unroll
        for (int i = 0; i < kPer / 4; ++i) {
          const int col = 16 * i + 4 * t;
          if (col >= N) continue;
          const size_t o = (size_t)row * N + col;
          const float v0 = z[4 * i], v1 = z[4 * i + 1], v2 = z[4 * i + 2],
                      v3 = z[4 * i + 3];
          if (quads) {
            if (a.out_f != nullptr)
              *reinterpret_cast<float4*>(a.out_f + o) =
                  make_float4(v0, v1, v2, v3);
            if (a.out_t != nullptr) {
              __nv_bfloat162* ot =
                  reinterpret_cast<__nv_bfloat162*>(a.out_t + o);
              ot[0] = __floats2bfloat162_rn(v0, v1);
              ot[1] = __floats2bfloat162_rn(v2, v3);
            }
            if (codes)
              *reinterpret_cast<char4*>(a.out_q + o) = make_char4(
                  vs::quant_code(v0, qinv), vs::quant_code(v1, qinv),
                  vs::quant_code(v2, qinv), vs::quant_code(v3, qinv));
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (col + e >= N) continue;
              const float v = z[4 * i + e];
              if (a.out_f != nullptr) a.out_f[o + e] = v;
              if (a.out_t != nullptr) a.out_t[o + e] = __float2bfloat16(v);
              if (codes) a.out_q[o + e] = vs::quant_code(v, qinv);
            }
          }
        }
      }
    }
  }
}

template <int BM, int BN, int EPI>
cudaError_t launch_tile(const CUtensorMap& tx, const CUtensorMap& tw,
                        const Args& a, cudaStream_t stream) {
  constexpr int smem = Tiles<BM, BN>::kSmem;
  auto kernel = int8_gemm_wgmma_kernel<BM, BN, EPI>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM);
  kernel<<<grid, 2 * BM + 128, smem, stream>>>(tx, tw, a);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_epi(int epi, const CUtensorMap& tx, const CUtensorMap& tw,
                       const Args& a, cudaStream_t stream) {
  switch (epi) {
    case EPI_DEQ: return launch_tile<BM, BN, EPI_DEQ>(tx, tw, a, stream);
    case EPI_RELU: return launch_tile<BM, BN, EPI_RELU>(tx, tw, a, stream);
    case EPI_RES_LN:
      return launch_tile<BM, BN, EPI_RES_LN>(tx, tw, a, stream);
    case EPI_SHIFT: return launch_tile<BM, BN, EPI_SHIFT>(tx, tw, a, stream);
    case EPI_RES: return launch_tile<BM, BN, EPI_RES>(tx, tw, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_gemm(const int8_t* x, const int8_t* w, const Args& a,
                        int epi, int bm, int bn, cudaStream_t stream) {
  // TMA: 16-byte aligned bases and row strides (K % 32 == 0); the grid's
  // second dimension holds the row tiles
  if (reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorMisalignedAddress;
  if ((a.M + bm - 1) / bm > 65535) return cudaErrorInvalidValue;
  alignas(64) CUtensorMap tx, tw;
  constexpr CUtensorMapDataType i8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  if (!tensor_map(&tx, i8, 1, x, a.M, a.K, a.K, bm) ||
      !tensor_map(&tw, i8, 1, w, a.N, a.K, a.K, bn))
    return cudaErrorInvalidValue;
  if (bm == 128 && bn == 256)
    return launch_epi<128, 256>(epi, tx, tw, a, stream);
  if (bm == 128 && bn == 128)
    return launch_epi<128, 128>(epi, tx, tw, a, stream);
  if (bm == 64 && bn == 256) return launch_epi<64, 256>(epi, tx, tw, a, stream);
  if (bm == 64 && bn == 128) return launch_epi<64, 128>(epi, tx, tw, a, stream);
  return cudaErrorInvalidValue;
}

constexpr int kRowsPerBlock = 8;  // one warp per row

template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
quantize_rows_kernel(const T* __restrict__ x, int M, int K,
                     int8_t* __restrict__ q, float* __restrict__ s) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;  // whole warps leave together
  const T* xr = x + (size_t)row * K;
  float mx = 0.f;
  for (int c = lane; c < K; c += 32) mx = fmaxf(mx, fabsf(vs::to_f32<T>(xr[c])));
  mx = vs::group_max<32>(mx);
  const float scale = vs::quant_scale(mx);
  const float inv = __fdiv_rn(1.f, scale);
  int8_t* qr = q + (size_t)row * K;
  for (int c = lane; c < K; c += 32)
    qr[c] = vs::quant_code(vs::to_f32<T>(xr[c]), inv);
  if (lane == 0) s[row] = scale;
}

}  // namespace

// X (M, K) int8, sx (M,), W (N, K) int8, sw (N,), bias (N,) f32 (null for
// EPI_SHIFT); X and W on 16-byte boundaries. resid_t (dtype) or resid_f
// (f32) (M, N) and ln_g / ln_b (N,) for EPI_RES_LN (N <= 1,024; past the
// tile's tile_n columns out_f is required). Outputs, each optional: out_t
// (M, N) in dtype, out_f (M, N) f32, out_q (M, N) int8 + out_s (M,) f32
// (the codes of the LayerNorm output, EPI_RES_LN; the shifted result,
// EPI_SHIFT). cta_rows (64 or 128) x tile_n (128 or 256): the CTA tile
// (ops/quant.int8_gemm_tile).
extern "C" int vs_int8_gemm(const int8_t* x, const float* sx,
                            const int8_t* w, const float* sw,
                            const float* bias, const void* resid_t,
                            const float* resid_f, const float* ln_g,
                            const float* ln_b, void* out_t, float* out_f,
                            int8_t* out_q, float* out_s, int M, int N, int K,
                            int epilogue, int dtype, int cta_rows, int tile_n,
                            float eps, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (epilogue < EPI_DEQ || epilogue > EPI_SHIFT)
    return (int)cudaErrorInvalidValue;
  if ((cta_rows != 64 && cta_rows != 128) || (tile_n != 128 && tile_n != 256))
    return (int)cudaErrorInvalidValue;
  if (dtype != vs::kF32 && dtype != vs::kBF16)
    return (int)cudaErrorInvalidValue;
  if (dtype == vs::kF32) {
    // an f32 out_t or residual is the f32 one
    if (out_t != nullptr) {
      if (out_f != nullptr) return (int)cudaErrorInvalidValue;
      out_f = static_cast<float*>(out_t);
      out_t = nullptr;
    }
    if (resid_t != nullptr) {
      if (resid_f != nullptr) return (int)cudaErrorInvalidValue;
      resid_f = static_cast<const float*>(resid_t);
      resid_t = nullptr;
    }
  }
  if (epilogue == EPI_RES_LN && resid_t == nullptr && resid_f == nullptr)
    return (int)cudaErrorInvalidValue;
  // a LayerNorm row wider than the CTA tile goes through out_f (required)
  // and the row kernel
  const bool wide = epilogue == EPI_RES_LN && N > tile_n;
  if (wide && out_f == nullptr) return (int)cudaErrorInvalidValue;
  if (epilogue == EPI_SHIFT && out_q == nullptr)
    return (int)cudaErrorInvalidValue;
  if (epilogue != EPI_SHIFT && (sx == nullptr || sw == nullptr ||
                                bias == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((out_q == nullptr) != (out_s == nullptr) && epilogue != EPI_SHIFT)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{sx, sw, bias, static_cast<const __nv_bfloat16*>(resid_t),
               resid_f, ln_g, ln_b,
               wide ? nullptr : static_cast<__nv_bfloat16*>(out_t), out_f,
               wide ? nullptr : out_q, wide ? nullptr : out_s, M, N, K, eps};
  const cudaError_t err = launch_gemm(x, w, a, wide ? (int)EPI_RES : epilogue,
                                      cta_rows, tile_n, s);
  if (err != cudaSuccess || !wide) return (int)err;
  return (int)(dtype == vs::kF32
                   ? vs::launch_layernorm_rows<float>(out_f, ln_g, ln_b,
                                                      nullptr, out_q, out_s,
                                                      M, N, eps, s)
                   : vs::launch_layernorm_rows<__nv_bfloat16>(
                         out_f, ln_g, ln_b, out_t, out_q, out_s, M, N, eps,
                         s));
}

// Dynamic shared memory of the wgmma kernel's (cta_rows, tile_n) shape, in
// bytes (for the build report).
extern "C" int vs_int8_gemm_smem(int cta_rows, int tile_n) {
  if (cta_rows == 128 && tile_n == 256) return Tiles<128, 256>::kSmem;
  if (cta_rows == 128 && tile_n == 128) return Tiles<128, 128>::kSmem;
  if (cta_rows == 64 && tile_n == 256) return Tiles<64, 256>::kSmem;
  if (cta_rows == 64 && tile_n == 128) return Tiles<64, 128>::kSmem;
  return 0;
}

// x (M, K) in dtype -> q (M, K) int8 codes and s (M,) f32 scales.
extern "C" int vs_quantize_rows(const void* x, int8_t* q, float* s, int M,
                                int K, int dtype, void* stream) {
  if (M <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock);
  if (dtype == vs::kF32)
    quantize_rows_kernel<float><<<grid, 32 * kRowsPerBlock, 0, st>>>(
        static_cast<const float*>(x), M, K, q, s);
  else if (dtype == vs::kBF16)
    quantize_rows_kernel<__nv_bfloat16><<<grid, 32 * kRowsPerBlock, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), M, K, q, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
