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
//               optionally also the row's int8 codes and scale (LN1 -> fc1)
//   EPI_SHIFT   y = int8(acc >> 8)                    (the probe, kernel 18b)
// X (M, K) and W (N, K) are int8 codes, both K-contiguous (W in nn.Linear's
// (out, in) layout), sx (M,) and sw (N,) their f32 scales; K % 32 == 0.
// Accumulation is exact s32 (K * 127^2 < 2^31 for K < 133,000). The f32 glue
// is rounded after every operation (common.cuh: dequant, quant_code), as the
// plain PyTorch version's separate tensor ops round it, so the int8 codes a
// kernel emits equal the plain version's; what can differ is only the f32
// summation order of the LayerNorm moments. Every output element is summed in
// a fixed order by one mma lane, so a row's result does not depend on M or on
// the other rows (served scores equal solo scores bit for bit).
//
// Bound on the card: at the flagship block (B=32, N=512, d=256) the four
// products are 24*d^2*B*N = 25.8 G int8 operations against ~13 MB of
// operands and outputs: ~13 us at the int8 tensor-core peak (1,979 TOP/s),
// ~4 us at the memory rate, so operations bound it. Design against it: the
// int8 tensor cores (mma.sync m16n8k32, s32 accumulate) from padded shared
// memory tiles whose fragment loads are bank-conflict-free, the next K tile
// prefetched into registers while the current one multiplies; the bf16
// GEMM's 64 x 256 CTA tile, so a LayerNorm row lies in one CTA. wgmma,
// multi-stage cp.async / TMA pipelines are later work.
//
// The quantizer runs one warp per row: the row's absmax (a max, exact in any
// order), then the codes. Inputs f32 or bf16 (a bf16 value widens exactly).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBK = 64;        // int8 K tile: two k32 steps
constexpr int kLds = kBK + 16; // padded shared-memory row: 20 words
constexpr int WARPS_M = 2, WARPS_N = 4;  // a 64 x 256 CTA tile

enum Epilogue : int { EPI_DEQ = 0, EPI_RELU = 1, EPI_RES_LN = 2,
                      EPI_SHIFT = 3 };

template <typename T, int EPI>
__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const int8_t* __restrict__ X, const float* __restrict__ sx,
                 const int8_t* __restrict__ W, const float* __restrict__ sw,
                 const float* __restrict__ bias,
                 const T* __restrict__ resid_t,
                 const float* __restrict__ resid_f,
                 const float* __restrict__ ln_g,
                 const float* __restrict__ ln_b, T* __restrict__ out_t,
                 float* __restrict__ out_f, int8_t* __restrict__ out_q,
                 float* __restrict__ out_s, int M, int N, int K, float eps,
                 bool vec) {
  constexpr int BM = 32 * WARPS_M;
  constexpr int BN = 64 * WARPS_N;
  __shared__ __align__(16) int8_t Xs[BM][kLds];
  __shared__ __align__(16) int8_t Ws[BN][kLds];
  __shared__ float red[2][WARPS_N][BM];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  int acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  // a 64-deep tile is (BM + BN) rows of four 16-byte chunks
  constexpr int kChunks = (BM + BN) * 4;
  constexpr int kPerThread = (kChunks + kThreads - 1) / kThreads;
  uint4 staged[kPerThread];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = threadIdx.x + i * kThreads;
      if (c >= kChunks) continue;
      const bool is_x = c < BM * 4;
      const int r = (is_x ? c : c - BM * 4) >> 2;
      const int kc = (c & 3) * 16;
      const int grow = (is_x ? m0 : n0) + r;
      const int rows = is_x ? M : N;
      const int8_t* src = (is_x ? X : W) + (size_t)grow * K + k0 + kc;
      if (vec && grow < rows && k0 + kc + 16 <= K) {
        staged[i] = *reinterpret_cast<const uint4*>(src);
      } else {
        int8_t* vals = reinterpret_cast<int8_t*>(&staged[i]);
#pragma unroll
        for (int j = 0; j < 16; ++j)
          vals[j] = (grow < rows && k0 + kc + j < K) ? src[j] : int8_t(0);
      }
    }
  };
  load_tile(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = threadIdx.x + i * kThreads;
      if (c >= kChunks) continue;
      const int r = (c < BM * 4 ? c : c - BM * 4) >> 2;
      int8_t* dst = c < BM * 4 ? &Xs[r][(c & 3) * 16] : &Ws[r][(c & 3) * 16];
      *reinterpret_cast<uint4*>(dst) = staged[i];
    }
    __syncthreads();
    if (k0 + kBK < K) load_tile(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[2][4], b[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + g;
        a[mi][0] = vs::ld_u32(&Xs[r][kk + 4 * t]);
        a[mi][1] = vs::ld_u32(&Xs[r + 8][kk + 4 * t]);
        a[mi][2] = vs::ld_u32(&Xs[r][kk + 16 + 4 * t]);
        a[mi][3] = vs::ld_u32(&Xs[r + 8][kk + 16 + 4 * t]);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int n = wn * 64 + ni * 8 + g;
        b[ni][0] = vs::ld_u32(&Ws[n][kk + 4 * t]);
        b[ni][1] = vs::ld_u32(&Ws[n][kk + 16 + 4 * t]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
          vs::mma_s8_16832(acc[mi][ni], a[mi][0], a[mi][1], a[mi][2],
                           a[mi][3], b[ni][0], b[ni][1]);
    }
    __syncthreads();
  }

  // element (mi, ni, e) sits at local row wm*32 + mi*16 + g + 8*(e >> 1)
  // and column wn*64 + ni*8 + 2t + (e & 1)
  if (EPI == EPI_SHIFT) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = m0 + wm * 32 + mi * 16 + g + 8 * (e >> 1);
          const int col = n0 + wn * 64 + ni * 8 + 2 * t + (e & 1);
          // arithmetic shift, then the low 8 bits (XLA's int32 -> int8)
          if (row < M && col < N)
            out_q[(size_t)row * N + col] =
                static_cast<int8_t>(acc[mi][ni][e] >> 8);
        }
    return;
  }

  float y[2][8][4];
  float rsx[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 32 + mi * 16 + g + 8 * h;
      rsx[mi][h] = row < M ? sx[row] : 0.f;
    }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + wn * 64 + ni * 8 + 2 * t + (e & 1);
        float v = 0.f;
        if (col < N) {
          v = vs::dequant(acc[mi][ni][e], rsx[mi][e >> 1], sw[col],
                          bias[col]);
          if (EPI == EPI_RELU) v = fmaxf(v, 0.f);
          if (EPI == EPI_RES_LN) {
            const int row = m0 + wm * 32 + mi * 16 + g + 8 * (e >> 1);
            if (row < M) {
              const size_t o = (size_t)row * N + col;
              v = __fadd_rn(v, resid_f != nullptr
                                   ? resid_f[o]
                                   : vs::to_f32<T>(resid_t[o]));
            }
          }
        }
        y[mi][ni][e] = v;
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
              const float v = y[mi][ni][2 * h + c];
              const float dv = pass == 0 ? v : __fsub_rn(v, mean[mi][h]);
              s += col < N ? (pass == 0 ? dv : __fmul_rn(dv, dv)) : 0.f;
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
            mean[mi][h] = __fdiv_rn(s, (float)N);
          else
            inv[mi][h] = __fdiv_rn(
                1.f, __fsqrt_rn(__fadd_rn(__fdiv_rn(s, (float)N), eps)));
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
            y[mi][ni][e] = __fadd_rn(
                __fmul_rn(__fmul_rn(__fsub_rn(y[mi][ni][e], mean[mi][e >> 1]),
                                    inv[mi][e >> 1]),
                          ln_g[col]),
                ln_b[col]);
        }
    if (out_q != nullptr) {
      // pass 2: the row's absmax (red[0] is free: every thread is past its
      // pass-0 reads), then its int8 codes and scale for the next product
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = 0.f;
#pragma unroll
          for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int col = n0 + wn * 64 + ni * 8 + 2 * t + c;
              if (col < N) mx = fmaxf(mx, fabsf(y[mi][ni][2 * h + c]));
            }
          mx = vs::group_max<4>(mx);
          if (t == 0) red[0][wn][wm * 32 + mi * 16 + g + 8 * h] = mx;
        }
      __syncthreads();
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + mi * 16 + g + 8 * h;
          const int row = m0 + r;
          float mx = 0.f;
#pragma unroll
          for (int w = 0; w < WARPS_N; ++w) mx = fmaxf(mx, red[0][w][r]);
          const float scale = vs::quant_scale(mx);
          const float qinv = __fdiv_rn(1.f, scale);
          if (row < M && wn == 0 && t == 0) out_s[row] = scale;
#pragma unroll
          for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int col = n0 + wn * 64 + ni * 8 + 2 * t + c;
              if (row < M && col < N)
                out_q[(size_t)row * N + col] =
                    vs::quant_code(y[mi][ni][2 * h + c], qinv);
            }
        }
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
        if (out_f != nullptr) out_f[o] = y[mi][ni][e];
        if (out_t != nullptr) out_t[o] = vs::from_f32<T>(y[mi][ni][e]);
      }
}

template <typename T>
cudaError_t launch_gemm(const int8_t* x, const float* sx, const int8_t* w,
                        const float* sw, const float* bias,
                        const void* resid_t, const float* resid_f,
                        const float* ln_g, const float* ln_b, void* out_t,
                        float* out_f, int8_t* out_q, float* out_s, int M,
                        int N, int K, int epilogue, float eps,
                        cudaStream_t stream) {
  constexpr int BM = 32 * WARPS_M, BN = 64 * WARPS_N;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  const T* R = static_cast<const T*>(resid_t);
  T* O = static_cast<T*>(out_t);
  // 16-byte staging loads need 16-byte aligned rows
  const bool vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  switch (epilogue) {
    case EPI_DEQ:
      int8_gemm_kernel<T, EPI_DEQ><<<grid, kThreads, 0, stream>>>(
          x, sx, w, sw, bias, R, resid_f, ln_g, ln_b, O, out_f, out_q, out_s,
          M, N, K, eps, vec);
      break;
    case EPI_RELU:
      int8_gemm_kernel<T, EPI_RELU><<<grid, kThreads, 0, stream>>>(
          x, sx, w, sw, bias, R, resid_f, ln_g, ln_b, O, out_f, out_q, out_s,
          M, N, K, eps, vec);
      break;
    case EPI_RES_LN:
      int8_gemm_kernel<T, EPI_RES_LN><<<grid, kThreads, 0, stream>>>(
          x, sx, w, sw, bias, R, resid_f, ln_g, ln_b, O, out_f, out_q, out_s,
          M, N, K, eps, vec);
      break;
    case EPI_SHIFT:
      int8_gemm_kernel<T, EPI_SHIFT><<<grid, kThreads, 0, stream>>>(
          x, sx, w, sw, bias, R, resid_f, ln_g, ln_b, O, out_f, out_q, out_s,
          M, N, K, eps, vec);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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
// EPI_SHIFT). resid_t (dtype) or resid_f (f32) (M, N) and ln_g / ln_b (N,)
// for EPI_RES_LN (N <= 256). Outputs, each optional: out_t (M, N) in dtype,
// out_f (M, N) f32, out_q (M, N) int8 + out_s (M,) f32 (the codes of the
// LayerNorm output, EPI_RES_LN; the shifted result, EPI_SHIFT).
extern "C" int vs_int8_gemm(const int8_t* x, const float* sx,
                            const int8_t* w, const float* sw,
                            const float* bias, const void* resid_t,
                            const float* resid_f, const float* ln_g,
                            const float* ln_b, void* out_t, float* out_f,
                            int8_t* out_q, float* out_s, int M, int N, int K,
                            int epilogue, int dtype, float eps,
                            void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (epilogue == EPI_RES_LN &&
      ((resid_t == nullptr && resid_f == nullptr) || N > 256))
    return (int)cudaErrorInvalidValue;
  if (epilogue == EPI_SHIFT && out_q == nullptr)
    return (int)cudaErrorInvalidValue;
  if (epilogue != EPI_SHIFT && (sx == nullptr || sw == nullptr ||
                                bias == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((out_q == nullptr) != (out_s == nullptr) && epilogue != EPI_SHIFT)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == vs::kF32)
    err = launch_gemm<float>(x, sx, w, sw, bias, resid_t, resid_f, ln_g,
                             ln_b, out_t, out_f, out_q, out_s, M, N, K,
                             epilogue, eps, s);
  else if (dtype == vs::kBF16)
    err = launch_gemm<__nv_bfloat16>(x, sx, w, sw, bias, resid_t, resid_f,
                                     ln_g, ln_b, out_t, out_f, out_q, out_s,
                                     M, N, K, epilogue, eps, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
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
