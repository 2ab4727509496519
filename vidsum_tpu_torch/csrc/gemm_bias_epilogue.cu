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
// block_kernel.py::_layernorm_f32 does. A row of d <= 256 lies in one CTA
// tile, so its statistics never leave the CTA; a wider row (d 512) is
// written pre-LN in f32 by the GEMM (EPI_RES, y = acc + b + residual, into
// out_f) and normalised in place by common.cuh's layernorm_rows_kernel, the
// same f32 math in a second launch.
//
// Layouts: X (M, K) row-major in T; W (N, K) row-major in T (nn.Linear's
// weight layout); bias, LN scale/shift and an f32 residual in f32; a T
// residual in T. Outputs: out_t (M, N) in T and/or out_f (M, N) in f32,
// either may be null. Every output element is summed in a fixed k order by
// one thread (f32) or one mma lane (bf16), so a row's result does not depend
// on M or on the other rows (served scores equal solo scores bit for bit).
//
// Bound on the card: at the flagship block (B=32, N=512, d=256) the four
// products are 24*d^2*B*N = 25.8 GFLOP against ~18 MB of operands, far above
// the H100's ~295 FLOP/byte ridge, so the bound is operations: ~26 us at the
// bf16 tensor-core peak. Design against it: bf16 runs on the tensor cores
// (mma.sync m16n8k16, f32 accumulate) from padded shared-memory tiles whose
// fragment loads are bank-conflict-free; f32 stays exact (no TF32) on the
// FMA units (67 TFLOP/s peak) with a register-blocked tiled kernel. The bf16
// kernel prefetches the next K tile into registers; multi-stage cp.async /
// TMA pipelines and wgmma are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBK = 16;
// FMA tile: each warp TM rows, each lane TN columns of a (8 TM) x (32 TN)
// CTA tile; the 256 columns hold a whole LayerNorm row of every d_model in
// the repo
constexpr int TM = 8, TN = 8;

enum Epilogue : int { EPI_NONE = 0, EPI_RELU = 1, EPI_RES_LN = 2,
                      EPI_RES = 3 /* internal: the pre-LN row */ };

template <typename T, int EPI>
__global__ void __launch_bounds__(kThreads)
gemm_bias_epilogue_kernel(const T* __restrict__ X, const T* __restrict__ W,
                          const float* __restrict__ bias,
                          const T* __restrict__ resid_t,
                          const float* __restrict__ resid_f,
                          const float* __restrict__ ln_g,
                          const float* __restrict__ ln_b,
                          T* __restrict__ out_t, float* __restrict__ out_f,
                          int M, int N, int K, float eps) {
  constexpr int BM = 8 * TM;
  constexpr int BN = 32 * TN;
  // k-major tiles, padded by one column so the transposing stores spread
  // over the banks
  __shared__ float Xs[kBK][BM + 1];
  __shared__ float Ws[kBK][BN + 1];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int idx = threadIdx.x; idx < BM * kBK; idx += kThreads) {
      const int r = idx / kBK, c = idx % kBK;
      const int gm = m0 + r, gk = k0 + c;
      Xs[c][r] = (gm < M && gk < K) ? vs::to_f32<T>(X[(size_t)gm * K + gk])
                                    : 0.f;
    }
    for (int idx = threadIdx.x; idx < BN * kBK; idx += kThreads) {
      const int r = idx / kBK, c = idx % kBK;
      const int gn = n0 + r, gk = k0 + c;
      Ws[c][r] = (gn < N && gk < K) ? vs::to_f32<T>(W[(size_t)gn * K + gk])
                                    : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = Xs[kk][warp * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Ws[kk][lane + 32 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    // row is the same for the whole warp, so the shuffles below never diverge
    const int row = m0 + warp * TM + i;
    const bool row_ok = row < M;
    float y[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + lane + 32 * j;
      y[j] = col < N ? acc[i][j] + bias[col] : 0.f;
      if (EPI == EPI_RELU) y[j] = fmaxf(y[j], 0.f);
    }
    if (EPI == EPI_RES_LN || EPI == EPI_RES) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = n0 + lane + 32 * j;
        if (col < N && row_ok) {
          const size_t o = (size_t)row * N + col;
          y[j] += resid_f != nullptr ? resid_f[o] : vs::to_f32<T>(resid_t[o]);
        }
      }
    }
    if (EPI == EPI_RES_LN) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) s += n0 + lane + 32 * j < N ? y[j] : 0.f;
      const float mean = vs::group_sum<32>(s) / (float)N;
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = n0 + lane + 32 * j;
        const float dlt = y[j] - mean;
        v += col < N ? dlt * dlt : 0.f;
      }
      const float var = vs::group_sum<32>(v) / (float)N;
      const float inv = 1.f / sqrtf(var + eps);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = n0 + lane + 32 * j;
        if (col < N) y[j] = (y[j] - mean) * inv * ln_g[col] + ln_b[col];
      }
    }
    if (!row_ok) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + lane + 32 * j;
      if (col >= N) continue;
      const size_t o = (size_t)row * N + col;
      if (out_f != nullptr) out_f[o] = y[j];
      if (out_t != nullptr) out_t[o] = vs::from_f32<T>(y[j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores. A CTA of 8 warps (WARPS_M x WARPS_N) computes a
// (32*WARPS_M) x (64*WARPS_N) tile; each warp a 32 x 64 block as 2 x 8
// m16n8k16 products per 16-deep k step. X and W tiles are staged in shared
// memory 32 deep, K contiguous, rows padded by 8 bf16 (20 words), so every
// fragment load of a warp hits 32 distinct banks; the next tile's global
// loads are issued into registers before the current tile's products, so
// they are in flight while the tensor cores work. The epilogue is the FMA
// kernel's; the LayerNorm's row sums add within a thread, across the four
// lanes of a row (shuffles), then across the WARPS_N warps of the row
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
                     float* __restrict__ out_f, int M, int N, int K,
                     float eps, bool vec) {
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
      const __nv_bfloat16* src = (is_x ? X : W) + (size_t)grow * K + k0 + kc;
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

cudaError_t launch_mma(const void* x, const void* w, const float* bias,
                       const void* resid_t, const float* resid_f,
                       const float* ln_g, const float* ln_b, void* out_t,
                       float* out_f, int M, int N, int K, int epilogue,
                       float eps, cudaStream_t stream) {
  constexpr int BM = 32 * WARPS_M, BN = 64 * WARPS_N;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  using bf = __nv_bfloat16;
  const bf* X = static_cast<const bf*>(x);
  const bf* Wt = static_cast<const bf*>(w);
  const bf* R = static_cast<const bf*>(resid_t);
  bf* O = static_cast<bf*>(out_t);
  // 16-byte staging loads need 16-byte aligned rows
  const bool vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  switch (epilogue) {
    case EPI_NONE:
      gemm_bf16_mma_kernel<EPI_NONE>
          <<<grid, kThreads, 0, stream>>>(X, Wt, bias, R, resid_f, ln_g, ln_b,
                                          O, out_f, M, N, K, eps, vec);
      break;
    case EPI_RELU:
      gemm_bf16_mma_kernel<EPI_RELU>
          <<<grid, kThreads, 0, stream>>>(X, Wt, bias, R, resid_f, ln_g, ln_b,
                                          O, out_f, M, N, K, eps, vec);
      break;
    case EPI_RES_LN:
      gemm_bf16_mma_kernel<EPI_RES_LN>
          <<<grid, kThreads, 0, stream>>>(X, Wt, bias, R, resid_f, ln_g, ln_b,
                                          O, out_f, M, N, K, eps, vec);
      break;
    case EPI_RES:
      gemm_bf16_mma_kernel<EPI_RES>
          <<<grid, kThreads, 0, stream>>>(X, Wt, bias, R, resid_f, ln_g, ln_b,
                                          O, out_f, M, N, K, eps, vec);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tiles(const void* x, const void* w, const float* bias,
                         const void* resid_t, const float* resid_f,
                         const float* ln_g, const float* ln_b, void* out_t,
                         float* out_f, int M, int N, int K, int epilogue,
                         float eps, cudaStream_t stream) {
  constexpr int BM = 8 * TM, BN = 32 * TN;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  const T* X = static_cast<const T*>(x);
  const T* Wt = static_cast<const T*>(w);
  const T* R = static_cast<const T*>(resid_t);
  T* O = static_cast<T*>(out_t);
  switch (epilogue) {
    case EPI_NONE:
      gemm_bias_epilogue_kernel<T, EPI_NONE><<<grid, kThreads, 0, stream>>>(
          X, Wt, bias, R, resid_f, ln_g, ln_b, O, out_f, M, N, K, eps);
      break;
    case EPI_RELU:
      gemm_bias_epilogue_kernel<T, EPI_RELU><<<grid, kThreads, 0, stream>>>(
          X, Wt, bias, R, resid_f, ln_g, ln_b, O, out_f, M, N, K, eps);
      break;
    case EPI_RES_LN:
      gemm_bias_epilogue_kernel<T, EPI_RES_LN><<<grid, kThreads, 0, stream>>>(
          X, Wt, bias, R, resid_f, ln_g, ln_b, O, out_f, M, N, K, eps);
      break;
    case EPI_RES:
      gemm_bias_epilogue_kernel<T, EPI_RES><<<grid, kThreads, 0, stream>>>(
          X, Wt, bias, R, resid_f, ln_g, ln_b, O, out_f, M, N, K, eps);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int vs_gemm_bias_epilogue(const void* x, const void* w,
                                     const float* bias, const void* resid_t,
                                     const float* resid_f, const float* ln_g,
                                     const float* ln_b, void* out_t,
                                     float* out_f, int M, int N, int K,
                                     int epilogue, int dtype, float eps,
                                     void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || epilogue < EPI_NONE ||
      epilogue > EPI_RES_LN)
    return (int)cudaErrorInvalidValue;
  if (epilogue == EPI_RES_LN && resid_t == nullptr && resid_f == nullptr)
    return (int)cudaErrorInvalidValue;
  // a LayerNorm row wider than the 256-column CTA tile goes through out_f
  // (required) and a row kernel
  const bool wide = epilogue == EPI_RES_LN && N > 256;
  if (wide && (N > 32 * vs::kLnMaxPerLane || out_f == nullptr))
    return (int)cudaErrorInvalidValue;
  const int epi = wide ? EPI_RES : epilogue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == vs::kF32)
    err = launch_tiles<float>(x, w, bias, resid_t, resid_f, ln_g, ln_b,
                              wide ? nullptr : out_t, out_f, M, N, K, epi,
                              eps, s);
  else if (dtype == vs::kBF16)
    err = launch_mma(x, w, bias, resid_t, resid_f, ln_g, ln_b,
                     wide ? nullptr : out_t, out_f, M, N, K, epi, eps, s);
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
