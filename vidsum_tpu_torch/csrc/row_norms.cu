// row_norms: PGL-SUM's row-wise steps between its products, for sm_90a, in
// exact f32 (no fast math):
//
//   fuse    out = LN(a / max(|a|_2, 1e-12) + b / max(|b|_2, 1e-12) + x)
//           (the global and local branches L2-normalised and added, fusion
//           "add", the residual, then LayerNorm norm_y)
//   ln      a = LN(a), in place  (norm_linear, after the GEMM's ReLU)
//
// LN is common.cuh's layernorm_rows_kernel, the serving GEMMs' LayerNorm
// rows (mean, biased variance, eps), on the fused rows l2_fuse_kernel
// writes. PGL-SUM has no TPU kernel; these steps are the published model's
// torch ops (F.normalize, nn.LayerNorm).
//
// Bound on the card: memory. fuse reads three f32 rows and writes one, and
// the LayerNorm reads and writes it again: 24 KB a row at d 1,024, a
// 14,400-row video in 0.1 ms at 3.35 TB/s. One warp a row holds its 1,024
// values in registers (32 a lane); every operation is IEEE-rounded on its
// own and a row's sums run in a fixed order (a lane's columns in increasing
// order, then the butterfly), so a row's result does not depend on M: a
// video scores the same alone and in a batch.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kPer = 32;  // d <= 1,024

__device__ __forceinline__ float l2_denominator(const float (&v)[kPer]) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) s = __fadd_rn(s, __fmul_rn(v[j], v[j]));
  return fmaxf(__fsqrt_rn(vs::group_sum<32>(s)), 1e-12f);
}

__global__ void __launch_bounds__(32 * kRowsPerBlock)
    l2_fuse_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ x, float* __restrict__ out,
                   int M, int N) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;  // whole warps leave together
  const size_t r0 = (size_t)row * N;
  float u[kPer], w[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = lane + 32 * j;
    u[j] = c < N ? a[r0 + c] : 0.f;
    w[j] = c < N ? b[r0 + c] : 0.f;
  }
  const float nu = l2_denominator(u), nw = l2_denominator(w);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = lane + 32 * j;
    if (c < N)
      out[r0 + c] = __fadd_rn(
          __fadd_rn(__fdiv_rn(u[j], nu), __fdiv_rn(w[j], nw)), x[r0 + c]);
  }
}

}  // namespace

// a, b, x, out: (M, N) contiguous f32 rows; g, beta: (N,) f32. fuse:
// out = LN(fused a, b, x); else a = LN(a) in place (b, x, out unread).
// N <= 1,024.
extern "C" int vs_row_norms(float* a, const float* b, const float* x,
                            const float* g, const float* beta, float* out,
                            int M, int N, int fuse, float eps, void* stream) {
  if (M <= 0 || N <= 0 || N > 32 * kPer) return (int)cudaErrorInvalidValue;
  if (fuse && (b == nullptr || x == nullptr || out == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* y = a;
  if (fuse) {
    l2_fuse_kernel<<<(M + kRowsPerBlock - 1) / kRowsPerBlock,
                     32 * kRowsPerBlock, 0, s>>>(a, b, x, out, M, N);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    y = out;
  }
  return (int)vs::launch_layernorm_rows<float>(y, g, beta, nullptr, nullptr,
                                               nullptr, M, N, eps, s);
}
