// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel computes in f32 registers and reads/writes its activations in
// the caller's dtype: float (dtype code 0) or __nv_bfloat16 (dtype code 1).
// bf16 -> f32 is exact, f32 -> bf16 rounds to nearest even, the same rounding
// torch's and XLA's casts use, so a value rounded here equals the value the
// plain PyTorch version rounds at the same point.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vs {

enum DType : int { kF32 = 0, kBF16 = 1 };

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Round an f32 value to T and back: the value a T-typed operand carries.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// Sum / max over the `width` neighbouring lanes that share a row (width is a
// power of two that divides 32; the lanes of one group are contiguous).
template <int width>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = width / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int width>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = width / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// D += A.B on the bf16 tensor cores, one m16n8k16 tile per warp, f32
// accumulate. Fragment layouts (PTX ISA, mma.m16n8k16 .bf16), with
// g = lane / 4 and t = lane % 4, two bf16 per 32-bit register, the lower
// index in the low half:
//   A (16 x 16, row-major):  a0 = A[g][2t..2t+1]    a1 = A[g+8][2t..2t+1]
//                            a2 = A[g][2t+8..+9]    a3 = A[g+8][2t+8..+9]
//   B (16 x 8, k x n):       b0 = B[2t..2t+1][g]    b1 = B[2t+8..+9][g]
//   C/D (16 x 8, f32):       d0,d1 = D[g][2t..2t+1] d2,d3 = D[g+8][2t..2t+1]
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Two consecutive bf16 in shared memory as one 32-bit fragment register.
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The B fragment of a 16 x 8 (k x n) tile that is stored n-contiguous in
// shared memory (row k holds n): lanes 0-7 give the addresses of rows
// k0..k0+7 at column n0, lanes 8-15 those of rows k0+8..k0+15 (lanes 16-31
// must give valid addresses too); the transposing load hands every lane its
// b0 = B[2t..2t+1][g] and b1 = B[2t+8..+9][g].
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1,
                                                  const __nv_bfloat16* row) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(addr));
}

// Two f32 values rounded to bf16 and packed (lo = first).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D += A.B on the int8 tensor cores, one m16n8k32 tile per warp, exact s32
// accumulate. The byte layout of the fragments is the bf16 m16n8k16 one with
// four int8 per register in place of two bf16 (PTX ISA, mma.m16n8k32 .s8):
//   A (16 x 32, row-major):  a0 = A[g][4t..4t+3]     a1 = A[g+8][4t..4t+3]
//                            a2 = A[g][4t+16..+19]   a3 = A[g+8][4t+16..+19]
//   B (32 x 8, k x n):       b0 = B[4t..4t+3][g]     b1 = B[4t+16..+19][g]
//   C/D (16 x 8, s32):       d0,d1 = D[g][2t..2t+1]  d2,d3 = D[g+8][2t..2t+1]
// so a K-contiguous row of A or of B^T (nn.Linear's (out, in) weight) gives
// every register as one aligned 32-bit load.
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The int8 scheme of vidsum_tpu/ops/quant.py::quantize_rows, step for step:
// scale = absmax / 127 where absmax > 0, else 1; codes = clip(round(x *
// (1 / scale)), -127, 127) with round half to even. Every operation is
// IEEE-rounded on its own (__fdiv_rn, __fmul_rn; no FMA contraction, no fast
// math), so the codes equal the plain PyTorch version's bit for bit.
__device__ __forceinline__ float quant_scale(float absmax) {
  return absmax > 0.f ? __fdiv_rn(absmax, 127.f) : 1.f;
}

__device__ __forceinline__ int8_t quant_code(float x, float inv_scale) {
  const float r = rintf(__fmul_rn(x, inv_scale));
  return static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
}

// The dequantised product of the int8 path: acc * (sx * sw) + b, rounded
// after each operation as the plain version's separate tensor ops round.
__device__ __forceinline__ float dequant(int acc, float sx, float sw,
                                         float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), __fmul_rn(sx, sw)), b);
}


// The residual + LayerNorm epilogue of rows that do not lie in one GEMM CTA
// tile (d > 256: d_model 384 and up; any d in the f32 GEMM): the
// GEMM writes the f32 pre-LN rows z = acc (+ dequantised) + bias + residual
// into y, then one warp per row takes the f32 LayerNorm (mean, biased variance,
// eps; block_kernel.py::_layernorm_f32) in place, each operation IEEE-rounded
// on its own, and writes the row in T (out_t, optional) and its int8 codes and
// scale (out_q, out_s, optional; quantize_rows' scheme). A row's sums run in a
// fixed order, so its result does not depend on M.
constexpr int kLnRowsPerBlock = 8;
constexpr int kLnMaxPerLane = 32;  // d <= 1024; wider rows loop

// PER values a lane: 16 up to d 512, 24 up to d 768, else 32 (a row's
// registers sized to the widths in use: each width keeps its own
// instantiation, so the narrower rows compile as they did before the wider
// ones were added)
template <typename T, int PER>
__global__ void __launch_bounds__(32 * kLnRowsPerBlock)
layernorm_rows_kernel(float* __restrict__ y, const float* __restrict__ g,
                      const float* __restrict__ beta, T* __restrict__ out_t,
                      int8_t* __restrict__ out_q, float* __restrict__ out_s,
                      int M, int N, float eps) {
  const int row = blockIdx.x * kLnRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;  // whole warps leave together
  float* yr = y + (size_t)row * N;
  float z[PER];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = lane + 32 * j;
    z[j] = c < N ? yr[c] : 0.f;
    s = __fadd_rn(s, z[j]);
  }
  const float mean = __fdiv_rn(group_sum<32>(s), (float)N);
  float v = 0.f;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const float d = __fsub_rn(z[j], mean);
    if (lane + 32 * j < N) v = __fadd_rn(v, __fmul_rn(d, d));
  }
  const float inv = __fdiv_rn(
      1.f, __fsqrt_rn(__fadd_rn(__fdiv_rn(group_sum<32>(v), (float)N), eps)));
  float mx = 0.f;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = lane + 32 * j;
    if (c >= N) continue;
    z[j] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(z[j], mean), inv), g[c]),
                     beta[c]);
    yr[c] = z[j];
    if (out_t != nullptr) out_t[(size_t)row * N + c] = from_f32<T>(z[j]);
    mx = fmaxf(mx, fabsf(z[j]));
  }
  if (out_q == nullptr) return;
  const float scale = quant_scale(group_max<32>(mx));
  const float qinv = __fdiv_rn(1.f, scale);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = lane + 32 * j;
    if (c < N) out_q[(size_t)row * N + c] = quant_code(z[j], qinv);
  }
  if (lane == 0) out_s[row] = scale;
}

// Rows past 32 * kLnMaxPerLane columns: the same operations in the same
// order, a warp per row, each pass walking the row from device memory (the
// pre-LN row is in y, normalised in place by the third pass): lane l takes
// columns l + 32 j in increasing j in every pass (sum, squared deviations,
// normalise and write, codes), then the lanes' sums meet in the same
// butterfly, so a row's result does not depend on M.
template <typename T>
__global__ void __launch_bounds__(32 * kLnRowsPerBlock)
layernorm_rows_wide_kernel(float* __restrict__ y, const float* __restrict__ g,
                           const float* __restrict__ beta,
                           T* __restrict__ out_t, int8_t* __restrict__ out_q,
                           float* __restrict__ out_s, int M, int N,
                           float eps) {
  const int row = blockIdx.x * kLnRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;  // whole warps leave together
  float* yr = y + (size_t)row * N;
  float s = 0.f;
  for (int c = lane; c < N; c += 32) s = __fadd_rn(s, yr[c]);
  const float mean = __fdiv_rn(group_sum<32>(s), (float)N);
  float v = 0.f;
  for (int c = lane; c < N; c += 32) {
    const float d = __fsub_rn(yr[c], mean);
    v = __fadd_rn(v, __fmul_rn(d, d));
  }
  const float inv = __fdiv_rn(
      1.f, __fsqrt_rn(__fadd_rn(__fdiv_rn(group_sum<32>(v), (float)N), eps)));
  float mx = 0.f;
  for (int c = lane; c < N; c += 32) {
    const float z = __fadd_rn(
        __fmul_rn(__fmul_rn(__fsub_rn(yr[c], mean), inv), g[c]), beta[c]);
    yr[c] = z;
    if (out_t != nullptr) out_t[(size_t)row * N + c] = from_f32<T>(z);
    mx = fmaxf(mx, fabsf(z));
  }
  if (out_q == nullptr) return;
  const float scale = quant_scale(group_max<32>(mx));
  const float qinv = __fdiv_rn(1.f, scale);
  for (int c = lane; c < N; c += 32)
    out_q[(size_t)row * N + c] = quant_code(yr[c], qinv);
  if (lane == 0) out_s[row] = scale;
}

template <typename T>
cudaError_t launch_layernorm_rows(float* y, const float* g, const float* beta,
                                  void* out_t, int8_t* out_q, float* out_s,
                                  int M, int N, float eps,
                                  cudaStream_t stream) {
  const dim3 grid((M + kLnRowsPerBlock - 1) / kLnRowsPerBlock);
  if (N > 32 * kLnMaxPerLane)
    layernorm_rows_wide_kernel<T><<<grid, 32 * kLnRowsPerBlock, 0, stream>>>(
        y, g, beta, static_cast<T*>(out_t), out_q, out_s, M, N, eps);
  else if (N <= 512)
    layernorm_rows_kernel<T, 16><<<grid, 32 * kLnRowsPerBlock, 0, stream>>>(
        y, g, beta, static_cast<T*>(out_t), out_q, out_s, M, N, eps);
  else if (N <= 768)
    layernorm_rows_kernel<T, 24><<<grid, 32 * kLnRowsPerBlock, 0, stream>>>(
        y, g, beta, static_cast<T*>(out_t), out_q, out_s, M, N, eps);
  else
    layernorm_rows_kernel<T, kLnMaxPerLane>
        <<<grid, 32 * kLnRowsPerBlock, 0, stream>>>(
            y, g, beta, static_cast<T*>(out_t), out_q, out_s, M, N, eps);
  return cudaGetLastError();
}

}  // namespace vs

// Each library exports the runtime's message for the error codes its launch
// functions return (ops/_cuda.py reads it when a launch fails).
extern "C" const char* vs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
