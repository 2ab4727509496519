// block_train: the trainable post-LN encoder block's forward and recompute
// backward as a chain of f32 kernels for sm_90a.
//
// Replaces the TPU kernels vidsum_tpu/ops/block_train.py::_fwd_kernel,
// ::_bwd_kernel (one batch element per program, N >= 512),
// ::_fwd_kernel_grouped and ::_bwd_kernel_grouped (G = 1024 // N elements per
// program, N < 512). Every product those kernels compute runs in f32
// (block_train.py:195 pins f32 operands), so here every product is an exact
// f32 FMA (no TF32); bf16 inputs are widened by the caller and the outputs
// rounded by it. The dropout bits are block_train.py::_hash_keep, a pure
// function of (seed, site, absolute batch index, row, column), so the grouped
// and per-element routes draw identical bits and one chain serves both.
//
// Kernels (ops/block_train.py chains them; nothing here allocates):
//   bt_gemm            C = op(A) . op(B) over arbitrary strides, exact f32
//                      FMAs (no TF32), each output summed by one thread
//                      in increasing k order, with the
//                      epilogues bias(+addend), bias -> a1 and dropped ReLU
//                      (site 33), dropout-then-ReLU' (the fc1 backward), and
//                      split-K partials summed in a fixed order by a second
//                      pass (the dW = X^T . dY products over all B*N rows)
//   bt_drop_res_ln     z = drop(p) + r, LayerNorm (sites 32, 34), optionally
//                      keeping xhat and 1/sigma for the backward
//   bt_ln_bwd_drop     LayerNorm backward (_ln_bwd) and the dropped copy
//   bt_colsum          deterministic column sums (bias and LN grads): row
//                      chunks in a fixed partition, then chunks in order
//   attention          attention_core.cuh's FMA family (shared with
//                      attention_train.cu) on the fused QKV buffer, with the
//                      block's hash (site = head): one online pass over the
//                      live key tiles, optionally keeping lse, and the
//                      backward (D = rowsum(dO o O) and dQ per query tile,
//                      dK/dV per key tile looping over the query tiles; P
//                      recomputed from lse)
// No kernel uses atomics, so two runs of the backward give identical bits.
//
// Bound on the card: at (B, N) = (32, 512), d = 256, H = 4 the forward's
// products are 24*B*N*d^2 + 4*d*N*sum(valid keys) ~ 34 GFLOP and the
// backward's 48*B*N*d^2 + 8*d*N*sum(valid) ~ 69 GFLOP (without the recompute)
// against tens of MB of activations: operations-bound, ~0.5 / ~1.0 ms at the
// card's 67 TFLOP/s f32 peak outside the tensor cores, and the four bt_gemm
// products are ~3/4 of it. Design against it: bt_gemm_kernel runs
// fma_gemm.cuh's mainloop (shared with the serving block's f32 products) on 128
// x 128 CTA tiles, 8 x 8 outputs a thread read from shared memory as four
// float4 a k step (16 FMAs a 16-byte load; a warp's reads hit distinct banks or
// broadcast), over k-major tiles 16 deep, double buffered: an operand whose
// rows are contiguous (the dW products' X^T and dY, the dX products' W) arrives
// by 16-byte cp.async, one contiguous along k (the forward's A and W^T) by
// 16-byte loads into registers that are stored transposed after the current
// tile's FMAs, so every tile's loads overlap the previous tile's FMAs with one
// __syncthreads a tile. Launch bounds hold two CTAs an SM (128 registers a
// thread). Other strides or alignments take scalar loads
// through the same pipeline. The dW products split K so that the d x d
// outputs still fill the card (ops/block_train.gemm_splits), with partials
// summed in a fixed order. The attention kernels keep each 64-key score
// tile on chip (nothing of size N x N reaches device memory) in 8 x 8
// register blocks read as float4 from row-major tiles that cp.async streams
// in, over the live key tiles only (attention_core.cuh's note). The
// recompute costs one forward more than the bound counts (the TPU kernel's
// memory footprint).
#include "attention_core.cuh"
#include "fma_gemm.cuh"

namespace {

constexpr int kThreads = 256;

// ----------------------------------------------------------- dropout bits
// block_train.py::_hash_keep, bit for bit (attention_core.cuh's block family)
__device__ __forceinline__ unsigned hash_base(unsigned seed, int site, int b) {
  return vs::attn::hash_base(vs::attn::kHashBlock, seed, b, site);
}

using vs::attn::keep_bit;

// The dropout of one site over (B*N, cols) rows: row m is element m / rows,
// sequence row m % rows.
struct Drop {
  unsigned seed;
  int site;
  int rows;
  unsigned thr;
  float kscale;
};

// ------------------------------------------------------------------ GEMM
// fma_gemm.cuh's mainloop on 128 x 128 tiles (shared with the serving
// block's f32 products)
namespace fg = vs::fma_gemm;
constexpr int GBM = 128, GBN = 128, GBK = fg::GBK;
using fg::kAny;
using fg::kVecK;
using fg::kVecR;

enum Epilogue : int { EPI_BIAS = 0, EPI_RELU_DROP = 1, EPI_DROP_RELU_BWD = 2 };

// C[m, n] = sum_k A[m*sam + k*sak] * B[k*sbk + n*sbn], k over this CTA's
// split [z*kchunk, (z+1)*kchunk) in increasing order (fma_gemm.cuh's
// mainloop: thread (ty, tx) = (tid / 16, tid % 16) holds rows
// {4ty + i, 64 + 4ty + i} and columns {4tx + j, 64 + 4tx + j}, i, j < 4).
// (the scalar-load variant holds one CTA an SM: its address arithmetic
// spills under two)
template <int AMODE, int BMODE>
__global__ void __launch_bounds__(kThreads, AMODE == kAny ? 1 : 2)
bt_gemm_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ bias,
               const float* __restrict__ addend,
               const float* __restrict__ aux, float* __restrict__ C,
               float* __restrict__ C2, float* __restrict__ partial, int M,
               int N, int K, long long sam, long long sak, long long sbk,
               long long sbn, int epi, int kchunk, Drop dr) {
  __shared__ __align__(16) float As[2][GBK][GBM + fg::GPAD];
  __shared__ __align__(16) float Bs[2][GBK][GBN + fg::GPAD];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * GBM, n0 = blockIdx.y * GBN;
  const int kb = blockIdx.z * kchunk;
  const int ke = min(K, kb + kchunk);
  float acc[8][8];
  fg::mainloop<GBM, GBN, 8, AMODE, BMODE>(acc, As, Bs, A, sam, sak, M, m0,
                                          Bm, sbn, sbk, N, n0, kb, ke);

  // four contiguous columns at a time: one float4 store where they are
  // whole and aligned
  const bool vec4 = (N & 3) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i >> 2) * 64 + 4 * ty + (i & 3);
    if (m >= M) continue;
    const unsigned base = hash_base(dr.seed, dr.site, m / dr.rows);
    const int row = m % dr.rows;
#pragma unroll
    for (int jq = 0; jq < 2; ++jq) {
      const int nq = n0 + jq * 64 + 4 * tx;
      if (nq >= N) continue;
      const size_t o = (size_t)m * N + nq;
      float v[4], pre[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = nq + j;
        float x = acc[i][jq * 4 + j];
        if (n < N && partial == nullptr) {
          if (epi == EPI_BIAS) {
            if (bias != nullptr) x += bias[n];
            if (addend != nullptr) x += addend[o + j];
          } else if (epi == EPI_RELU_DROP) {
            x += bias[n];
            pre[j] = x;
            const float r = fmaxf(x, 0.f);
            x = keep_bit(base, row, n, dr.thr) ? r * dr.kscale : 0.f;
          } else {  // EPI_DROP_RELU_BWD
            const float g = keep_bit(base, row, n, dr.thr) ? x * dr.kscale
                                                           : 0.f;
            x = aux[o + j] > 0.f ? g : 0.f;
          }
        }
        v[j] = x;
      }
      float* dst = partial != nullptr
                       ? partial + (size_t)blockIdx.z * M * N + o
                       : C + o;
      const bool keep_pre = partial == nullptr && epi == EPI_RELU_DROP &&
                            C2 != nullptr;
      if (vec4 && nq + 4 <= N) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        if (keep_pre)
          *reinterpret_cast<float4*>(C2 + o) =
              make_float4(pre[0], pre[1], pre[2], pre[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (nq + j >= N) continue;
          dst[j] = v[j];
          if (keep_pre) C2[o + j] = pre[j];
        }
      }
    }
  }
}

template <int AMODE, int BMODE>
void launch_bt_gemm(dim3 grid, cudaStream_t s, const float* A,
                    const float* B, const float* bias, const float* addend,
                    const float* aux, float* C, float* C2, float* partial,
                    int M, int N, int K, long long sam, long long sak,
                    long long sbk, long long sbn, int epi, int kchunk,
                    Drop dr) {
  bt_gemm_kernel<AMODE, BMODE><<<grid, kThreads, 0, s>>>(
      A, B, bias, addend, aux, C, C2, partial, M, N, K, sam, sak, sbk, sbn,
      epi, kchunk, dr);
}

// Sums the split-K partials in split order, then bias and addend.
__global__ void bt_splitk_reduce_kernel(const float* __restrict__ partial,
                                        const float* __restrict__ bias,
                                        const float* __restrict__ addend,
                                        float* __restrict__ C, int M, int N,
                                        int splits) {
  const size_t mn = (size_t)M * N;
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[z * mn + idx];
  if (bias != nullptr) s += bias[idx % N];
  if (addend != nullptr) s += addend[idx];
  C[idx] = s;
}

// ------------------------------------------------------------ row kernels
// One warp per row. Of d <= 1,024 columns, d % 32 == 0: lane l holds
// columns l + 32 t, t < d / 32 <= PER (16 up to d 512, 24 up to d 768, else
// 32: a row's registers sized to the widths in use, each width its own
// instantiation; the wider arrays slowed d 256's rows).
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kMaxPerLane = 32;

template <int PER>
__global__ void __launch_bounds__(kThreads)
bt_drop_res_ln_kernel(const float* __restrict__ p,
                      const float* __restrict__ resid,
                      const float* __restrict__ g,
                      const float* __restrict__ beta, float* __restrict__ out,
                      float* __restrict__ xhat, float* __restrict__ inv_out,
                      int M, int d, float eps, Drop dr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * kRowsPerBlock + warp;
  if (m >= M) return;  // the whole warp leaves together
  const unsigned base = hash_base(dr.seed, dr.site, m / dr.rows);
  const int row = m % dr.rows;
  const int per = d / 32;
  const size_t r0 = (size_t)m * d;
  float z[PER];
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    if (t >= per) break;
    const int c = lane + 32 * t;
    const float v = p[r0 + c];
    z[t] = (keep_bit(base, row, c, dr.thr) ? v * dr.kscale : 0.f) +
           resid[r0 + c];
    s += z[t];
  }
  const float mean = vs::group_sum<32>(s) / (float)d;
  float q = 0.f;
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    if (t >= per) break;
    const float dv = z[t] - mean;
    q += dv * dv;
  }
  const float inv = rsqrtf(vs::group_sum<32>(q) / (float)d + eps);
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    if (t >= per) break;
    const int c = lane + 32 * t;
    const float xh = (z[t] - mean) * inv;
    out[r0 + c] = xh * g[c] + beta[c];
    if (xhat != nullptr) xhat[r0 + c] = xh;
  }
  if (inv_out != nullptr && lane == 0) inv_out[m] = inv;
}

// Rows of any other d (past 1,024, or off the 32-column grid): the same
// arithmetic in the same order, a warp per row walking it from device memory
// in each pass (lane l takes columns l + 32 t, t increasing, c < d); the
// pre-LN row z is kept in out between the passes.
__global__ void __launch_bounds__(kThreads)
bt_drop_res_ln_wide_kernel(const float* __restrict__ p,
                           const float* __restrict__ resid,
                           const float* __restrict__ g,
                           const float* __restrict__ beta, float* out,
                           float* __restrict__ xhat,
                           float* __restrict__ inv_out, int M, int d,
                           float eps, Drop dr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * kRowsPerBlock + warp;
  if (m >= M) return;  // the whole warp leaves together
  const unsigned base = hash_base(dr.seed, dr.site, m / dr.rows);
  const int row = m % dr.rows;
  const size_t r0 = (size_t)m * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v = p[r0 + c];
    const float z = (keep_bit(base, row, c, dr.thr) ? v * dr.kscale : 0.f) +
                    resid[r0 + c];
    out[r0 + c] = z;
    s += z;
  }
  const float mean = vs::group_sum<32>(s) / (float)d;
  float q = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float dv = out[r0 + c] - mean;
    q += dv * dv;
  }
  const float inv = rsqrtf(vs::group_sum<32>(q) / (float)d + eps);
  for (int c = lane; c < d; c += 32) {
    const float xh = (out[r0 + c] - mean) * inv;
    out[r0 + c] = xh * g[c] + beta[c];
    if (xhat != nullptr) xhat[r0 + c] = xh;
  }
  if (inv_out != nullptr && lane == 0) inv_out[m] = inv;
}

// dz = inv * (gg - mean(gg) - xhat * mean(gg * xhat)), gg = dy * g; dmask =
// the site's dropout of dz.
template <int PER>
__global__ void __launch_bounds__(kThreads)
bt_ln_bwd_drop_kernel(const float* __restrict__ dy,
                      const float* __restrict__ xhat,
                      const float* __restrict__ inv,
                      const float* __restrict__ g, float* __restrict__ dz,
                      float* __restrict__ dmask, int M, int d, Drop dr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * kRowsPerBlock + warp;
  if (m >= M) return;
  const unsigned base = hash_base(dr.seed, dr.site, m / dr.rows);
  const int row = m % dr.rows;
  const int per = d / 32;
  const size_t r0 = (size_t)m * d;
  float gg[PER], xh[PER];
  float s = 0.f, sx = 0.f;
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    if (t >= per) break;
    const int c = lane + 32 * t;
    gg[t] = dy[r0 + c] * g[c];
    xh[t] = xhat[r0 + c];
    s += gg[t];
    sx += gg[t] * xh[t];
  }
  const float mean_g = vs::group_sum<32>(s) / (float)d;
  const float mean_gx = vs::group_sum<32>(sx) / (float)d;
  const float iv = inv[m];
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    if (t >= per) break;
    const int c = lane + 32 * t;
    const float v = iv * (gg[t] - mean_g - xh[t] * mean_gx);
    dz[r0 + c] = v;
    dmask[r0 + c] = keep_bit(base, row, c, dr.thr) ? v * dr.kscale : 0.f;
  }
}

// bt_ln_bwd_drop_kernel for rows of any other d, as
// bt_drop_res_ln_wide_kernel walks them
__global__ void __launch_bounds__(kThreads)
bt_ln_bwd_drop_wide_kernel(const float* dy, const float* __restrict__ xhat,
                           const float* __restrict__ inv,
                           const float* __restrict__ g, float* dz,
                           float* __restrict__ dmask, int M, int d, Drop dr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * kRowsPerBlock + warp;
  if (m >= M) return;
  const unsigned base = hash_base(dr.seed, dr.site, m / dr.rows);
  const int row = m % dr.rows;
  const size_t r0 = (size_t)m * d;
  float s = 0.f, sx = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float gg = dy[r0 + c] * g[c];
    s += gg;
    sx += gg * xhat[r0 + c];
  }
  const float mean_g = vs::group_sum<32>(s) / (float)d;
  const float mean_gx = vs::group_sum<32>(sx) / (float)d;
  const float iv = inv[m];
  for (int c = lane; c < d; c += 32) {
    const float gg = dy[r0 + c] * g[c];
    const float v = iv * (gg - mean_g - xhat[r0 + c] * mean_gx);
    dz[r0 + c] = v;
    dmask[r0 + c] = keep_bit(base, row, c, dr.thr) ? v * dr.kscale : 0.f;
  }
}

// ------------------------------------------------------- column sums
// Pass 1: block (32, 8) over 32 columns and kColChunk rows; thread (x, y)
// sums rows y, y + 8, ... of the chunk in order, then the 8 partial sums add
// in order. Pass 2: each column adds its chunks in order.
constexpr int kColChunk = 256;

__global__ void bt_colsum_partial_kernel(const float* __restrict__ A,
                                         const float* __restrict__ Bm,
                                         float* __restrict__ part_sum,
                                         float* __restrict__ part_prod,
                                         int M, int C) {
  __shared__ float red[2][8][32];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  const int r0 = blockIdx.y * kColChunk;
  const int r1 = min(M, r0 + kColChunk);
  float s = 0.f, sp = 0.f;
  if (c < C) {
    for (int r = r0 + ty; r < r1; r += 8) {
      const float a = A[(size_t)r * C + c];
      s += a;
      if (Bm != nullptr) sp += a * Bm[(size_t)r * C + c];
    }
  }
  red[0][ty][tx] = s;
  red[1][ty][tx] = sp;
  __syncthreads();
  if (ty == 0 && c < C) {
    float a = 0.f, b = 0.f;
    for (int y = 0; y < 8; ++y) {
      a += red[0][y][tx];
      b += red[1][y][tx];
    }
    part_sum[(size_t)blockIdx.y * C + c] = a;
    part_prod[(size_t)blockIdx.y * C + c] = b;
  }
}

__global__ void bt_colsum_final_kernel(const float* __restrict__ part_sum,
                                       const float* __restrict__ part_prod,
                                       float* __restrict__ out_sum,
                                       float* __restrict__ out_prod,
                                       int chunks, int C) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  float a = 0.f, b = 0.f;
  for (int k = 0; k < chunks; ++k) {
    a += part_sum[(size_t)k * C + c];
    b += part_prod[(size_t)k * C + c];
  }
  if (out_sum != nullptr) out_sum[c] = a;
  if (out_prod != nullptr) out_prod[c] = b;
}

}  // namespace

extern "C" int vs_bt_gemm(const float* A, const float* B, const float* bias,
                          const float* addend, const float* aux, float* C,
                          float* C2, float* partial, int M, int N, int K,
                          long long sam, long long sak, long long sbk,
                          long long sbn, int epilogue, int splits,
                          unsigned seed, int site, int rows, unsigned thr,
                          float kscale, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits <= 0 || rows <= 0 ||
      epilogue < EPI_BIAS || epilogue > EPI_DROP_RELU_BWD)
    return (int)cudaErrorInvalidValue;
  // split-K partials take the plain epilogue only, applied by the reduction
  if (splits > 1 && (epilogue != EPI_BIAS || partial == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((epilogue == EPI_RELU_DROP && bias == nullptr) ||
      (epilogue == EPI_DROP_RELU_BWD && aux == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kchunk = ((K + splits - 1) / splits + GBK - 1) / GBK * GBK;
  const int z = (K + kchunk - 1) / kchunk;
  const Drop dr{seed, site, rows, thr, kscale};
  const dim3 grid((M + GBM - 1) / GBM, (N + GBN - 1) / GBN, z);
  float* part = splits > 1 ? partial : nullptr;
  const int am = fg::load_mode(A, sam, sak);
  const int bm = fg::load_mode(B, sbn, sbk);
#define VS_BT_GEMM(AM, BM)                                                  \
  launch_bt_gemm<AM, BM>(grid, s, A, B, bias, addend, aux, C, C2, part, M, \
                         N, K, sam, sak, sbk, sbn, epilogue, kchunk, dr)
  // the three layouts the chain uses; any other takes the scalar loads
  if (am == kVecK && bm == kVecK)
    VS_BT_GEMM(kVecK, kVecK);  // the forward: A . W^T
  else if (am == kVecK && bm == kVecR)
    VS_BT_GEMM(kVecK, kVecR);  // dX-type: dY . W
  else if (am == kVecR && bm == kVecR)
    VS_BT_GEMM(kVecR, kVecR);  // dW-type: X^T . dY
  else
    VS_BT_GEMM(kAny, kAny);
#undef VS_BT_GEMM
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t mn = (size_t)M * N;
  bt_splitk_reduce_kernel<<<(unsigned)((mn + kThreads - 1) / kThreads),
                            kThreads, 0, s>>>(partial, bias, addend, C, M, N,
                                              z);
  return (int)cudaGetLastError();
}

extern "C" int vs_bt_drop_res_ln(const float* p, const float* resid,
                                 const float* g, const float* beta,
                                 float* out, float* xhat, float* inv, int M,
                                 int d, int rows, unsigned seed, int site,
                                 unsigned thr, float kscale, float eps,
                                 void* stream) {
  if (M <= 0 || rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const Drop dr{seed, site, rows, thr, kscale};
  const dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 32 || d > 32 * kMaxPerLane)
    bt_drop_res_ln_wide_kernel<<<grid, kThreads, 0, s>>>(
        p, resid, g, beta, out, xhat, inv, M, d, eps, dr);
  else if (d <= 512)
    bt_drop_res_ln_kernel<16><<<grid, kThreads, 0, s>>>(
        p, resid, g, beta, out, xhat, inv, M, d, eps, dr);
  else if (d <= 768)
    bt_drop_res_ln_kernel<24><<<grid, kThreads, 0, s>>>(
        p, resid, g, beta, out, xhat, inv, M, d, eps, dr);
  else
    bt_drop_res_ln_kernel<kMaxPerLane><<<grid, kThreads, 0, s>>>(
        p, resid, g, beta, out, xhat, inv, M, d, eps, dr);
  return (int)cudaGetLastError();
}

extern "C" int vs_bt_ln_bwd_drop(const float* dy, const float* xhat,
                                 const float* inv, const float* g, float* dz,
                                 float* dmask, int M, int d, int rows,
                                 unsigned seed, int site, unsigned thr,
                                 float kscale, void* stream) {
  if (M <= 0 || rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const Drop dr{seed, site, rows, thr, kscale};
  const dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 32 || d > 32 * kMaxPerLane)
    bt_ln_bwd_drop_wide_kernel<<<grid, kThreads, 0, s>>>(
        dy, xhat, inv, g, dz, dmask, M, d, dr);
  else if (d <= 512)
    bt_ln_bwd_drop_kernel<16><<<grid, kThreads, 0, s>>>(
        dy, xhat, inv, g, dz, dmask, M, d, dr);
  else if (d <= 768)
    bt_ln_bwd_drop_kernel<24><<<grid, kThreads, 0, s>>>(
        dy, xhat, inv, g, dz, dmask, M, d, dr);
  else
    bt_ln_bwd_drop_kernel<kMaxPerLane><<<grid, kThreads, 0, s>>>(
        dy, xhat, inv, g, dz, dmask, M, d, dr);
  return (int)cudaGetLastError();
}

// partial holds 2 * ceil(M / 256) * C floats
extern "C" int vs_bt_colsum(const float* A, const float* B, float* partial,
                            float* out_sum, float* out_prod, int M, int C,
                            void* stream) {
  if (M <= 0 || C <= 0 || (out_prod != nullptr && B == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (M + kColChunk - 1) / kColChunk;
  float* part_prod = partial + (size_t)chunks * C;
  bt_colsum_partial_kernel<<<dim3((C + 31) / 32, chunks), dim3(32, 8), 0,
                             s>>>(A, B, partial, part_prod, M, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bt_colsum_final_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      partial, part_prod, out_sum, out_prod, chunks, C);
  return (int)cudaGetLastError();
}

// qkv is the (B*N, 3d) output of the QKV product: head h's q at column
// h*Dh, k at d + h*Dh, v at 2d + h*Dh; o and dO are (B*N, d) with head h at
// column h*Dh; lse and D are (B, H, N).
namespace {

vs::attn::Args qkv_args(const float* qkv, int H, int N, int Dh, float scale,
                        unsigned seed, unsigned thr, float kscale) {
  const int d = H * Dh;
  vs::attn::Args a{};
  a.q = qkv;
  a.k = qkv + d;
  a.v = qkv + 2 * d;
  a.isb = (long long)N * 3 * d;
  a.ish = Dh;
  a.isn = 3 * d;
  a.osb = (long long)N * d;
  a.osh = Dh;
  a.osn = d;
  a.N = N;
  a.H = H;
  a.scale = scale;
  a.seed = seed;
  a.thr = thr;
  a.kscale = kscale;
  a.hash = vs::attn::kHashBlock;
  return a;
}

}  // namespace

// lse may be nullptr (the forward route keeps nothing)
extern "C" int vs_bt_attention_fwd(const float* qkv,
                                   const unsigned char* mask, float* o,
                                   float* lse, int B, int H, int N, int Dh,
                                   float scale, unsigned seed, unsigned thr,
                                   float kscale, void* stream) {
  if (!vs::attn::shape_ok(B, H, N, Dh)) return (int)cudaErrorInvalidValue;
  vs::attn::Args a = qkv_args(qkv, H, N, Dh, scale, seed, thr, kscale);
  a.mask = mask;
  a.out = o;
  a.lse = lse;
  return (int)vs::attn::launch_fwd_dh(
      a, B, Dh, static_cast<cudaStream_t>(stream));
}

// D is (B, H, N) scratch; dqkv is (B*N, 3d) like qkv
extern "C" int vs_bt_attention_bwd(const float* qkv, const float* o,
                                   const float* dO, const float* lse,
                                   const unsigned char* mask, float* D,
                                   float* dqkv, int B, int H, int N, int Dh,
                                   float scale, unsigned seed, unsigned thr,
                                   float kscale, void* stream) {
  if (!vs::attn::shape_ok(B, H, N, Dh)) return (int)cudaErrorInvalidValue;
  const int d = H * Dh;
  vs::attn::Args a = qkv_args(qkv, H, N, Dh, scale, seed, thr, kscale);
  a.o = o;
  a.dO = dO;
  a.mask = mask;
  a.lse = const_cast<float*>(lse);  // read only by the backward
  a.D = D;
  a.dq = dqkv;
  a.dk = dqkv + d;
  a.dv = dqkv + 2 * d;
  a.d_from_o = 1;
  return (int)vs::attn::launch_bwd_dh(
      a, B, Dh, static_cast<cudaStream_t>(stream));
}
