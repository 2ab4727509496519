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
//   bt_gemm            C = op(A) . op(B) over arbitrary strides, with the
//                      epilogues bias(+addend), bias -> a1 and dropped ReLU
//                      (site 33), dropout-then-ReLU' (the fc1 backward), and
//                      split-K partials summed in a fixed order by a second
//                      pass (the dW = X^T . dY products over all B*N rows)
//   bt_drop_res_ln     z = drop(p) + r, LayerNorm (sites 32, 34), optionally
//                      keeping xhat and 1/sigma for the backward
//   bt_ln_bwd_drop     LayerNorm backward (_ln_bwd) and the dropped copy
//   bt_colsum          deterministic column sums (bias and LN grads): row
//                      chunks in a fixed partition, then chunks in order
//   bt_attn_fwd        masked attention with hash dropout on P (site = head),
//                      two passes over 64-key tiles: row max/sum, then P.V;
//                      optionally keeps the row max and sum
//   bt_attn_dq /       the attention backward: D = rowsum(dO o O) and dQ per
//   bt_attn_dkdv       query tile, dK/dV per key tile looping over the query
//                      tiles; P is recomputed from the kept row max and sum
// No kernel uses atomics, so two runs of the backward give identical bits.
//
// Bound on the card: at (B, N) = (32, 512), d = 256, H = 4 the forward's
// products are 24*B*N*d^2 + 4*d*N*sum(valid keys) ~ 34 GFLOP and the
// backward's 48*B*N*d^2 + 8*d*N*sum(valid) ~ 69 GFLOP (without the recompute)
// against tens of MB of activations: operations-bound, ~0.5 / ~1.0 ms at the
// card's 67 TFLOP/s f32 peak outside the tensor cores. Design against it: the
// GEMM is register-blocked (8 x 8 per thread, 128 x 128 CTA tiles, 16-deep
// k-tiles in shared memory) and splits K for the dW products so that the
// d x d outputs still fill the card; the attention kernels keep each N x N
// score tile on chip (nothing of size N x N reaches device memory) with 4 x 4
// register blocks over transposed, padded shared-memory tiles. The recompute
// costs one forward more than the bound counts (the TPU kernel's memory
// footprint); no load is overlapped with compute yet.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// ----------------------------------------------------------- dropout bits
// block_train.py::_hash_keep, bit for bit: uint32 arithmetic that wraps.
__device__ __forceinline__ unsigned hash_base(unsigned seed, int site, int b) {
  return seed * 0x9E3779B1u + (unsigned)(site * 131071 + 17) * 0x85EBCA77u +
         (unsigned)(b + 1) * 0x27220A95u;
}

__device__ __forceinline__ bool keep_bit(unsigned base, int row, int col,
                                         unsigned thr) {
  unsigned x = base ^ ((unsigned)row * 0xC2B2AE3Du) ^
               ((unsigned)col * 0x27D4EB2Fu);
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= thr;
}

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
constexpr int GBM = 128, GBN = 128, GBK = 16, GPAD = 4;

enum Epilogue : int { EPI_BIAS = 0, EPI_RELU_DROP = 1, EPI_DROP_RELU_BWD = 2 };

// C[m, n] = sum_k A[m*sam + k*sak] * B[k*sbk + n*sbn], k over this CTA's
// split [z*kchunk, (z+1)*kchunk); a thread holds rows 8*rg..8*rg+7 and
// columns cg + 16*j of the tile.
__global__ void __launch_bounds__(kThreads)
bt_gemm_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ bias,
               const float* __restrict__ addend,
               const float* __restrict__ aux, float* __restrict__ C,
               float* __restrict__ C2, float* __restrict__ partial, int M,
               int N, int K, long long sam, long long sak, long long sbk,
               long long sbn, int epi, int kchunk, Drop dr) {
  __shared__ float As[GBK][GBM + GPAD];
  __shared__ float Bs[GBK][GBN + GPAD];
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int m0 = blockIdx.x * GBM, n0 = blockIdx.y * GBN;
  const int kb = blockIdx.z * kchunk;
  const int ke = min(K, kb + kchunk);
  const bool a_k_contig = sak == 1;
  const bool b_n_contig = sbn == 1;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += GBK) {
    // neighbouring threads read neighbouring addresses of each operand
    for (int e = tid; e < GBM * GBK; e += kThreads) {
      const int r = a_k_contig ? e / GBK : e % GBM;
      const int c = a_k_contig ? e % GBK : e / GBM;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < ke) ? A[gm * sam + gk * sak] : 0.f;
    }
    for (int e = tid; e < GBN * GBK; e += kThreads) {
      const int n = b_n_contig ? e % GBN : e / GBK;
      const int c = b_n_contig ? e / GBN : e % GBK;
      const int gn = n0 + n, gk = k0 + c;
      Bs[c][n] = (gn < N && gk < ke) ? Bm[gk * sbk + gn * sbn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[kk][rg * 8 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[kk][cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + rg * 8 + i;
    if (m >= M) continue;
    const unsigned base = hash_base(dr.seed, dr.site, m / dr.rows);
    const int row = m % dr.rows;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + cg + 16 * j;
      if (n >= N) continue;
      const size_t o = (size_t)m * N + n;
      float v = acc[i][j];
      if (partial != nullptr) {
        partial[(size_t)blockIdx.z * M * N + o] = v;
      } else if (epi == EPI_BIAS) {
        if (bias != nullptr) v += bias[n];
        if (addend != nullptr) v += addend[o];
        C[o] = v;
      } else if (epi == EPI_RELU_DROP) {
        v += bias[n];
        if (C2 != nullptr) C2[o] = v;
        const float r = fmaxf(v, 0.f);
        C[o] = keep_bit(base, row, n, dr.thr) ? r * dr.kscale : 0.f;
      } else {  // EPI_DROP_RELU_BWD
        const float g = keep_bit(base, row, n, dr.thr) ? v * dr.kscale : 0.f;
        C[o] = aux[o] > 0.f ? g : 0.f;
      }
    }
  }
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
// One warp per row of d <= 256 columns (d % 32 == 0): lane l holds columns
// l + 32 t.
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kMaxPerLane = 8;

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
  float z[kMaxPerLane];
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < kMaxPerLane; ++t) {
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
  for (int t = 0; t < kMaxPerLane; ++t) {
    if (t >= per) break;
    const float dv = z[t] - mean;
    q += dv * dv;
  }
  const float inv = rsqrtf(vs::group_sum<32>(q) / (float)d + eps);
#pragma unroll
  for (int t = 0; t < kMaxPerLane; ++t) {
    if (t >= per) break;
    const int c = lane + 32 * t;
    const float xh = (z[t] - mean) * inv;
    out[r0 + c] = xh * g[c] + beta[c];
    if (xhat != nullptr) xhat[r0 + c] = xh;
  }
  if (inv_out != nullptr && lane == 0) inv_out[m] = inv;
}

// dz = inv * (gg - mean(gg) - xhat * mean(gg * xhat)), gg = dy * g; dmask =
// the site's dropout of dz.
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
  float gg[kMaxPerLane], xh[kMaxPerLane];
  float s = 0.f, sx = 0.f;
#pragma unroll
  for (int t = 0; t < kMaxPerLane; ++t) {
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
  for (int t = 0; t < kMaxPerLane; ++t) {
    if (t >= per) break;
    const int c = lane + 32 * t;
    const float v = iv * (gg[t] - mean_g - xh[t] * mean_gx);
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

// -------------------------------------------------------------- attention
// qkv is the (B*N, 3d) output of the QKV product: head h's q at column
// h*DH, k at d + h*DH, v at 2d + h*DH. The attention output o and its
// cotangent dO are (B*N, d) with head h at column h*DH. Row statistics
// (max, sum, D) are (B, H, N). A CTA of 256 threads takes a 64 x 64 tile of
// scores; thread (rg, cg) = (tid / 16, tid % 16) holds rows 4 rg + i and
// columns cg + 16 j. Tiles of Q/K/V/dO are stored transposed ([DH][kPad]) so
// every read in the inner loops is a broadcast or conflict-free.
constexpr int kT = 64;
constexpr int kPad = 65;

// stage rows r0.. of a (rows, ld) matrix's columns col..col+DH into a
// transposed tile dst[c * kPad + r]
template <int DH>
__device__ __forceinline__ void stage_t(float* dst, const float* src,
                                        long long ld, int r0, int col) {
  for (int e = threadIdx.x; e < kT * DH; e += kThreads) {
    const int r = e / DH, c = e % DH;
    dst[c * kPad + r] = src[(long long)(r0 + r) * ld + col + c];
  }
}

template <int DH>
constexpr int fwd_smem_floats() {
  return 2 * DH * kPad + kT * DH + kT * kPad + kT;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
bt_attn_fwd_kernel(const float* __restrict__ qkv,
                   const unsigned char* __restrict__ mask,
                   float* __restrict__ o, float* __restrict__ m_out,
                   float* __restrict__ l_out, int N, int H, float scale,
                   unsigned seed, unsigned thr, float kscale, int full) {
  constexpr int DPT = DH / 16;
  extern __shared__ float smem[];
  float* Qt = smem;                // [DH][kPad]
  float* Kt = Qt + DH * kPad;      // [DH][kPad]
  float* Vs = Kt + DH * kPad;      // [kT][DH]
  float* Pt = Vs + kT * DH;        // [key][query], kPad
  float* Km = Pt + kT * kPad;      // key mask as 0/1

  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int d = H * DH;
  const long long ld = 3LL * d;
  const float* rows = qkv + (long long)b * N * ld;
  const unsigned char* mrow = mask + (long long)b * N;
  const unsigned base = hash_base(seed, h, b);

  stage_t<DH>(Qt, rows, ld, q0, h * DH);

  auto stage_keys = [&](int k0, bool with_v) {
    __syncthreads();  // the previous tile's readers are done
    stage_t<DH>(Kt, rows, ld, k0, d + h * DH);
    if (with_v)
      for (int e = tid; e < kT * DH; e += kThreads) {
        const int r = e / DH, c = e % DH;
        Vs[r * DH + c] = rows[(long long)(k0 + r) * ld + 2 * d + h * DH + c];
      }
    if (tid < kT) Km[tid] = mrow[k0 + tid] != 0 ? 1.f : 0.f;
    __syncthreads();
  };
  auto scores = [&](float (&s)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DH; ++c) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qt[c * kPad + rg * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Kt[c * kPad + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[i][j] = Km[cg + 16 * j] != 0.f ? -INFINITY : s[i][j] * scale;
  };

  // pass 1: the row max and the sum of exp(s - max), online over key tiles
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < N; k0 += kT) {
    stage_keys(k0, false);
    float s[4][4];
    scores(s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) mx = fmaxf(mx, s[i][j]);
      const float m_new = fmaxf(m[i], vs::group_max<16>(mx));
      const bool none = m_new == -INFINITY;  // no unpadded key seen yet
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) rs += none ? 0.f : expf(s[i][j] - m_new);
      rs = vs::group_sum<16>(rs);
      const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
    }
  }
  float linv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) linv[i] = 1.f / l[i];

  // pass 2: P = exp(s - max) / sum with the head's dropout, then P.V. The
  // forward kernel's order (full == 0) folds the keep scale into 1/sum
  // (block_train.py:154-156); the backward's recompute drops the
  // normalised p (block_train.py:148-149)
  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < DPT; ++t) acc[i][t] = 0.f;
  for (int k0 = 0; k0 < N; k0 += kT) {
    stage_keys(k0, true);
    float s[4][4];
    scores(s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + rg * 4 + i;
      const float factor = linv[i] * kscale;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + cg + 16 * j;
        const float e = expf(s[i][j] - m[i]);
        const bool keep = keep_bit(base, q, key, thr);
        const float pd = !keep ? 0.f : (full ? (e * linv[i]) * kscale
                                             : e * factor);
        Pt[(cg + 16 * j) * kPad + rg * 4 + i] = pd;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kT; ++kk) {
      float pa[4], vb[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Pt[kk * kPad + rg * 4 + i];
#pragma unroll
      for (int t = 0; t < DPT; ++t) vb[t] = Vs[kk * DH + cg + 16 * t];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int t = 0; t < DPT; ++t)
          acc[i][t] = fmaf(pa[i], vb[t], acc[i][t]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + rg * 4 + i;
    const long long orow = ((long long)b * N + q) * d + h * DH;
#pragma unroll
    for (int t = 0; t < DPT; ++t) o[orow + cg + 16 * t] = acc[i][t];
    if (cg == 0 && m_out != nullptr) {
      const long long si = ((long long)b * H + h) * N + q;
      m_out[si] = m[i];
      l_out[si] = l[i];
    }
  }
}

// dQ for one query tile, looping over the key tiles; first D = rowsum(dO o O)
// for its rows, which bt_attn_dkdv reads after it.
template <int DH>
constexpr int dq_smem_floats() {
  return 4 * DH * kPad + kT * kPad + kT;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
bt_attn_dq_kernel(const float* __restrict__ qkv, const float* __restrict__ o,
                  const float* __restrict__ dO,
                  const float* __restrict__ mstat,
                  const float* __restrict__ lstat,
                  const unsigned char* __restrict__ mask,
                  float* __restrict__ Dstat, float* __restrict__ dqkv, int N,
                  int H, float scale, unsigned seed, unsigned thr,
                  float kscale) {
  constexpr int DPT = DH / 16;
  extern __shared__ float smem[];
  float* Qt = smem;
  float* dOt = Qt + DH * kPad;
  float* Kt = dOt + DH * kPad;
  float* Vt = Kt + DH * kPad;
  float* dSs = Vt + DH * kPad;  // [query][key], kPad
  float* Km = dSs + kT * kPad;

  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int d = H * DH;
  const long long ld = 3LL * d;
  const float* rows = qkv + (long long)b * N * ld;
  const float* drows = dO + (long long)b * N * d;
  const float* orows = o + (long long)b * N * d;
  const unsigned char* mrow = mask + (long long)b * N;
  const unsigned base = hash_base(seed, h, b);

  stage_t<DH>(Qt, rows, ld, q0, h * DH);
  stage_t<DH>(dOt, drows, d, q0, h * DH);

  float Dr[4], mr[4], linv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + rg * 4 + i;
    float part = 0.f;
#pragma unroll
    for (int t = 0; t < DPT; ++t) {
      const long long idx = (long long)q * d + h * DH + cg + 16 * t;
      part += drows[idx] * orows[idx];
    }
    Dr[i] = vs::group_sum<16>(part);
    const long long si = ((long long)b * H + h) * N + q;
    mr[i] = mstat[si];
    linv[i] = 1.f / lstat[si];
    if (cg == 0) Dstat[si] = Dr[i];
  }

  float dq[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < DPT; ++t) dq[i][t] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kT) {
    __syncthreads();
    stage_t<DH>(Kt, rows, ld, k0, d + h * DH);
    stage_t<DH>(Vt, rows, ld, k0, 2 * d + h * DH);
    if (tid < kT) Km[tid] = mrow[k0 + tid] != 0 ? 1.f : 0.f;
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DH; ++c) {
      float qa[4], ga[4], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = Qt[c * kPad + rg * 4 + i];
        ga[i] = dOt[c * kPad + rg * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = Kt[c * kPad + cg + 16 * j];
        vb[j] = Vt[c * kPad + cg + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(ga[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = cg + 16 * j;
        const float sv = Km[kj] != 0.f ? -INFINITY : s[i][j] * scale;
        const float p = expf(sv - mr[i]) * linv[i];
        const float g =
            keep_bit(base, q, k0 + kj, thr) ? dp[i][j] * kscale : 0.f;
        dSs[(rg * 4 + i) * kPad + kj] = p * (g - Dr[i]);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kT; ++kk) {
      float sa[4], kb[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) sa[i] = dSs[(rg * 4 + i) * kPad + kk];
#pragma unroll
      for (int t = 0; t < DPT; ++t) kb[t] = Kt[(cg + 16 * t) * kPad + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int t = 0; t < DPT; ++t) dq[i][t] = fmaf(sa[i], kb[t], dq[i][t]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = ((long long)b * N + q0 + rg * 4 + i) * ld + h * DH;
#pragma unroll
    for (int t = 0; t < DPT; ++t) dqkv[r + cg + 16 * t] = dq[i][t] * scale;
  }
}

// dK and dV for one key tile, looping over the query tiles: thread (rg, cg)
// holds keys 4 rg + i and queries cg + 16 j of each transposed score tile.
template <int DH>
constexpr int dkdv_smem_floats() {
  return 4 * DH * kPad + 2 * kT * kPad + 3 * kT;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
bt_attn_dkdv_kernel(const float* __restrict__ qkv,
                    const float* __restrict__ dO,
                    const float* __restrict__ mstat,
                    const float* __restrict__ lstat,
                    const float* __restrict__ Dstat,
                    const unsigned char* __restrict__ mask,
                    float* __restrict__ dqkv, int N, int H, float scale,
                    unsigned seed, unsigned thr, float kscale) {
  constexpr int DPT = DH / 16;
  extern __shared__ float smem[];
  float* Kt = smem;
  float* Vt = Kt + DH * kPad;
  float* Qt = Vt + DH * kPad;
  float* dOt = Qt + DH * kPad;
  float* PdT = dOt + DH * kPad;  // [key][query], kPad
  float* dST = PdT + kT * kPad;  // [key][query], kPad
  float* Mq = dST + kT * kPad;
  float* Lq = Mq + kT;
  float* Dq = Lq + kT;

  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int k0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int d = H * DH;
  const long long ld = 3LL * d;
  const float* rows = qkv + (long long)b * N * ld;
  const float* drows = dO + (long long)b * N * d;
  const unsigned base = hash_base(seed, h, b);
  const long long s0 = ((long long)b * H + h) * N;

  stage_t<DH>(Kt, rows, ld, k0, d + h * DH);
  stage_t<DH>(Vt, rows, ld, k0, 2 * d + h * DH);
  bool km[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    km[i] = mask[(long long)b * N + k0 + rg * 4 + i] != 0;

  float dk[4][DPT], dv[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < DPT; ++t) dk[i][t] = dv[i][t] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kT) {
    __syncthreads();
    stage_t<DH>(Qt, rows, ld, q0, h * DH);
    stage_t<DH>(dOt, drows, d, q0, h * DH);
    if (tid < kT) {
      Mq[tid] = mstat[s0 + q0 + tid];
      Lq[tid] = 1.f / lstat[s0 + q0 + tid];
      Dq[tid] = Dstat[s0 + q0 + tid];
    }
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DH; ++c) {
      float ka[4], va[4], qb[4], gb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ka[i] = Kt[c * kPad + rg * 4 + i];
        va[i] = Vt[c * kPad + rg * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qb[j] = Qt[c * kPad + cg + 16 * j];
        gb[j] = dOt[c * kPad + cg + 16 * j];
      }
      // q . k with the same operand order as the other two kernels
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qb[j], ka[i], s[i][j]);
          dp[i][j] = fmaf(gb[j], va[i], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qj = cg + 16 * j;
        const float sv = km[i] ? -INFINITY : s[i][j] * scale;
        const float p = expf(sv - Mq[qj]) * Lq[qj];
        const bool keep = keep_bit(base, q0 + qj, key, thr);
        const float g = keep ? dp[i][j] * kscale : 0.f;
        PdT[(rg * 4 + i) * kPad + qj] = keep ? p * kscale : 0.f;
        dST[(rg * 4 + i) * kPad + qj] = p * (g - Dq[qj]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int qq = 0; qq < kT; ++qq) {
      float pa[4], sa[4], gb[DPT], qb[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = PdT[(rg * 4 + i) * kPad + qq];
        sa[i] = dST[(rg * 4 + i) * kPad + qq];
      }
#pragma unroll
      for (int t = 0; t < DPT; ++t) {
        gb[t] = dOt[(cg + 16 * t) * kPad + qq];
        qb[t] = Qt[(cg + 16 * t) * kPad + qq];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int t = 0; t < DPT; ++t) {
          dv[i][t] = fmaf(pa[i], gb[t], dv[i][t]);
          dk[i][t] = fmaf(sa[i], qb[t], dk[i][t]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = ((long long)b * N + k0 + rg * 4 + i) * ld + h * DH;
#pragma unroll
    for (int t = 0; t < DPT; ++t) {
      dqkv[r + d + cg + 16 * t] = dk[i][t] * scale;
      dqkv[r + 2 * d + cg + 16 * t] = dv[i][t];
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel k, int bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int DH>
cudaError_t launch_attn_fwd(const float* qkv, const unsigned char* mask,
                            float* o, float* m, float* l, int B, int H, int N,
                            float scale, unsigned seed, unsigned thr,
                            float kscale, int full, cudaStream_t s) {
  const int bytes = fwd_smem_floats<DH>() * (int)sizeof(float);
  cudaError_t err = allow_smem(bt_attn_fwd_kernel<DH>, bytes);
  if (err != cudaSuccess) return err;
  bt_attn_fwd_kernel<DH><<<dim3(N / kT, H, B), kThreads, bytes, s>>>(
      qkv, mask, o, m, l, N, H, scale, seed, thr, kscale, full);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_attn_bwd(const float* qkv, const float* o,
                            const float* dO, const float* m, const float* l,
                            const unsigned char* mask, float* D, float* dqkv,
                            int B, int H, int N, float scale, unsigned seed,
                            unsigned thr, float kscale, cudaStream_t s) {
  const int dq_bytes = dq_smem_floats<DH>() * (int)sizeof(float);
  const int kv_bytes = dkdv_smem_floats<DH>() * (int)sizeof(float);
  cudaError_t err = allow_smem(bt_attn_dq_kernel<DH>, dq_bytes);
  if (err == cudaSuccess) err = allow_smem(bt_attn_dkdv_kernel<DH>, kv_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / kT, H, B);
  bt_attn_dq_kernel<DH><<<grid, kThreads, dq_bytes, s>>>(
      qkv, o, dO, m, l, mask, D, dqkv, N, H, scale, seed, thr, kscale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bt_attn_dkdv_kernel<DH><<<grid, kThreads, kv_bytes, s>>>(
      qkv, dO, m, l, D, mask, dqkv, N, H, scale, seed, thr, kscale);
  return cudaGetLastError();
}

bool attn_shape_ok(int B, int H, int N, int Dh) {
  return B > 0 && H > 0 && N > 0 && N % kT == 0 && B <= 65535 &&
         H <= 65535 && (Dh == 16 || Dh == 64);
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
  bt_gemm_kernel<<<grid, kThreads, 0, s>>>(
      A, B, bias, addend, aux, C, C2, splits > 1 ? partial : nullptr, M, N, K,
      sam, sak, sbk, sbn, epilogue, kchunk, dr);
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
  if (M <= 0 || rows <= 0 || d <= 0 || d % 32 || d > 32 * kMaxPerLane)
    return (int)cudaErrorInvalidValue;
  const Drop dr{seed, site, rows, thr, kscale};
  bt_drop_res_ln_kernel<<<(M + kRowsPerBlock - 1) / kRowsPerBlock, kThreads,
                          0, static_cast<cudaStream_t>(stream)>>>(
      p, resid, g, beta, out, xhat, inv, M, d, eps, dr);
  return (int)cudaGetLastError();
}

extern "C" int vs_bt_ln_bwd_drop(const float* dy, const float* xhat,
                                 const float* inv, const float* g, float* dz,
                                 float* dmask, int M, int d, int rows,
                                 unsigned seed, int site, unsigned thr,
                                 float kscale, void* stream) {
  if (M <= 0 || rows <= 0 || d <= 0 || d % 32 || d > 32 * kMaxPerLane)
    return (int)cudaErrorInvalidValue;
  const Drop dr{seed, site, rows, thr, kscale};
  bt_ln_bwd_drop_kernel<<<(M + kRowsPerBlock - 1) / kRowsPerBlock, kThreads,
                          0, static_cast<cudaStream_t>(stream)>>>(
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

extern "C" int vs_bt_attention_fwd(const float* qkv,
                                   const unsigned char* mask, float* o,
                                   float* m, float* l, int B, int H, int N,
                                   int Dh, float scale, unsigned seed,
                                   unsigned thr, float kscale, int full,
                                   void* stream) {
  if (!attn_shape_ok(B, H, N, Dh) || ((m == nullptr) != (l == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      Dh == 16 ? launch_attn_fwd<16>(qkv, mask, o, m, l, B, H, N, scale, seed,
                                     thr, kscale, full, s)
               : launch_attn_fwd<64>(qkv, mask, o, m, l, B, H, N, scale, seed,
                                     thr, kscale, full, s);
  return (int)err;
}

extern "C" int vs_bt_attention_bwd(const float* qkv, const float* o,
                                   const float* dO, const float* m,
                                   const float* l, const unsigned char* mask,
                                   float* D, float* dqkv, int B, int H, int N,
                                   int Dh, float scale, unsigned seed,
                                   unsigned thr, float kscale, void* stream) {
  if (!attn_shape_ok(B, H, N, Dh)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      Dh == 16 ? launch_attn_bwd<16>(qkv, o, dO, m, l, mask, D, dqkv, B, H, N,
                                     scale, seed, thr, kscale, s)
               : launch_attn_bwd<64>(qkv, o, dO, m, l, mask, D, dqkv, B, H, N,
                                     scale, seed, thr, kscale, s);
  return (int)err;
}
