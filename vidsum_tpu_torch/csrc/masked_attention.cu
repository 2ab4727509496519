// masked_attention: softmax(scale * Q K^T, key padding mask) V for sm_90a,
// one CTA per (query tile, head, batch element), K/V streamed through shared
// memory in 64-key tiles with an online softmax in f32.
//
// Replaces the TPU kernels vidsum_tpu/ops/attention.py::_attention_kernel
// (single pass over all keys) and ::_attention_kernel_folded (online softmax
// over key blocks), and the attention middle of
// vidsum_tpu/ops/block_kernel.py::_block_kernel / ::_block_kernel_grouped.
// The TPU split between a single-pass and a folded kernel is a VMEM matter:
// a CTA here never holds more than one 64-key tile, so one kernel serves
// both entry points at every length.
//
// Semantics, as the TPU kernels: s = (q . k) * scale in f32; -inf at padded
// keys (a key-only mask, broadcast over heads and queries); the probabilities
// are rounded to the dtype of V before P.V; P.V accumulates in f32; the
// output is in the input dtype. Where P is rounded follows the TPU kernel the
// caller stands for (norm_first): the single-pass and block kernels round
// the normalised p = e / sum(e) (attention.py:61-65, block_kernel.py:71-77),
// the folded kernel the unnormalised e of its online softmax and divides at
// the end (attention.py:98-115). In f32 the rounding is the identity and the
// two orders agree up to summation order, so the f32 kernel always folds
// online. The fold keeps the folded kernel's _DEAD guards: a row that has
// seen no unpadded key carries m = -inf and contributes nothing, and a row
// with no unpadded key at all is written as 0 (the folded kernel's
// behaviour; the serving path never produces such a row because every
// request has at least one real frame).
//
// Inputs are (B, H, N, Dh) views given by element strides (batch, head,
// token), the last dim contiguous, so the block path reads Q/K/V straight out
// of its fused (B, N, 3d) QKV buffer and writes into a (B, N, d) buffer with
// no transposes. mask is (B, N) bytes, nonzero = padded.
//
// Bound on the card: at B=32, N=512, H=4, Dh=64 attention is 4*B*H*N^2*Dh =
// 8.6 GFLOP and moves 4*B*H*N*Dh*2 B = 33.5 MB in bf16, about 260 FLOP/byte,
// just under the H100's ridge: ~10 us at either peak. At N=16,384 (B=1) it
// is 275 GFLOP on 8.4 MB: operations-bound. Design against it: the N x N
// scores never leave the SM. bf16 runs both products on the tensor cores
// (mma.sync m16n8k16, f32 accumulate) with S, P and O in registers (the
// normalise-first order computes Q.K^T twice: 1.5x the bound's work); f32
// stays exact (no TF32) on the FMA units, each thread holding a 4 x 4 score
// block and a 4 x (Dh/16) output block, with the shared-memory tiles stored
// transposed and padded so every read is conflict-free or a broadcast.
// Neither overlaps its K/V loads with its products yet (cp.async / TMA are
// later work).
//
// The int8 block (vidsum_tpu/ops/block_kernel_int8.py::_block_kernel_int8,
// ::_block_kernel_int8_grouped) runs this attention with two differences
// (block_kernel_int8.py:93-123): its output attn stays f32, to be quantised
// straight from f32 for the projection, so the normalise-first bf16 kernel
// also writes f32 (OutT); and with qk_int8 the scores are
// i8dot(q8, k8) * (qs * ks) * scale from int8 Q and K with per-row f32
// scales (QK8): the bf16 kernel takes them on the int8 tensor cores
// (mma.sync m16n8k32; head_dim 16 is zero-padded to one k32 step), the f32
// kernel on its FMA loop, where the dot of int8 values is an exact integer
// (Dh * 127^2 < 2^24). V, P and P.V are as above.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;    // query rows per CTA: 16 row groups x 4 rows
constexpr int kBKey = 64;  // keys per streamed tile: 16 lanes x 4 keys
constexpr int kPad = 65;   // padded row length of the transposed tiles
constexpr float kDead = -1e37f;

template <int DH>
constexpr int smem_floats() {
  return DH * kPad      // Qt  [DH][kPad]
         + DH * kPad    // Kt  [DH][kPad]
         + kBKey * DH   // Vs  [kBKey][DH]
         + kBKey * kPad // Pt  [kBKey][kPad]
         + kBKey        // key mask as 0/1 floats
         + kBKey;       // QK8: the keys' int8 scales
}

// Q and K are T, or int8 codes with per-row scales qsc / ksc (QK8), given by
// the element strides c_b, c_h, c_n.
template <typename T, int DH, bool QK8>
__global__ void __launch_bounds__(kThreads)
masked_attention_kernel(const void* __restrict__ q_,
                        const void* __restrict__ k_,
                        const T* __restrict__ v,
                        const unsigned char* __restrict__ mask,
                        const float* __restrict__ qsc,
                        const float* __restrict__ ksc,
                        T* __restrict__ o, int N, long long s_b,
                        long long s_h, long long s_n, long long o_s_b,
                        long long o_s_h, long long o_s_n, long long c_b,
                        long long c_h, long long c_n, float scale) {
  constexpr int DPT = DH / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qt = smem;
  float* Kt = Qt + DH * kPad;
  float* Vs = Kt + DH * kPad;
  float* Pt = Vs + kBKey * DH;
  float* Km = Pt + kBKey * kPad;
  float* Ksc = Km + kBKey;
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const int8_t* q8 = static_cast<const int8_t*>(q_);
  const int8_t* k8 = static_cast<const int8_t*>(k_);

  const int tid = threadIdx.x;
  const int rg = tid >> 4;  // row group: rows 4*rg .. 4*rg+3 of the tile
  const int cg = tid & 15;  // lane in the row group: keys / columns cg+16*j
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long base = (long long)b * s_b + (long long)h * s_h;
  const long long cbase = (long long)b * c_b + (long long)h * c_h;
  const unsigned char* mrow = mask + (long long)b * N;

  for (int idx = tid; idx < kBQ * DH; idx += kThreads) {
    const int r = idx / DH, c = idx % DH;
    const int n = q0 + r;
    float val = 0.f;
    if (n < N)
      val = QK8 ? (float)q8[base + n * s_n + c]
                : vs::to_f32<T>(q[base + n * s_n + c]);
    Qt[c * kPad + r] = val;
  }
  float qs[4] = {1.f, 1.f, 1.f, 1.f};
  if (QK8) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = q0 + rg * 4 + i;
      if (n < N) qs[i] = qsc[cbase + n * c_n];
    }
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[i][d] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += kBKey) {
    __syncthreads();  // the previous tile's readers are done (and Qt is in)
    for (int idx = tid; idx < kBKey * DH; idx += kThreads) {
      const int r = idx / DH, c = idx % DH;
      const int n = k0 + r;
      const bool ok = n < N;
      float kv = 0.f;
      if (ok)
        kv = QK8 ? (float)k8[base + n * s_n + c]
                 : vs::to_f32<T>(k[base + n * s_n + c]);
      Kt[c * kPad + r] = kv;
      Vs[r * DH + c] = ok ? vs::to_f32<T>(v[base + n * s_n + c]) : 0.f;
    }
    if (tid < kBKey) {
      const int n = k0 + tid;
      Km[tid] = (n >= N || mrow[n] != 0) ? 1.f : 0.f;
      if (QK8) Ksc[tid] = n < N ? ksc[cbase + n * c_n] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < DH; ++dd) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qt[dd * kPad + rg * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Kt[dd * kPad + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // QK8: s is the exact integer dot; (dot * (qs * ks)) * scale
        const float sj =
            QK8 ? __fmul_rn(__fmul_rn(s[i][j],
                                      __fmul_rn(qs[i], Ksc[cg + 16 * j])),
                            scale)
                : s[i][j] * scale;
        s[i][j] = Km[cg + 16 * j] != 0.f ? -INFINITY : sj;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = vs::group_max<16>(mx);
      const float m_new = fmaxf(m[i], mx);
      const bool dead = m_new < kDead;
      const float m_safe = dead ? 0.f : m_new;
      const float corr = m[i] < kDead ? 0.f : expf(m[i] - m_safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = dead ? 0.f : expf(s[i][j] - m_safe);
        rs += e;
        Pt[(cg + 16 * j) * kPad + rg * 4 + i] = vs::round_to<T>(e);
      }
      rs = vs::group_sum<16>(rs);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[i][d] *= corr;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBKey; ++kk) {
      float pa[4], vb[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Pt[kk * kPad + rg * 4 + i];
#pragma unroll
      for (int d = 0; d < DPT; ++d) vb[d] = Vs[kk * DH + cg + 16 * d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int d = 0; d < DPT; ++d) acc[i][d] = fmaf(pa[i], vb[d], acc[i][d]);
    }
  }

  const long long obase = (long long)b * o_s_b + (long long)h * o_s_h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + rg * 4 + i;
    if (n >= N) continue;
    const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
#pragma unroll
    for (int d = 0; d < DPT; ++d)
      o[obase + n * o_s_n + cg + 16 * d] = vs::from_f32<T>(acc[i][d] * inv);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (the FlashAttention-2 register layout). A CTA of
// 4 warps takes 64 query rows, each warp 16 of them, and streams 64-key
// tiles: S = Q.K^T as m16n8k16 products (Q fragments loaded once, K tile
// row-major in shared memory), the softmax on S's accumulator registers (a
// row's 64 keys sit in one thread and its 3 neighbours), then P.V with P
// re-packed from S's accumulators straight into A fragments (rounded to bf16
// there) and V's fragments read row-major with a transposing ldmatrix. Rows
// are padded by 8 bf16, so every fragment load of a warp hits 32 distinct
// banks.
//
// NORM_FIRST rounds P where the single-pass and block TPU kernels round it
// (attention.py:61-65, block_kernel.py:71-77): after normalising, p =
// exp(s - m) * (1/l) against the row's global max m and sum l. A first pass
// over the key tiles computes S alone and folds each row's max and sum; a
// second recomputes S, normalises, rounds and runs P.V: 1.5x the products
// of one pass. (l is summed tile by tile with the online rescaling, so it
// equals the TPU kernel's sum up to f32 summation order.) Without
// NORM_FIRST this is the folded TPU kernel's one-pass online softmax
// (attention.py:98-115): the unnormalised exp(s - running max) is rounded,
// and the output is divided by l at the end.
constexpr int kMmaThreads = 128;
constexpr int kLdsPad = 8;
constexpr int kLds8Pad = 16;  // int8 rows: DH + 16 bytes (20 words at DH 64)

template <int DH, bool QK8>
constexpr int mma_smem_bytes() {
  return QK8 ? (kBQ + kBKey) * (DH + kLds8Pad)      // Q8s, K8s [rows][DH+16]
                   + kBKey * (DH + kLdsPad) * 2     // Vs [rows][DH+8] bf16
                   + 2 * kBKey * 4                  // key mask, key scales
             : (kBQ + 2 * kBKey) * (DH + kLdsPad) * 2  // Qs, Ks, Vs
                   + kBKey * 4;                        // key mask
}

// OutT: bf16, or f32 for the int8 block's attn. QK8: q and k are int8 codes
// with per-row scales qsc / ksc (element strides c_b, c_h, c_n); vec says
// the bf16 rows allow 16-byte loads, vec8 the int8 rows.
template <int DH, bool NORM_FIRST, typename OutT, bool QK8>
__global__ void __launch_bounds__(kMmaThreads)
masked_attention_mma_kernel(const void* __restrict__ q_,
                            const void* __restrict__ k_,
                            const __nv_bfloat16* __restrict__ v,
                            const unsigned char* __restrict__ mask,
                            const float* __restrict__ qsc,
                            const float* __restrict__ ksc,
                            OutT* __restrict__ o, int N,
                            long long s_b, long long s_h, long long s_n,
                            long long o_s_b, long long o_s_h,
                            long long o_s_n, long long c_b, long long c_h,
                            long long c_n, float scale, bool vec,
                            bool vec8) {
  using bf = __nv_bfloat16;
  constexpr int LQ = DH + kLdsPad;     // row length of Qs, Ks and Vs
  constexpr int LQ8 = DH + kLds8Pad;   // row length of Q8s and K8s (bytes)
  constexpr int KS = DH / 16;          // k16 steps of Q.K^T
  constexpr int KS8 = (DH + 31) / 32;  // k32 steps of the int8 Q.K^T
  constexpr int ND = DH / 8;           // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf* Qs = reinterpret_cast<bf*>(smem_raw);
  bf* Ks = Qs + kBQ * LQ;
  int8_t* Q8s = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* K8s = Q8s + kBQ * LQ8;
  bf* Vs = QK8 ? reinterpret_cast<bf*>(K8s + kBKey * LQ8) : Ks + kBKey * LQ;
  float* Km = reinterpret_cast<float*>(Vs + kBKey * LQ);
  float* Ksc = Km + kBKey;
  const bf* q = static_cast<const bf*>(q_);
  const bf* k = static_cast<const bf*>(k_);
  const int8_t* q8 = static_cast<const int8_t*>(q_);
  const int8_t* k8 = static_cast<const int8_t*>(k_);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const long long base = (long long)blockIdx.z * s_b +
                         (long long)blockIdx.y * s_h;
  const long long cbase = (long long)blockIdx.z * c_b +
                          (long long)blockIdx.y * c_h;
  const unsigned char* mrow = mask + (long long)blockIdx.z * N;
  const bf zero = __float2bfloat16(0.f);

  // 64 rows of DH bf16 in 16-byte chunks, zeros past N
  auto stage = [&](const bf* src, int n0, bf* dst) {
    for (int c = tid; c < 64 * (DH / 8); c += kMmaThreads) {
      const int r = c / (DH / 8), cc = (c % (DH / 8)) * 8;
      const int n = n0 + r;
      const bf* p = src + base + (long long)n * s_n + cc;
      uint4 raw;
      if (vec && n < N) {
        raw = *reinterpret_cast<const uint4*>(p);
      } else {
        bf* vals = reinterpret_cast<bf*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) vals[j] = n < N ? p[j] : zero;
      }
      *reinterpret_cast<uint4*>(&dst[r * LQ + cc]) = raw;
    }
  };
  // 64 rows of DH int8 codes in 16-byte chunks, zeros past N
  auto stage8 = [&](const int8_t* src, int n0, int8_t* dst) {
    for (int c = tid; c < 64 * (DH / 16); c += kMmaThreads) {
      const int r = c / (DH / 16), cc = (c % (DH / 16)) * 16;
      const int n = n0 + r;
      const int8_t* p = src + base + (long long)n * s_n + cc;
      uint4 raw;
      if (vec8 && n < N) {
        raw = *reinterpret_cast<const uint4*>(p);
      } else {
        int8_t* vals = reinterpret_cast<int8_t*>(&raw);
#pragma unroll
        for (int j = 0; j < 16; ++j) vals[j] = n < N ? p[j] : int8_t(0);
      }
      *reinterpret_cast<uint4*>(&dst[r * LQ8 + cc]) = raw;
    }
  };

  uint32_t qa[QK8 ? 1 : KS][4];
  uint32_t qa8[QK8 ? KS8 : 1][4];
  float qs_row[2] = {1.f, 1.f};  // QK8: the scales of rows g and g + 8
  {
    const int r = warp * 16 + g;
    if constexpr (QK8) {
      stage8(q8, q0, Q8s);
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < KS8; ++ks) {
        const int c = ks * 32 + 4 * t;
        qa8[ks][0] = vs::ld_u32(&Q8s[r * LQ8 + c]);
        qa8[ks][1] = vs::ld_u32(&Q8s[(r + 8) * LQ8 + c]);
        qa8[ks][2] = c + 16 < DH ? vs::ld_u32(&Q8s[r * LQ8 + c + 16]) : 0u;
        qa8[ks][3] =
            c + 16 < DH ? vs::ld_u32(&Q8s[(r + 8) * LQ8 + c + 16]) : 0u;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = q0 + r + 8 * h;
        if (n < N) qs_row[h] = qsc[cbase + (long long)n * c_n];
      }
    } else {
      stage(q, q0, Qs);
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        qa[ks][0] = vs::ld_pair(&Qs[r * LQ + ks * 16 + 2 * t]);
        qa[ks][1] = vs::ld_pair(&Qs[(r + 8) * LQ + ks * 16 + 2 * t]);
        qa[ks][2] = vs::ld_pair(&Qs[r * LQ + ks * 16 + 8 + 2 * t]);
        qa[ks][3] = vs::ld_pair(&Qs[(r + 8) * LQ + ks * 16 + 8 + 2 * t]);
      }
    }
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  // the key tile at k0 (and its V rows if with_v) into shared memory
  auto stage_keys = [&](int k0, bool with_v) {
    __syncthreads();  // the previous tile's readers are done
    if constexpr (QK8)
      stage8(k8, k0, K8s);
    else
      stage(k, k0, Ks);
    if (with_v) stage(v, k0, Vs);
    if (tid < kBKey) {
      const int n = k0 + tid;
      Km[tid] = (n >= N || mrow[n] != 0) ? 1.f : 0.f;
      if (QK8) Ksc[tid] = n < N ? ksc[cbase + (long long)n * c_n] : 0.f;
    }
    __syncthreads();
  };
  // S = Q.K^T of the staged tile, scaled, -inf at padded keys; element
  // (ni, e) is row g + 8*(e >> 1) of the warp, key ni*8 + 2t + (e & 1)
  auto scores = [&](float (&s)[8][4]) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      if constexpr (QK8) {
        int d8[4] = {0, 0, 0, 0};
        const int8_t* krow = &K8s[(ni * 8 + g) * LQ8];
#pragma unroll
        for (int ks = 0; ks < KS8; ++ks) {
          const int c = ks * 32 + 4 * t;
          vs::mma_s8_16832(d8, qa8[ks][0], qa8[ks][1], qa8[ks][2],
                           qa8[ks][3], vs::ld_u32(krow + c),
                           c + 16 < DH ? vs::ld_u32(krow + c + 16) : 0u);
        }
        // (i8dot * (qs * ks)) * scale, block_kernel_int8.py:105-108
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = ni * 8 + 2 * t + (e & 1);
          s[ni][e] = Km[key] != 0.f
                         ? -INFINITY
                         : __fmul_rn(__fmul_rn(__int2float_rn(d8[e]),
                                               __fmul_rn(qs_row[e >> 1],
                                                         Ksc[key])),
                                     scale);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[ni][e] = 0.f;
        const bf* krow = &Ks[(ni * 8 + g) * LQ];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          vs::mma_bf16_16816(s[ni], qa[ks][0], qa[ks][1], qa[ks][2],
                             qa[ks][3], vs::ld_pair(krow + ks * 16 + 2 * t),
                             vs::ld_pair(krow + ks * 16 + 8 + 2 * t));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[ni][e] = Km[ni * 8 + 2 * t + (e & 1)] != 0.f ? -INFINITY
                                                         : s[ni][e] * scale;
      }
    }
  };
  // fold row half h of the tile into (m, l) with the folded kernel's _DEAD
  // guards; leaves e = exp(s - new max) in s and returns the factor that
  // rescales what was summed before
  auto fold = [&](float (&s)[8][4], int h) -> float {
    float mx = -INFINITY;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int c = 0; c < 2; ++c) mx = fmaxf(mx, s[ni][2 * h + c]);
    mx = vs::group_max<4>(mx);
    const float m_new = fmaxf(m[h], mx);
    const bool dead = m_new < kDead;
    const float m_safe = dead ? 0.f : m_new;
    const float corr = m[h] < kDead ? 0.f : expf(m[h] - m_safe);
    float rs = 0.f;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float e = dead ? 0.f : expf(s[ni][2 * h + c] - m_safe);
        s[ni][2 * h + c] = e;
        rs += e;
      }
    rs = vs::group_sum<4>(rs);
    l[h] = l[h] * corr + rs;
    m[h] = m_new;
    return corr;
  };

  // NORM_FIRST: the final max (0 for a row with no unpadded key, whose
  // scores are all -inf, so its p are 0) and 1/l
  float m_fin[2] = {0.f, 0.f}, inv_l[2] = {1.f, 1.f};
  if constexpr (NORM_FIRST) {
    for (int k0 = 0; k0 < N; k0 += kBKey) {
      stage_keys(k0, false);
      float s[8][4];
      scores(s);
      fold(s, 0);
      fold(s, 1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_fin[h] = m[h] < kDead ? 0.f : m[h];
      inv_l[h] = l[h] == 0.f ? 0.f : 1.f / l[h];
    }
  }

  for (int k0 = 0; k0 < N; k0 += kBKey) {
    stage_keys(k0, true);
    float s[8][4];
    scores(s);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (NORM_FIRST) {
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            s[ni][2 * h + c] =
                expf(s[ni][2 * h + c] - m_fin[h]) * inv_l[h];
      } else {
        const float corr = fold(s, h);
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          acc[nd][2 * h] *= corr;
          acc[nd][2 * h + 1] *= corr;
        }
      }
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      pa[kc][0] = vs::pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[kc][1] = vs::pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[kc][2] = vs::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[kc][3] = vs::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
    }
    // lane l addresses key row (l & 15) of each 16-key chunk
    const bf* vrow = &Vs[(lane & 15) * LQ];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t b0, b1;
        vs::ldmatrix_x2_trans(b0, b1, vrow + kc * 16 * LQ + nd * 8);
        vs::mma_bf16_16816(acc[nd], pa[kc][0], pa[kc][1], pa[kc][2],
                           pa[kc][3], b0, b1);
      }
    }
  }

  const long long obase = (long long)blockIdx.z * o_s_b +
                          (long long)blockIdx.y * o_s_h;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = q0 + warp * 16 + g + 8 * h;
    if (n >= N) continue;
    const float inv = NORM_FIRST ? 1.f : (l[h] == 0.f ? 0.f : 1.f / l[h]);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      OutT* dst = &o[obase + n * o_s_n + nd * 8 + 2 * t];
      if constexpr (sizeof(OutT) == 4)
        *reinterpret_cast<float2*>(dst) =
            make_float2(acc[nd][2 * h] * inv, acc[nd][2 * h + 1] * inv);
      else
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(
            acc[nd][2 * h] * inv, acc[nd][2 * h + 1] * inv);
    }
  }
}

// The arguments every launch passes through.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const unsigned char* mask;
  void* o;
  const float* qsc;
  const float* ksc;
  int B, H, N;
  long long s_b, s_h, s_n, o_s_b, o_s_h, o_s_n, c_b, c_h, c_n;
  float scale;
};

template <int DH, bool NORM_FIRST, typename OutT, bool QK8>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  constexpr int bytes = mma_smem_bytes<DH, QK8>();
  auto kernel = masked_attention_mma_kernel<DH, NORM_FIRST, OutT, QK8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  // 16-byte staging loads need 16-byte aligned rows
  const bool strided8 = a.s_b % 8 == 0 && a.s_h % 8 == 0 && a.s_n % 8 == 0;
  const bool strided16 =
      a.s_b % 16 == 0 && a.s_h % 16 == 0 && a.s_n % 16 == 0;
  auto al16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = strided8 && al16(a.v) && (QK8 || (al16(a.q) && al16(a.k)));
  const bool vec8 = QK8 && strided16 && al16(a.q) && al16(a.k);
  const dim3 grid((a.N + kBQ - 1) / kBQ, a.H, a.B);
  kernel<<<grid, kMmaThreads, bytes, stream>>>(
      a.q, a.k, static_cast<const __nv_bfloat16*>(a.v), a.mask, a.qsc, a.ksc,
      static_cast<OutT*>(a.o), a.N, a.s_b, a.s_h, a.s_n, a.o_s_b, a.o_s_h,
      a.o_s_n, a.c_b, a.c_h, a.c_n, a.scale, vec, vec8);
  return cudaGetLastError();
}

template <typename T, int DH, bool QK8>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int bytes = smem_floats<DH>() * (int)sizeof(float);
  auto kernel = masked_attention_kernel<T, DH, QK8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + kBQ - 1) / kBQ, a.H, a.B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      a.q, a.k, static_cast<const T*>(a.v), a.mask, a.qsc, a.ksc,
      static_cast<T*>(a.o), a.N, a.s_b, a.s_h, a.s_n, a.o_s_b, a.o_s_h,
      a.o_s_n, a.c_b, a.c_h, a.c_n, a.scale);
  return cudaGetLastError();
}

// head_dim 64 is the flagship's, 16 that of the d 64 test configurations
template <typename T, bool QK8>
cudaError_t launch_dh(const Args& a, int Dh, cudaStream_t stream) {
  switch (Dh) {
    case 16:
      return launch<T, 16, QK8>(a, stream);
    case 64:
      return launch<T, 64, QK8>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool NORM_FIRST, typename OutT, bool QK8>
cudaError_t launch_mma_dh(const Args& a, int Dh, cudaStream_t stream) {
  // the output is written as pairs
  if ((a.o_s_b | a.o_s_h | a.o_s_n) & 1 ||
      reinterpret_cast<uintptr_t>(a.o) % (2 * sizeof(OutT)))
    return cudaErrorMisalignedAddress;
  switch (Dh) {
    case 16:
      return launch_mma<16, NORM_FIRST, OutT, QK8>(a, stream);
    case 64:
      return launch_mma<64, NORM_FIRST, OutT, QK8>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: (B, H, N, Dh) views with element strides s_b, s_h, s_n in dtype,
// or, with qsc / ksc given, q and k int8 codes at the same strides and
// qsc / ksc their per-row f32 scales at strides c_b, c_h, c_n (qk_int8). o in
// out_dtype: dtype, or f32 for bf16 inputs with norm_first (the int8 block).
extern "C" int vs_masked_attention(const void* q, const void* k,
                                   const void* v, const unsigned char* mask,
                                   void* o, const float* qsc,
                                   const float* ksc, int B, int H, int N,
                                   int Dh, long long s_b, long long s_h,
                                   long long s_n, long long o_s_b,
                                   long long o_s_h, long long o_s_n,
                                   long long c_b, long long c_h,
                                   long long c_n, float scale, int dtype,
                                   int out_dtype, int norm_first,
                                   void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const bool qk8 = qsc != nullptr;
  if (qk8 != (ksc != nullptr)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, mask, o, qsc, ksc, B, H, N, s_b, s_h, s_n,
               o_s_b, o_s_h, o_s_n, c_b, c_h, c_n, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == vs::kF32 && out_dtype == vs::kF32) {
    // rounding P to f32 is the identity: one pass
    err = qk8 ? launch_dh<float, true>(a, Dh, s)
              : launch_dh<float, false>(a, Dh, s);
  } else if (dtype == vs::kBF16 && out_dtype == vs::kBF16 && !qk8) {
    err = norm_first ? launch_mma_dh<true, __nv_bfloat16, false>(a, Dh, s)
                     : launch_mma_dh<false, __nv_bfloat16, false>(a, Dh, s);
  } else if (dtype == vs::kBF16 && out_dtype == vs::kF32 && norm_first) {
    err = qk8 ? launch_mma_dh<true, float, true>(a, Dh, s)
              : launch_mma_dh<true, float, false>(a, Dh, s);
  }
  return (int)err;
}
