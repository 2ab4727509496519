// Masked attention with counter-hash dropout on the softmax weights, forward
// and backward, in f32: the kernel family that block_train.cu (inside the
// training block, TPU kernels 9-12) and attention_train.cu (the
// flash-attention training route, TPU kernels 5-8 in f32; bf16 takes the
// tensor-core kernels of attention_train_mma.cuh on both routes) launch.
// ring_attention.cu reuses its tile staging (stage_t, also with bf16 K/V).
//
// One CTA of 256 threads takes a 64 x 64 tile of scores; thread (rg, cg) =
// (tid / 16, tid % 16) holds rows 4 rg + i and columns cg + 16 j of it, and
// output columns cg + 16 t. K/V (or Q/dO) stream through shared memory in
// 64-row tiles stored transposed ([DH][kPad]), so every read in the inner
// loops is a broadcast or conflict-free. Nothing of size N x N reaches device
// memory. Products are exact f32 FMA (no TF32: it would not compute what the
// TPU's f32 kernels compute). No kernel uses atomics, so two runs of the
// backward give identical bits.
//
//   fwd_kernel   per 64-query tile. normalise-first (online == 0): pass 1 the
//                row max and sum, pass 2 p = e / l, dropped, then P.V.
//                online: one pass whose denominator sums the raw e while the
//                dropped unnormalised e is accumulated, with the _DEAD
//                guards; o = acc / l at the end. Writes o and, if
//                asked, lse = max + log(sum).
//   dq_kernel    per query tile: D (rowsum(dO * o), or rowsum(dp * p) over
//                the full row, one pass over the keys more), then dQ.
//   dkdv_kernel  per key tile, looping over the query tiles: dV and dK.
// p = exp(s - lse) in the backward, 0 where lse < _DEAD when guarded.
//
// Layouts are strided so that one family reads the training block's fused
// (B*N, 3d) QKV buffer (head h at column h*DH) and (B, H, N, DH) tensors
// alike: element (b, h, row, c) of a tensor lies at b*sb + h*sh + row*sn + c,
// with one stride set for q/k/v/dq/dk/dv ("in") and one for o/dO ("out");
// lse and D are (B, H, N) f32.
#pragma once

#include "common.cuh"

namespace vs {
namespace attn {

constexpr int kThreads = 256;
constexpr int kT = 64;     // query and key tile
constexpr int kPad = 65;   // padded row of a transposed tile
constexpr float kDead = -1e37f;  // ops/attention._DEAD

// The two counter-hash families of the JAX package's dropout, bit for bit
// (uint32 arithmetic that wraps); they share the mixing and differ in the
// base: block_train.py::_hash_keep with site = head (kHashBlock) and
// attention_train.py::_keep_mask_block (kHashAttention).
enum Hash : int { kHashBlock = 0, kHashAttention = 1 };

__device__ __forceinline__ unsigned hash_base(int family, unsigned seed,
                                              int b, int h) {
  return family == kHashBlock
             ? seed * 0x9E3779B1u + (unsigned)(h * 131071 + 17) * 0x85EBCA77u +
                   (unsigned)(b + 1) * 0x27220A95u
             : seed * 0x9E3779B1u + (unsigned)(b * 1024 + h + 1) * 0x85EBCA77u;
}

// At rate 0 (thr == 0) every weight is kept and nothing is hashed.
__device__ __forceinline__ bool keep_bit(unsigned base, int row, int col,
                                         unsigned thr) {
  if (thr == 0u) return true;
  unsigned x = base ^ ((unsigned)row * 0xC2B2AE3Du) ^
               ((unsigned)col * 0x27D4EB2Fu);
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= thr;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;    // forward output (the backward's D = rowsum(dO * o))
  const void* dO;
  void* out;        // forward output o
  void* dq;
  void* dk;
  void* dv;
  const unsigned char* mask;  // (B, N), nonzero = padded key
  float* lse;       // (B, H, N); the forward may skip it (nullptr)
  float* D;         // (B, H, N) scratch of the backward
  long long isb, ish, isn;    // q, k, v, dq, dk, dv
  long long osb, osh, osn;    // o, dO
  int N, H;
  float scale;
  unsigned seed, thr;
  float kscale;     // 1 / (1 - rate) rounded to f32
  int hash;         // Hash
  int online;       // forward: one-pass fold (1) or normalise-first (0)
  int d_from_o;     // backward: D = rowsum(dO * o) (1) or rowsum(dp * p)
  int guard;        // backward: p = 0 where lse < kDead
};

// rows r0..r0+63 of one head's (rows, DH) matrix with row stride sn,
// widened to f32, into a transposed tile dst[c * kPad + r]
template <typename T, int DH>
__device__ __forceinline__ void stage_t(float* dst, const T* head,
                                        long long sn, int r0) {
  for (int e = threadIdx.x; e < kT * DH; e += kThreads) {
    const int r = e / DH, c = e % DH;
    dst[c * kPad + r] = to_f32<T>(head[(long long)(r0 + r) * sn + c]);
  }
}

// the same rows kept row-major, dst[r * DH + c]
template <typename T, int DH>
__device__ __forceinline__ void stage_rows(float* dst, const T* head,
                                           long long sn, int r0) {
  for (int e = threadIdx.x; e < kT * DH; e += kThreads) {
    const int r = e / DH, c = e % DH;
    dst[e] = to_f32<T>(head[(long long)(r0 + r) * sn + c]);
  }
}

// s[i][j] = sum_c A[c][4 rg + i] * B[c][cg + 16 j] over transposed tiles,
// the product a . b in the order every kernel here uses
template <int DH>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* A,
                                         const float* Bt, int rg, int cg) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int c = 0; c < DH; ++c) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = A[c * kPad + rg * 4 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = Bt[c * kPad + cg + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
  }
}

// ------------------------------------------------------------------ forward
template <int DH>
constexpr int fwd_smem_floats() {
  return 2 * DH * kPad + kT * DH + kT * kPad + kT;
}

template <int DH>
__global__ void __launch_bounds__(kThreads) fwd_kernel(const Args a) {
  constexpr int DPT = DH / 16;
  extern __shared__ float smem[];
  float* Qt = smem;               // [DH][kPad]
  float* Kt = Qt + DH * kPad;     // [DH][kPad]
  float* Vs = Kt + DH * kPad;     // [kT][DH]
  float* Pt = Vs + kT * DH;       // [key][query], kPad
  float* Km = Pt + kT * kPad;     // key mask as 0/1

  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int N = a.N;
  const long long ih = b * a.isb + h * a.ish;
  const float* qh = static_cast<const float*>(a.q) + ih;
  const float* kh = static_cast<const float*>(a.k) + ih;
  const float* vh = static_cast<const float*>(a.v) + ih;
  const unsigned char* mrow = a.mask + (long long)b * N;
  const unsigned base = hash_base(a.hash, a.seed, b, h);

  stage_t<float, DH>(Qt, qh, a.isn, q0);
  auto stage_keys = [&](int k0, bool with_v) {
    __syncthreads();  // the previous tile's readers are done
    stage_t<float, DH>(Kt, kh, a.isn, k0);
    if (with_v) stage_rows<float, DH>(Vs, vh, a.isn, k0);
    if (tid < kT) Km[tid] = mrow[k0 + tid] != 0 ? 1.f : 0.f;
    __syncthreads();
  };
  auto scores = [&](float (&s)[4][4]) {
    tile_dot<DH>(s, Qt, Kt, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[i][j] = Km[cg + 16 * j] != 0.f ? -INFINITY : s[i][j] * a.scale;
  };
  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < DPT; ++t) acc[i][t] = 0.f;
  auto accumulate = [&]() {  // acc += Pt . V
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
  };

  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  if (!a.online) {
    // pass 1: the row max and the sum of exp(s - max), online over tiles
    for (int k0 = 0; k0 < N; k0 += kT) {
      stage_keys(k0, false);
      float s[4][4];
      scores(s);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) mx = fmaxf(mx, s[i][j]);
        const float m_new = fmaxf(m[i], group_max<16>(mx));
        const bool none = m_new == -INFINITY;  // no unpadded key yet
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) rs += none ? 0.f : expf(s[i][j] - m_new);
        rs = group_sum<16>(rs);
        const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - m_new);
        l[i] = l[i] * corr + rs;
        m[i] = m_new;
      }
    }
    // pass 2: p = e / l, dropped, then P.V
    for (int k0 = 0; k0 < N; k0 += kT) {
      stage_keys(k0, true);
      float s[4][4];
      scores(s);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + rg * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kj = cg + 16 * j;
          const float p = expf(s[i][j] - m[i]) / l[i];
          const float pd =
              keep_bit(base, qi, k0 + kj, a.thr) ? p * a.kscale : 0.f;
          Pt[kj * kPad + rg * 4 + i] = pd;
        }
      }
      accumulate();
    }
  } else {
    // one pass: the denominator sums the raw e, the dropped unnormalised e
    // is accumulated
    for (int k0 = 0; k0 < N; k0 += kT) {
      stage_keys(k0, true);
      float s[4][4];
      scores(s);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + rg * 4 + i;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) mx = fmaxf(mx, s[i][j]);
        const float m_new = fmaxf(m[i], group_max<16>(mx));
        const bool dead = m_new < kDead;
        const float m_safe = dead ? 0.f : m_new;
        const float corr = m[i] < kDead ? 0.f : expf(m[i] - m_safe);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kj = cg + 16 * j;
          const float e = dead ? 0.f : expf(s[i][j] - m_safe);
          rs += e;
          const float eu =
              keep_bit(base, qi, k0 + kj, a.thr) ? e * a.kscale : 0.f;
          Pt[kj * kPad + rg * 4 + i] = eu;
        }
        l[i] = l[i] * corr + group_sum<16>(rs);
        m[i] = m_new;
#pragma unroll
        for (int t = 0; t < DPT; ++t) acc[i][t] *= corr;
      }
      accumulate();
    }
  }

  const long long oh = b * a.osb + h * a.osh;
  const long long sh = ((long long)b * a.H + h) * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg * 4 + i;
    float f = 1.f, ls = m[i] + logf(l[i]);
    if (a.online) {
      const bool empty = l[i] == 0.f;
      f = empty ? 0.f : 1.f / l[i];
      ls = empty ? -INFINITY : ls;
    }
    float* orow = static_cast<float*>(a.out) + oh + (long long)qi * a.osn;
#pragma unroll
    for (int t = 0; t < DPT; ++t)
      orow[cg + 16 * t] = a.online ? acc[i][t] * f : acc[i][t];
    if (cg == 0 && a.lse != nullptr) a.lse[sh + qi] = ls;
  }
}

// ----------------------------------------------------------------- backward
template <int DH>
constexpr int dq_smem_floats() {
  return 4 * DH * kPad + kT * kPad + kT;
}

template <int DH>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Args a) {
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
  const int N = a.N;
  const long long ih = b * a.isb + h * a.ish;
  const long long oh = b * a.osb + h * a.osh;
  const long long sh = ((long long)b * a.H + h) * N;
  const float* kh = static_cast<const float*>(a.k) + ih;
  const float* vh = static_cast<const float*>(a.v) + ih;
  const float* dOh = static_cast<const float*>(a.dO) + oh;
  const unsigned char* mrow = a.mask + (long long)b * N;
  const unsigned base = hash_base(a.hash, a.seed, b, h);

  stage_t<float, DH>(Qt, static_cast<const float*>(a.q) + ih, a.isn, q0);
  stage_t<float, DH>(dOt, dOh, a.osn, q0);

  float lr[4];
  bool live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = a.lse[sh + q0 + rg * 4 + i];
    live[i] = !a.guard || x >= kDead;
    lr[i] = live[i] ? x : 0.f;
  }
  auto stage_keys = [&](int k0) {
    __syncthreads();
    stage_t<float, DH>(Kt, kh, a.isn, k0);
    stage_t<float, DH>(Vt, vh, a.isn, k0);
    if (tid < kT) Km[tid] = mrow[k0 + tid] != 0 ? 1.f : 0.f;
    __syncthreads();
  };
  // p and the dropped dp = keep * (dO . v) * kscale of one key tile
  auto probs = [&](int k0, float (&p)[4][4], float (&g)[4][4]) {
    float s[4][4], dp[4][4];
    tile_dot<DH>(s, Qt, Kt, rg, cg);
    tile_dot<DH>(dp, dOt, Vt, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = cg + 16 * j;
        const float sv = Km[kj] != 0.f ? -INFINITY : s[i][j] * a.scale;
        p[i][j] = live[i] ? expf(sv - lr[i]) : 0.f;
        g[i][j] =
            keep_bit(base, qi, k0 + kj, a.thr) ? dp[i][j] * a.kscale : 0.f;
      }
    }
  };

  float Dr[4];
  if (a.d_from_o) {
    const float* o = static_cast<const float*>(a.o) + oh;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long row = (long long)(q0 + rg * 4 + i) * a.osn;
      float part = 0.f;
#pragma unroll
      for (int t = 0; t < DPT; ++t)
        part += dOh[row + cg + 16 * t] * o[row + cg + 16 * t];
      Dr[i] = group_sum<16>(part);
    }
  } else {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < N; k0 += kT) {
      stage_keys(k0);
      float p[4][4], g[4][4];
      probs(k0, p, g);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i] += g[i][j] * p[i][j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) Dr[i] = group_sum<16>(part[i]);
  }
  if (cg == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a.D[sh + q0 + rg * 4 + i] = Dr[i];
  }

  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < DPT; ++t) acc[i][t] = 0.f;
  for (int k0 = 0; k0 < N; k0 += kT) {
    stage_keys(k0);
    float p[4][4], g[4][4];
    probs(k0, p, g);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dSs[(rg * 4 + i) * kPad + cg + 16 * j] = p[i][j] * (g[i][j] - Dr[i]);
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
        for (int t = 0; t < DPT; ++t) acc[i][t] = fmaf(sa[i], kb[t], acc[i][t]);
    }
  }

  float* dqh = static_cast<float*>(a.dq) + ih;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = dqh + (long long)(q0 + rg * 4 + i) * a.isn;
#pragma unroll
    for (int t = 0; t < DPT; ++t)
      row[cg + 16 * t] = acc[i][t] * a.scale;
  }
}

// thread (rg, cg) holds keys 4 rg + i and queries cg + 16 j of each
// transposed score tile
template <int DH>
constexpr int dkdv_smem_floats() {
  return 4 * DH * kPad + 2 * kT * kPad + 3 * kT;
}

template <int DH>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const Args a) {
  constexpr int DPT = DH / 16;
  extern __shared__ float smem[];
  float* Kt = smem;
  float* Vt = Kt + DH * kPad;
  float* Qt = Vt + DH * kPad;
  float* dOt = Qt + DH * kPad;
  float* PdT = dOt + DH * kPad;  // [key][query], kPad
  float* dST = PdT + kT * kPad;  // [key][query], kPad
  float* Lq = dST + kT * kPad;   // lse, 0 where the row is dead
  float* Lv = Lq + kT;           // 1 where the row is live
  float* Dq = Lv + kT;

  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int k0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int N = a.N;
  const long long ih = b * a.isb + h * a.ish;
  const long long oh = b * a.osb + h * a.osh;
  const long long sh = ((long long)b * a.H + h) * N;
  const float* qh = static_cast<const float*>(a.q) + ih;
  const float* dOh = static_cast<const float*>(a.dO) + oh;
  const unsigned base = hash_base(a.hash, a.seed, b, h);

  stage_t<float, DH>(Kt, static_cast<const float*>(a.k) + ih, a.isn, k0);
  stage_t<float, DH>(Vt, static_cast<const float*>(a.v) + ih, a.isn, k0);
  bool km[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    km[i] = a.mask[(long long)b * N + k0 + rg * 4 + i] != 0;

  float dka[4][DPT], dva[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < DPT; ++t) dka[i][t] = dva[i][t] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kT) {
    __syncthreads();
    stage_t<float, DH>(Qt, qh, a.isn, q0);
    stage_t<float, DH>(dOt, dOh, a.osn, q0);
    if (tid < kT) {
      const float x = a.lse[sh + q0 + tid];
      const bool live = !a.guard || x >= kDead;
      Lq[tid] = live ? x : 0.f;
      Lv[tid] = live ? 1.f : 0.f;
      Dq[tid] = a.D[sh + q0 + tid];
    }
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
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
      // q . k and dO . v in the operand order of the other kernels
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
        const float sv = km[i] ? -INFINITY : s[i][j] * a.scale;
        const float p = Lv[qj] != 0.f ? expf(sv - Lq[qj]) : 0.f;
        const bool keep = keep_bit(base, q0 + qj, key, a.thr);
        const float g = keep ? dp[i][j] * a.kscale : 0.f;
        PdT[(rg * 4 + i) * kPad + qj] = keep ? p * a.kscale : 0.f;
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
          dva[i][t] = fmaf(pa[i], gb[t], dva[i][t]);
          dka[i][t] = fmaf(sa[i], qb[t], dka[i][t]);
        }
    }
  }

  float* dkh = static_cast<float*>(a.dk) + ih;
  float* dvh = static_cast<float*>(a.dv) + ih;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = (long long)(k0 + rg * 4 + i) * a.isn;
#pragma unroll
    for (int t = 0; t < DPT; ++t) {
      dkh[row + cg + 16 * t] = dka[i][t] * a.scale;
      dvh[row + cg + 16 * t] = dva[i][t];
    }
  }
}

// ------------------------------------------------------------------ launches
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, int bytes) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// head_dim 16, 32, 64 or 128 (ops/_cuda.HEAD_DIMS)
inline bool head_dim_ok(int Dh) {
  return Dh == 16 || Dh == 32 || Dh == 64 || Dh == 128;
}

inline bool shape_ok(int B, int H, int N, int Dh) {
  return B > 0 && H > 0 && N > 0 && N % kT == 0 && B <= 65535 &&
         H <= 65535 && head_dim_ok(Dh);
}

template <int DH>
cudaError_t launch_fwd(const Args& a, int B, cudaStream_t s) {
  const int bytes = fwd_smem_floats<DH>() * (int)sizeof(float);
  cudaError_t err = allow_smem(fwd_kernel<DH>, bytes);
  if (err != cudaSuccess) return err;
  fwd_kernel<DH><<<dim3(a.N / kT, a.H, B), kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

// dq_kernel writes D, which dkdv_kernel reads after it on the same stream
template <int DH>
cudaError_t launch_bwd(const Args& a, int B, cudaStream_t s) {
  const int dq_bytes = dq_smem_floats<DH>() * (int)sizeof(float);
  const int kv_bytes = dkdv_smem_floats<DH>() * (int)sizeof(float);
  cudaError_t err = allow_smem(dq_kernel<DH>, dq_bytes);
  if (err == cudaSuccess) err = allow_smem(dkdv_kernel<DH>, kv_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.N / kT, a.H, B);
  dq_kernel<DH><<<grid, kThreads, dq_bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<DH><<<grid, kThreads, kv_bytes, s>>>(a);
  return cudaGetLastError();
}

// Dispatch on head_dim (shape_ok's). At 128 the dK/dV kernel takes 167 KB
// of shared memory and the dQ kernel 150 KB: one CTA per SM.
inline cudaError_t launch_fwd_dh(const Args& a, int B, int Dh,
                                 cudaStream_t s) {
  switch (Dh) {
    case 16: return launch_fwd<16>(a, B, s);
    case 32: return launch_fwd<32>(a, B, s);
    case 64: return launch_fwd<64>(a, B, s);
    case 128: return launch_fwd<128>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

inline cudaError_t launch_bwd_dh(const Args& a, int B, int Dh,
                                 cudaStream_t s) {
  switch (Dh) {
    case 16: return launch_bwd<16>(a, B, s);
    case 32: return launch_bwd<32>(a, B, s);
    case 64: return launch_bwd<64>(a, B, s);
    case 128: return launch_bwd<128>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace attn
}  // namespace vs
