// ring_attention: one step of sequence-parallel ring attention for sm_90a,
// folding one K/V block into an online-softmax carry, forward and backward.
//
// Replaces the TPU kernels of vidsum_tpu/parallel/ring_attention.py:
//   _ring_block_kernel      -> vs_ring_fwd, dropout 0 (inference; K/V float
//                              or bf16, widened exactly as the JAX step
//                              upcasts them)
//   _ring_train_fwd_kernel  -> vs_ring_fwd, dropout 1 (all float)
//   _ring_train_bwd_kernel  -> vs_ring_bwd (all float)
// Layouts: q (B, H, Nq, DH) float, pre-scaled; k, v (B, H, Nk, DH); the key
// mask (B, Nk) bytes, nonzero = padded; the carries o (B, H, Nq, DH) float,
// unnormalised, and m, l (B, H, Nq, 1) float; the backward's g, dq (B, H, Nq,
// DH), dk, dv (B, H, Nk, DH) and D (B, H, Nq, 1), all float.
//
// Carry mode. The forward reads (o, m, l), folds the block in 64-key tiles
//   m_new = max(m, rowmax s); dead = m_new < _DEAD; corr = 0 where m < _DEAD
//   p = dead ? 0 : exp(s - m_new); l = l corr + sum p; o = o corr + p~ . v
// with p~ = p dropped (keep * 1/(1-rate)) for the o accumulation only, and
// writes the unnormalised (o, m, l) to separate outputs: each CTA owns 64
// query rows, reads their carry before its loop and writes it after, so no
// launch touches another shard's carry. A block whose keys are all padded
// leaves the carry unchanged bit for bit (corr = 1, p = 0). The fold over
// 64-key tiles rescales per tile where the TPU kernel rescales once per
// block: the same operations in another order of rounding.
// The backward recomputes s from q and the block, w = exp(s - m) / l from
// the saved m and l (not exp(s - lse): the TPU kernel's rounding), and adds
//   dv += w~^T g, ds = w (keep inv dp - D), dq += ds . k, dk += ds^T . q
// to dq_in, dk_in, dv_in: ring_dq_kernel per 64-query tile (dq), ring_dkdv
// per 64-key tile, looping over the query tiles (dk, dv). No atomics: two
// runs give identical bits. D = rowsum(g * out), the q pre-scale and the
// final dq * scale stay outside, as in the JAX package.
//
// Dropout bits: attention_core.cuh's kHashBlock family (the fused training
// block's _hash_keep, site = head) at global coordinates: batch b0 + b, row
// q0 + query, column k0 + key, with (b0, q0, k0) the shard's offsets from
// the TPU kernel's info operand; uint32 arithmetic that wraps.
//
// Bound on the card: 4 * B*H*Nq*Nk*DH operations forward, 10 * ... backward
// (recompute included), against a few (B, H, N, DH) tensors read and
// written: operation-bound. Everything is f32 FMA (no TF32), so the bound is
// the card's 67 TFLOP/s f32 peak outside the tensor cores: 0.26 ms for one
// forward step at (B, H, Nl, DH) = (1, 4, 4096, 64). Design: attention_core's
// tiles, 64 x 64 scores per CTA of 256 threads in 4 x 4 register blocks over
// transposed, padded shared-memory tiles (conflict-free reads); nothing of
// size Nq x Nk reaches device memory; no load overlaps compute yet.
#include "attention_core.cuh"

namespace {

using vs::attn::hash_base;
using vs::attn::kDead;
using vs::attn::keep_bit;
using vs::attn::kHashBlock;
using vs::attn::kPad;
using vs::attn::kT;
using vs::attn::kThreads;
using vs::attn::stage_rows;
using vs::attn::stage_t;
using vs::attn::tile_dot;

struct RingArgs {
  const float* q;
  const void* k;
  const void* v;
  const unsigned char* mask;
  const float* o_in;   // forward carry in
  const float* m_in;   // forward carry in; the backward's saved m
  const float* l_in;   // forward carry in; the backward's saved l
  float* o_out;
  float* m_out;
  float* l_out;
  const float* g;      // backward: d out, (B, H, Nq, DH)
  const float* D;      // backward: rowsum(g * out), (B, H, Nq, 1)
  const float* dq_in;
  const float* dk_in;
  const float* dv_in;
  float* dq_out;
  float* dk_out;
  float* dv_out;
  int H, Nq, Nk;
  unsigned seed, thr;
  float kscale;        // 1 / (1 - rate) rounded to f32
  int b0, q0, k0;      // the shard's global batch, query and key offsets
};

// ------------------------------------------------------------------ forward
template <int DH>
constexpr int fwd_smem_floats() {
  return 2 * DH * kPad + kT * DH + kT * kPad + kT;
}

template <typename KV, int DH, bool DROP>
__global__ void __launch_bounds__(kThreads) ring_fwd_kernel(const RingArgs a) {
  constexpr int DPT = DH / 16;
  extern __shared__ float smem[];
  float* Qt = smem;               // [DH][kPad]
  float* Kt = Qt + DH * kPad;     // [DH][kPad]
  float* Vs = Kt + DH * kPad;     // [kT][DH]
  float* Pt = Vs + kT * DH;       // [key][query], kPad
  float* Km = Pt + kT * kPad;     // key mask as 0/1

  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const long long rq = ((long long)b * a.H + h) * a.Nq;  // first row of q
  const long long rk = ((long long)b * a.H + h) * a.Nk;
  const KV* kh = static_cast<const KV*>(a.k) + rk * DH;
  const KV* vh = static_cast<const KV*>(a.v) + rk * DH;
  const unsigned char* mrow = a.mask + (long long)b * a.Nk;
  const unsigned base = DROP ? hash_base(kHashBlock, a.seed, a.b0 + b, h) : 0u;

  stage_t<float, DH>(Qt, a.q + rq * DH, DH, q0);
  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = rq + q0 + rg * 4 + i;
    m[i] = a.m_in[row];
    l[i] = a.l_in[row];
#pragma unroll
    for (int t = 0; t < DPT; ++t) acc[i][t] = a.o_in[row * DH + cg + 16 * t];
  }

  for (int k0 = 0; k0 < a.Nk; k0 += kT) {
    __syncthreads();  // the previous tile's readers are done
    stage_t<KV, DH>(Kt, kh, DH, k0);
    stage_rows<KV, DH>(Vs, vh, DH, k0);
    if (tid < kT) Km[tid] = mrow[k0 + tid] != 0 ? 1.f : 0.f;
    __syncthreads();
    float s[4][4];
    tile_dot<DH>(s, Qt, Kt, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = a.q0 + q0 + rg * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (Km[cg + 16 * j] != 0.f) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], vs::group_max<16>(mx));
      const bool dead = m_new < kDead;
      const float m_safe = dead ? 0.f : m_new;
      const float corr = m[i] < kDead ? 0.f : expf(m[i] - m_safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = cg + 16 * j;
        const float p = dead ? 0.f : expf(s[i][j] - m_safe);
        rs += p;
        float pu = p;
        if (DROP)
          pu = keep_bit(base, qi, a.k0 + k0 + kj, a.thr) ? p * a.kscale : 0.f;
        Pt[kj * kPad + rg * 4 + i] = pu;
      }
      l[i] = l[i] * corr + vs::group_sum<16>(rs);
      m[i] = m_new;
#pragma unroll
      for (int t = 0; t < DPT; ++t) acc[i][t] *= corr;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kT; ++kk) {  // acc += Pt . V
      float pa[4], vb[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Pt[kk * kPad + rg * 4 + i];
#pragma unroll
      for (int t = 0; t < DPT; ++t) vb[t] = Vs[kk * DH + cg + 16 * t];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int t = 0; t < DPT; ++t) acc[i][t] = fmaf(pa[i], vb[t], acc[i][t]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = rq + q0 + rg * 4 + i;
#pragma unroll
    for (int t = 0; t < DPT; ++t) a.o_out[row * DH + cg + 16 * t] = acc[i][t];
    if (cg == 0) {
      a.m_out[row] = m[i];
      a.l_out[row] = l[i];
    }
  }
}

// ----------------------------------------------------------------- backward
// The per-row statistics of the backward: m_safe, the live flag, 1 / l_safe
// is not used (w = e / l is a division, as on the TPU).
__device__ __forceinline__ void row_stats(const RingArgs& a, long long row,
                                          float& m_safe, bool& dead,
                                          float& l_safe, float& d) {
  const float m = a.m_in[row], l = a.l_in[row];
  dead = m < kDead;
  m_safe = dead ? 0.f : m;
  l_safe = l == 0.f ? 1.f : l;
  d = a.D[row];
}

template <int DH>
constexpr int dq_smem_floats() {
  return 4 * DH * kPad + kT * kPad + kT;
}

template <int DH>
__global__ void __launch_bounds__(kThreads) ring_dq_kernel(const RingArgs a) {
  constexpr int DPT = DH / 16;
  extern __shared__ float smem[];
  float* Qt = smem;               // [DH][kPad]
  float* Gt = Qt + DH * kPad;
  float* Kt = Gt + DH * kPad;
  float* Vt = Kt + DH * kPad;
  float* dSs = Vt + DH * kPad;    // [query][key], kPad
  float* Km = dSs + kT * kPad;

  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const long long rq = ((long long)b * a.H + h) * a.Nq;
  const long long rk = ((long long)b * a.H + h) * a.Nk;
  const float* kh = static_cast<const float*>(a.k) + rk * DH;
  const float* vh = static_cast<const float*>(a.v) + rk * DH;
  const unsigned char* mrow = a.mask + (long long)b * a.Nk;
  const unsigned base = hash_base(kHashBlock, a.seed, a.b0 + b, h);

  stage_t<float, DH>(Qt, a.q + rq * DH, DH, q0);
  stage_t<float, DH>(Gt, a.g + rq * DH, DH, q0);
  float ms[4], ls[4], dr[4];
  bool dead[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    row_stats(a, rq + q0 + rg * 4 + i, ms[i], dead[i], ls[i], dr[i]);

  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < DPT; ++t) acc[i][t] = 0.f;
  for (int k0 = 0; k0 < a.Nk; k0 += kT) {
    __syncthreads();
    stage_t<float, DH>(Kt, kh, DH, k0);
    stage_t<float, DH>(Vt, vh, DH, k0);
    if (tid < kT) Km[tid] = mrow[k0 + tid] != 0 ? 1.f : 0.f;
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<DH>(s, Qt, Kt, rg, cg);
    tile_dot<DH>(dp, Gt, Vt, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = a.q0 + q0 + rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = cg + 16 * j;
        const float e =
            (Km[kj] != 0.f || dead[i]) ? 0.f : expf(s[i][j] - ms[i]);
        const float w = e / ls[i];
        const float kp =
            keep_bit(base, qi, a.k0 + k0 + kj, a.thr) ? a.kscale : 0.f;
        dSs[(rg * 4 + i) * kPad + kj] = w * (kp * dp[i][j] - dr[i]);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kT; ++kk) {  // acc += dS . K
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = (rq + q0 + rg * 4 + i) * DH;
#pragma unroll
    for (int t = 0; t < DPT; ++t) {
      const int c = cg + 16 * t;
      a.dq_out[row + c] = a.dq_in[row + c] + acc[i][t];
    }
  }
}

// thread (rg, cg) holds keys 4 rg + i and queries cg + 16 j of each
// transposed score tile
template <int DH>
constexpr int dkdv_smem_floats() {
  return 4 * DH * kPad + 2 * kT * kPad + 4 * kT;
}

template <int DH>
__global__ void __launch_bounds__(kThreads) ring_dkdv_kernel(const RingArgs a) {
  constexpr int DPT = DH / 16;
  extern __shared__ float smem[];
  float* Kt = smem;               // [DH][kPad]
  float* Vt = Kt + DH * kPad;
  float* Qt = Vt + DH * kPad;
  float* Gt = Qt + DH * kPad;
  float* WdT = Gt + DH * kPad;    // [key][query], kPad
  float* dST = WdT + kT * kPad;   // [key][query], kPad
  float* Mq = dST + kT * kPad;    // m_safe of each query row
  float* Dd = Mq + kT;            // 1 where the row is dead
  float* Lq = Dd + kT;            // l_safe
  float* Dq = Lq + kT;            // D

  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int k0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const long long rq = ((long long)b * a.H + h) * a.Nq;
  const long long rk = ((long long)b * a.H + h) * a.Nk;
  const unsigned base = hash_base(kHashBlock, a.seed, a.b0 + b, h);

  stage_t<float, DH>(Kt, static_cast<const float*>(a.k) + rk * DH, DH, k0);
  stage_t<float, DH>(Vt, static_cast<const float*>(a.v) + rk * DH, DH, k0);
  bool km[4];
  float dka[4][DPT], dva[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = rk + k0 + rg * 4 + i;
    km[i] = a.mask[(long long)b * a.Nk + k0 + rg * 4 + i] != 0;
#pragma unroll
    for (int t = 0; t < DPT; ++t) {
      dka[i][t] = a.dk_in[row * DH + cg + 16 * t];
      dva[i][t] = a.dv_in[row * DH + cg + 16 * t];
    }
  }

  for (int q0 = 0; q0 < a.Nq; q0 += kT) {
    __syncthreads();
    stage_t<float, DH>(Qt, a.q + rq * DH, DH, q0);
    stage_t<float, DH>(Gt, a.g + rq * DH, DH, q0);
    if (tid < kT) {
      float ms, ls, dr;
      bool dead;
      row_stats(a, rq + q0 + tid, ms, dead, ls, dr);
      Mq[tid] = ms;
      Dd[tid] = dead ? 1.f : 0.f;
      Lq[tid] = ls;
      Dq[tid] = dr;
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
        gb[j] = Gt[c * kPad + cg + 16 * j];
      }
      // q . k and g . v in the operand order of ring_dq_kernel
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
      const int key = a.k0 + k0 + rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qj = cg + 16 * j;
        const float e =
            (km[i] || Dd[qj] != 0.f) ? 0.f : expf(s[i][j] - Mq[qj]);
        const float w = e / Lq[qj];
        const float kp =
            keep_bit(base, a.q0 + q0 + qj, key, a.thr) ? a.kscale : 0.f;
        WdT[(rg * 4 + i) * kPad + qj] = w * kp;
        dST[(rg * 4 + i) * kPad + qj] = w * (kp * dp[i][j] - Dq[qj]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int qq = 0; qq < kT; ++qq) {  // dv += Wd^T . g, dk += dS^T . q
      float pa[4], sa[4], gb[DPT], qb[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = WdT[(rg * 4 + i) * kPad + qq];
        sa[i] = dST[(rg * 4 + i) * kPad + qq];
      }
#pragma unroll
      for (int t = 0; t < DPT; ++t) {
        gb[t] = Gt[(cg + 16 * t) * kPad + qq];
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = (rk + k0 + rg * 4 + i) * DH;
#pragma unroll
    for (int t = 0; t < DPT; ++t) {
      a.dk_out[row + cg + 16 * t] = dka[i][t];
      a.dv_out[row + cg + 16 * t] = dva[i][t];
    }
  }
}

// ------------------------------------------------------------------ launches
bool shape_ok(int B, int H, int Nq, int Nk, int Dh) {
  return B > 0 && H > 0 && Nq > 0 && Nk > 0 && Nq % kT == 0 &&
         Nk % kT == 0 && B <= 65535 && H <= 65535 &&
         vs::attn::head_dim_ok(Dh);
}



template <typename KV, int DH, bool DROP>
cudaError_t launch_fwd(const RingArgs& a, int B, cudaStream_t s) {
  const int bytes = fwd_smem_floats<DH>() * (int)sizeof(float);
  cudaError_t err =
      vs::attn::allow_smem(ring_fwd_kernel<KV, DH, DROP>, bytes);
  if (err != cudaSuccess) return err;
  ring_fwd_kernel<KV, DH, DROP>
      <<<dim3(a.Nq / kT, a.H, B), kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bwd(const RingArgs& a, int B, cudaStream_t s) {
  const int dq_bytes = dq_smem_floats<DH>() * (int)sizeof(float);
  const int kv_bytes = dkdv_smem_floats<DH>() * (int)sizeof(float);
  cudaError_t err = vs::attn::allow_smem(ring_dq_kernel<DH>, dq_bytes);
  if (err == cudaSuccess)
    err = vs::attn::allow_smem(ring_dkdv_kernel<DH>, kv_bytes);
  if (err != cudaSuccess) return err;
  ring_dq_kernel<DH><<<dim3(a.Nq / kT, a.H, B), kThreads, dq_bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ring_dkdv_kernel<DH><<<dim3(a.Nk / kT, a.H, B), kThreads, kv_bytes, s>>>(a);
  return cudaGetLastError();
}

// Dispatch on head_dim (16, 32, 64, 96 or 128)
template <typename KV, bool DROP>
cudaError_t launch_fwd_dh(const RingArgs& a, int B, int Dh, cudaStream_t s) {
  switch (Dh) {
    case 16: return launch_fwd<KV, 16, DROP>(a, B, s);
    case 32: return launch_fwd<KV, 32, DROP>(a, B, s);
    case 64: return launch_fwd<KV, 64, DROP>(a, B, s);
    case 96: return launch_fwd<KV, 96, DROP>(a, B, s);
    case 128: return launch_fwd<KV, 128, DROP>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_bwd_dh(const RingArgs& a, int B, int Dh, cudaStream_t s) {
  switch (Dh) {
    case 16: return launch_bwd<16>(a, B, s);
    case 32: return launch_bwd<32>(a, B, s);
    case 64: return launch_bwd<64>(a, B, s);
    case 96: return launch_bwd<96>(a, B, s);
    case 128: return launch_bwd<128>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// kv_dtype: 0 float, 1 bf16 (ops/_cuda.DTYPE_CODES; dropout takes float
// only); dropout 0 is _ring_block_kernel, 1 _ring_train_fwd_kernel with the
// bits of (seed, b0, q0, k0) at threshold thr (0 keeps every weight)
extern "C" int vs_ring_fwd(const float* q, const void* k, const void* v,
                           const unsigned char* mask, const float* o_in,
                           const float* m_in, const float* l_in, float* o_out,
                           float* m_out, float* l_out, int B, int H, int Nq,
                           int Nk, int Dh, int kv_dtype, int dropout,
                           unsigned seed, int b0, int q0, int k0,
                           unsigned thr, float kscale, void* stream) {
  if (!shape_ok(B, H, Nq, Nk, Dh) ||
      !(kv_dtype == vs::kF32 || (kv_dtype == vs::kBF16 && !dropout)))
    return (int)cudaErrorInvalidValue;
  RingArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = mask;
  a.o_in = o_in;
  a.m_in = m_in;
  a.l_in = l_in;
  a.o_out = o_out;
  a.m_out = m_out;
  a.l_out = l_out;
  a.H = H;
  a.Nq = Nq;
  a.Nk = Nk;
  a.seed = seed;
  a.thr = thr;
  a.kscale = kscale;
  a.b0 = b0;
  a.q0 = q0;
  a.k0 = k0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dropout)
    err = launch_fwd_dh<float, true>(a, B, Dh, s);
  else if (kv_dtype == vs::kF32)
    err = launch_fwd_dh<float, false>(a, B, Dh, s);
  else
    err = launch_fwd_dh<__nv_bfloat16, false>(a, B, Dh, s);
  return (int)err;
}

// the backward of one ring step: (dq, dk, dv)_out = (dq, dk, dv)_in + this
// block's terms
extern "C" int vs_ring_bwd(const float* q, const float* k, const float* v,
                           const float* g, const float* D, const float* m,
                           const float* l, const unsigned char* mask,
                           const float* dq_in, const float* dk_in,
                           const float* dv_in, float* dq_out, float* dk_out,
                           float* dv_out, int B, int H, int Nq, int Nk, int Dh,
                           unsigned seed, int b0, int q0, int k0,
                           unsigned thr, float kscale, void* stream) {
  if (!shape_ok(B, H, Nq, Nk, Dh)) return (int)cudaErrorInvalidValue;
  RingArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = mask;
  a.m_in = m;
  a.l_in = l;
  a.g = g;
  a.D = D;
  a.dq_in = dq_in;
  a.dk_in = dk_in;
  a.dv_in = dv_in;
  a.dq_out = dq_out;
  a.dk_out = dk_out;
  a.dv_out = dv_out;
  a.H = H;
  a.Nq = Nq;
  a.Nk = Nk;
  a.seed = seed;
  a.thr = thr;
  a.kscale = kscale;
  a.b0 = b0;
  a.q0 = q0;
  a.k0 = k0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)launch_bwd_dh(a, B, Dh, s);
}
