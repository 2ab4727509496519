// ring_attention: one step of sequence-parallel ring attention for sm_90a,
// folding one K/V block into an online-softmax carry, forward and backward.
//
// Replaces the TPU kernels of vidsum_tpu/parallel/ring_attention.py:
//   _ring_block_kernel      -> vs_ring_fwd at rate 0 (inference; the
//                              wrapper widens bf16 K/V to f32 first, as the
//                              JAX step upcasts them at its call)
//   _ring_train_fwd_kernel  -> vs_ring_fwd with the dropout bits
//   _ring_train_bwd_kernel  -> vs_ring_bwd (ring_dq_kernel, ring_dkdv_kernel)
// Layouts: q (B, H, Nq, DH) f32, pre-scaled; k, v (B, H, Nk, DH) f32; the key
// mask (B, Nk) bytes, nonzero = padded; the carries o (B, H, Nq, DH) f32,
// unnormalised, and m, l (B, H, Nq, 1) f32; the backward's g, dq (B, H, Nq,
// DH), dk, dv (B, H, Nk, DH) and D (B, H, Nq, 1), all f32, contiguous, every
// base on 16 bytes (the wrappers see to it). Nq and Nk are multiples of the
// 64-key tile.
//
// Carry mode. The forward reads (o, m, l), folds the block's live 64-key
// tiles in order
//   m_new = max(m, rowmax s); dead = m_new < _DEAD; m_safe = dead ? 0 : m_new
//   corr = m < _DEAD ? 0 : 2^((m - m_safe) log2 e)
//   p = dead ? 0 : 2^((s - m_safe) log2 e); l = l corr + sum p
//   o = o corr + p~ . v
// with p~ = p dropped (keep * 1/(1-rate)) for the o accumulation only, and
// writes the unnormalised (o, m, l) to separate outputs: each CTA owns its
// query rows, reads their carry before its loop and writes it after, so no
// launch writes its inputs. m stays in natural units (the scores are not
// pre-scaled by log2 e; only the exponent's argument is), so a CTA of a
// block with no unpadded key, which walks no tile, copies its carry through
// bit for bit. The fold rescales per tile where the TPU kernel rescales once
// per block: the same operations in another order of rounding.
// The backward recomputes s and dp from q, g and the block, w = e / l as
// e * (1 / l) from the saved m and l (e = 2^((s - m) log2 e); not
// exp(s - lse)), and adds
//   dv += w~^T g, ds = w (keep inv dp - D), dq += ds . k, dk += ds^T . q
// to dq_in, dk_in, dv_in: ring_dq_kernel per query rows over the live key
// tiles (dq), ring_dkdv_kernel per keys over every query tile (dk, dv). A
// block with no unpadded key leaves dq_in, and a CTA whose keys are all
// padded dk_in and dv_in, unchanged. No atomics: two runs give identical
// bits. D = rowsum(g * out), the q pre-scale and the final dq * scale stay
// outside, as in the JAX package.
//
// Dropout bits: attention_core.cuh's kHashBlock family (the fused training
// block's _hash_keep, site = head) at global coordinates: batch b0 + b, row
// q0 + query, column k0 + key, with (b0, q0, k0) the shard's offsets from
// the TPU kernel's info operand; uint32 arithmetic that wraps. At rate 0
// keep_bit returns before hashing, so kernel 15 hashes nothing.
//
// Bound on the card: 4 * B*H*Nq*Nk*DH operations forward, 10 * ... backward
// (recompute included; the kernels issue 7 FMAs a (query, key) pair per
// column against the bound's 5: dq and dk/dv each recompute s and dp),
// against a few (B, H, N, DH) tensors read and written: operation-bound.
// Everything is f32 FMA (no TF32: the TPU kernels compute in f32), so the
// bound is the card's 67 TFLOP/s f32 peak outside the tensor cores: 0.26 ms
// for one forward step at (B, H, Nl, DH) = (1, 4, 4096, 64).
//
// Design: attention_core.cuh's FMA tiles (fma_stage, fma_scores,
// fma_rows_mul, PR 10's f32 training attention), in kernels of their own:
// 1. Shared-memory issue. A thread holds RI x 8 scores (8 x 8; 4 x 8 at
//    head_dim 96 and 128) read as float4 from row-major tiles of DH + 4
//    floats a row: per 4 columns, 8 + RI vector reads feed 32 RI FMAs, and
//    P.V, dS.K, pd^T.g and dS^T.q likewise (the first family's transposed
//    tiles fed 16 FMAs with 8 scalar reads).
// 2. Loads overlapped with compute. Tiles arrive by 16-byte cp.async: the
//    forward's K tile loads during the fold and P.V, its V tile during the
//    next scores; dQ double-buffers K/V with their mask bytes, dK/dV q/g with
//    their rows' m, l and D.
// 3. Live key tiles only. The forward and dQ walk the 64-key tiles of their
//    element that hold an unpadded key (mma_tiles.cuh's live_tiles): a
//    padded key adds exact zeros to every sum and nothing to any max. A
//    block with none walks no tile and passes its inputs through; so does a
//    dK/dV CTA whose keys are all padded, and a padded key's dk/dv rows.
// 4. Per score one ex2 (the MUFU unit) of (s - m_safe) log2 e, and one
//    multiply by the row's 1 / l in the backward, for expf and a division.
// 5. Two thread groups a backward CTA: in dQ group 0 computes s and w,
//    group 1 dp and ds, each half of dQ's columns; in dK/dV group 0 w, the
//    dropped w and dV, group 1 dp, ds and dK; each thread keeps one set of
//    accumulators.
// 6. CTA shapes for the ring's grids. A CTA holds RI rows a thread in 8 TY
//    threads a group. At head_dim <= 64 two shapes: (16, 8), 128 rows, two
//    forward CTAs an SM, and (16, 4), 64 rows at 156-168 registers, three;
//    the caller picks the one whose grid ends soonest on the card
//    (parallel/ring_attention.ring_cta_shape, with the occupancy that
//    vs_ring_slots reports): a 16,384-frame request's 4,096-row shards
//    fill a card only as 64-row CTAs. At 96 and 128 one: (16, 4), but
//    (8, 4) for dK/dV at 128.
// A row's operations, and so its bits, depend on neither the CTA shape nor
// the grid.
#include <initializer_list>

#include "attention_core.cuh"

namespace {

using vs::cp_async16;
using vs::cp_async_commit;
using vs::cp_async_wait;
using vs::ex2;
using vs::group_max;
using vs::group_sum;
using vs::kLog2e;
using vs::live_tiles;
using vs::attn::fma_col;
using vs::attn::fma_rows_mul;
using vs::attn::fma_scores;
using vs::attn::fma_stage;
using vs::attn::hash_base;
using vs::attn::kDead;
using vs::attn::keep_bit;
using vs::attn::kFmaCw;
using vs::attn::kFmaLd;
using vs::attn::kFmaRi;
using vs::attn::kHashBlock;
using vs::attn::kSj;
using vs::attn::kSLd;
using vs::attn::kT;
using vs::attn::kTx;
using vs::attn::ld_vec;
using vs::attn::st_vec;

struct RingArgs {
  const float* q;
  const float* k;
  const float* v;
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
  int nsl;             // the sliced kernels: 128-column slices of a head
};

// rows r0 .. r0 + rows - 1 (those below N) of a (N, DH) matrix, copied
template <int DH, int THREADS>
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int r0,
                                          int rows, int N) {
  constexpr int CH = DH / 4;
  const int n = min(rows, N - r0) * CH;
  for (int c = threadIdx.x; c < n; c += THREADS) {
    const long long e = (long long)(r0 + c / CH) * DH + (c % CH) * 4;
    *reinterpret_cast<float4*>(dst + e) =
        *reinterpret_cast<const float4*>(src + e);
  }
}

// in + acc (in where pass) into out at row `row`, the columns c0 +
// fma_col(tx, n) of a thread's accumulators
template <int DH, int COLS>
__device__ __forceinline__ void add_row(float* out, const float* in,
                                        const float (&acc)[COLS],
                                        long long row, int c0, int tx,
                                        bool pass) {
  constexpr int CW = kFmaCw<COLS>;
#pragma unroll
  for (int n = 0; n < COLS; n += CW) {
    const long long e = row * DH + c0 + fma_col<COLS>(tx, n);
    float x[CW];
    ld_vec<CW>(x, in + e);
    if (!pass) {
#pragma unroll
      for (int j = 0; j < CW; ++j) x[j] += acc[n + j];
    }
    st_vec<CW>(out + e, x);
  }
}

// ------------------------------------------------------------------ forward
template <int DH, int TY, int RI>
constexpr int fwd_floats() {
  constexpr int ROWS = RI * TY;
  // Q; K and V (one tile each, staggered); P; the K tile's mask bytes
  return ROWS * kFmaLd<DH> + 2 * kT * kFmaLd<DH> + ROWS * kSLd + kT / 4;
}

// RI TY query rows of one (b, h): their carry into registers, the fold over
// the block's live key tiles, the carry out
template <int DH, int TY, int RI>
__global__ void __launch_bounds__(kTx * TY, 2)
    ring_fwd_kernel(const RingArgs a) {
  constexpr int ROWS = RI * TY, THREADS = kTx * TY;
  constexpr int LD = kFmaLd<DH>, COLS = DH / kTx, CW = kFmaCw<COLS>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // [ROWS][LD]
  float* Ks = Qs + ROWS * LD;  // [kT][LD]
  float* Vs = Ks + kT * LD;    // [kT][LD]
  float* Ps = Vs + kT * LD;    // [ROWS][kSLd], dropped p
  unsigned char* Ms = reinterpret_cast<unsigned char*>(Ps + ROWS * kSLd);
  int* tiles = reinterpret_cast<int*>(Ms + kT);
  int* count = tiles + a.Nk / kT;

  const int tid = threadIdx.x, ty = tid / kTx, tx = tid % kTx;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int Nq = a.Nq, Nk = a.Nk;
  const long long rq = ((long long)b * a.H + h) * Nq;  // row (b, h, 0) of q
  const long long rk = ((long long)b * a.H + h) * Nk;
  const float* kh = a.k + rk * DH;
  const float* vh = a.v + rk * DH;
  const unsigned char* mrow = a.mask + (long long)b * Nk;
  const unsigned base = hash_base(kHashBlock, a.seed, a.b0 + b, h);

  live_tiles(mrow, Nk, tiles, count, false);
  fma_stage<DH, THREADS>(Qs, a.q + rq * DH, DH, q0, ROWS, Nq);
  cp_async_commit();
  __syncthreads();  // the tile list
  const int nlive = *count;
  if (nlive == 0) {  // no unpadded key: the carry passes through
    cp_async_wait<0>();
    copy_rows<DH, THREADS>(a.o_out + rq * DH, a.o_in + rq * DH, q0, ROWS, Nq);
    for (int r = tid; r < ROWS && q0 + r < Nq; r += THREADS) {
      a.m_out[rq + q0 + r] = a.m_in[rq + q0 + r];
      a.l_out[rq + q0 + r] = a.l_in[rq + q0 + r];
    }
    return;
  }
  auto load_k = [&](int it) {
    if (it < nlive) {
      const int k0 = tiles[it] * kT;
      fma_stage<DH, THREADS>(Ks, kh, DH, k0, kT, Nk);
      if (tid < kT / 16) cp_async16(Ms + 16 * tid, mrow + k0 + 16 * tid);
    }
    cp_async_commit();
  };
  auto load_v = [&](int it) {
    if (it < nlive) fma_stage<DH, THREADS>(Vs, vh, DH, tiles[it] * kT, kT, Nk);
    cp_async_commit();
  };
  load_k(0);
  load_v(0);

  float m[RI], l[RI], acc[RI][COLS];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + TY * i;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < COLS; ++n) acc[i][n] = 0.f;
    if (row < Nq) {
      m[i] = a.m_in[rq + row];
      l[i] = a.l_in[rq + row];
#pragma unroll
      for (int n = 0; n < COLS; n += CW)
        ld_vec<CW>(&acc[i][n],
                   a.o_in + (rq + row) * DH + fma_col<COLS>(tx, n));
    }
  }
  for (int it = 0; it < nlive; ++it) {
    cp_async_wait<1>();  // Q and this K tile; this V tile may be in flight
    __syncthreads();
    float s[RI][kSj];
    fma_scores<DH, RI, TY>(s, Qs, Ks, ty, tx);
    bool km[kSj];
#pragma unroll
    for (int j = 0; j < kSj; ++j) km[j] = Ms[tx + kTx * j] != 0;
    __syncthreads();  // Ks and Ms are free
    load_k(it + 1);
    const int k0 = a.k0 + tiles[it] * kT;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qi = a.q0 + q0 + ty + TY * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kSj; ++j) {
        if (km[j]) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max<kTx>(mx));
      const bool dead = m_new < kDead;
      const float m_safe = dead ? 0.f : m_new;
      const float corr = m[i] < kDead ? 0.f : ex2((m[i] - m_safe) * kLog2e);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kSj; ++j) {
        const int kj = tx + kTx * j;
        const float p = dead ? 0.f : ex2((s[i][j] - m_safe) * kLog2e);
        rs += p;
        Ps[(ty + TY * i) * kSLd + kj] =
            keep_bit(base, qi, k0 + kj, a.thr) ? p * a.kscale : 0.f;
      }
      l[i] = l[i] * corr + group_sum<kTx>(rs);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < COLS; ++n) acc[i][n] *= corr;
    }
    cp_async_wait<1>();  // this V tile; the next K tile may be in flight
    __syncthreads();     // P written, V landed
    fma_rows_mul<DH, RI, TY, COLS>(acc, Ps, Vs, 0, ty, tx);
    __syncthreads();     // Vs and Ps are free
    load_v(it + 1);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + TY * i;
    if (row >= Nq) continue;
#pragma unroll
    for (int n = 0; n < COLS; n += CW)
      st_vec<CW>(a.o_out + (rq + row) * DH + fma_col<COLS>(tx, n), &acc[i][n]);
    if (tx == 0) {
      a.m_out[rq + row] = m[i];
      a.l_out[rq + row] = l[i];
    }
  }
}

// ----------------------------------------------------------------- backward
template <int DH, int TY, int RI>
constexpr int dq_floats() {
  constexpr int ROWS = RI * TY;
  // Q, g; K and V double-buffered; w then ds; the K tiles' mask bytes
  return 2 * ROWS * kFmaLd<DH> + 4 * kT * kFmaLd<DH> + ROWS * kSLd +
         2 * kT / 4;
}

// RI TY query rows over the block's live key tiles: group 0 computes s and
// w, group 1 dp and ds = w (keep inv dp - D); both add ds . k into half of
// dq's columns. dq_out = dq_in + the block's terms.
template <int DH, int TY, int RI>
__global__ void __launch_bounds__(2 * kTx * TY, 1)
    ring_dq_kernel(const RingArgs a) {
  constexpr int ROWS = RI * TY, GROUP = kTx * TY;
  constexpr int THREADS = 2 * GROUP, LD = kFmaLd<DH>;
  constexpr int COLS = DH / (2 * kTx);
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // [ROWS][LD]
  float* Gs = Qs + ROWS * LD;    // [ROWS][LD]
  float* Ks = Gs + ROWS * LD;    // [2][kT][LD]
  float* Vs = Ks + 2 * kT * LD;  // [2][kT][LD]
  float* Ss = Vs + 2 * kT * LD;  // [ROWS][kSLd]: w, then ds
  unsigned char* Ms = reinterpret_cast<unsigned char*>(Ss + ROWS * kSLd);
  int* tiles = reinterpret_cast<int*>(Ms + 2 * kT);
  int* count = tiles + a.Nk / kT;

  const int tid = threadIdx.x, grp = tid / GROUP, gt = tid % GROUP;
  const int ty = gt / kTx, tx = gt % kTx;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int Nq = a.Nq, Nk = a.Nk;
  const long long rq = ((long long)b * a.H + h) * Nq;
  const long long rk = ((long long)b * a.H + h) * Nk;
  const float* kh = a.k + rk * DH;
  const float* vh = a.v + rk * DH;
  const unsigned char* mrow = a.mask + (long long)b * Nk;
  const unsigned base = hash_base(kHashBlock, a.seed, a.b0 + b, h);

  live_tiles(mrow, Nk, tiles, count, false);
  fma_stage<DH, THREADS>(Qs, a.q + rq * DH, DH, q0, ROWS, Nq);
  fma_stage<DH, THREADS>(Gs, a.g + rq * DH, DH, q0, ROWS, Nq);
  cp_async_commit();
  __syncthreads();  // the tile list
  const int nlive = *count;
  if (nlive == 0) {  // no unpadded key: dq passes through
    cp_async_wait<0>();
    copy_rows<DH, THREADS>(a.dq_out + rq * DH, a.dq_in + rq * DH, q0, ROWS,
                           Nq);
    return;
  }
  auto load_kv = [&](int v) {
    if (v < nlive) {
      const int buf = v & 1, k0 = tiles[v] * kT;
      fma_stage<DH, THREADS>(Ks + buf * kT * LD, kh, DH, k0, kT, Nk);
      fma_stage<DH, THREADS>(Vs + buf * kT * LD, vh, DH, k0, kT, Nk);
      if (tid < kT / 16)
        cp_async16(Ms + buf * kT + 16 * tid, mrow + k0 + 16 * tid);
    }
    cp_async_commit();
  };
  load_kv(0);

  // group 0: the row's m (+inf where dead: its weights are 0) and 1 / l;
  // group 1: D
  float ra[RI], rb[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + TY * i;
    ra[i] = grp == 0 ? INFINITY : 0.f;
    rb[i] = 0.f;
    if (row >= Nq) continue;
    if (grp == 0) {
      const float mi = a.m_in[rq + row], li = a.l_in[rq + row];
      ra[i] = mi < kDead ? INFINITY : mi;
      rb[i] = 1.f / (li == 0.f ? 1.f : li);
    } else {
      ra[i] = a.D[rq + row];
    }
  }

  float acc[RI][COLS];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int n = 0; n < COLS; ++n) acc[i][n] = 0.f;
  for (int v = 0; v < nlive; ++v) {
    const int buf = v & 1;
    if (v + 1 < nlive) {
      load_kv(v + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this K/V tile
    const int k0 = a.k0 + tiles[v] * kT;
    const float* Kt = Ks + buf * kT * LD;
    const unsigned char* Mb = Ms + buf * kT;
    float s[RI][kSj];
    if (grp == 0) {
      fma_scores<DH, RI, TY>(s, Qs, Kt, ty, tx);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < kSj; ++j) {
          const float sv = Mb[tx + kTx * j] != 0 ? -INFINITY : s[i][j];
          Ss[(ty + TY * i) * kSLd + tx + kTx * j] =
              ex2((sv - ra[i]) * kLog2e) * rb[i];
        }
    } else {
      fma_scores<DH, RI, TY>(s, Gs, Vs + buf * kT * LD, ty, tx);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < kSj; ++j)
          s[i][j] = keep_bit(base, a.q0 + q0 + ty + TY * i, k0 + tx + kTx * j,
                             a.thr) ? s[i][j] * a.kscale : 0.f;
    }
    __syncthreads();  // w
    if (grp == 1) {
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < kSj; ++j) {
          float* sp = Ss + (ty + TY * i) * kSLd + tx + kTx * j;
          *sp = *sp * (s[i][j] - ra[i]);
        }
    }
    __syncthreads();  // ds
    fma_rows_mul<DH, RI, TY, COLS>(acc, Ss, Kt, grp * (DH / 2), ty, tx);
    __syncthreads();  // this buffer and Ss are free
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + TY * i;
    if (row < Nq)
      add_row<DH, COLS>(a.dq_out, a.dq_in, acc[i], rq + row, grp * (DH / 2),
                        tx, false);
  }
}

template <int DH, int TY, int RI>
constexpr int dkdv_floats() {
  constexpr int ROWS = RI * TY;
  // K, V; q and g double-buffered; the dropped w; w then ds; each query
  // tile's m, 1 / l and D, double-buffered
  return 2 * ROWS * kFmaLd<DH> + 4 * kT * kFmaLd<DH> + 2 * ROWS * kSLd +
         6 * kT;
}

// RI TY keys over every 64-query tile: w^T and dp^T, then dv += w~^T . g
// (group 0) and dk += ds^T . q (group 1). A CTA whose keys are all padded
// copies dk_in and dv_in through; so does each padded key's row.
template <int DH, int TY, int RI>
__global__ void __launch_bounds__(2 * kTx * TY, 1)
    ring_dkdv_kernel(const RingArgs a) {
  constexpr int ROWS = RI * TY, GROUP = kTx * TY;
  constexpr int THREADS = 2 * GROUP, LD = kFmaLd<DH>;
  constexpr int COLS = DH / kTx, TILE = kT * LD;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                // [ROWS][LD]
  float* Vs = Ks + ROWS * LD;      // [ROWS][LD]
  float* Qs = Vs + ROWS * LD;      // [2][kT][LD]
  float* Gs = Qs + 2 * TILE;       // [2][kT][LD]
  float* Pd = Gs + 2 * TILE;       // [ROWS][kSLd], keys x queries
  float* Ss = Pd + ROWS * kSLd;    // [ROWS][kSLd]: w, then ds
  float* St = Ss + ROWS * kSLd;    // [2][3][kT]: m, 1 / l, D

  const int tid = threadIdx.x, grp = tid / GROUP, gt = tid % GROUP;
  const int ty = gt / kTx, tx = gt % kTx;
  const int k0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int Nq = a.Nq, Nk = a.Nk;
  const long long rq = ((long long)b * a.H + h) * Nq;
  const long long rk = ((long long)b * a.H + h) * Nk;
  const unsigned char* mrow = a.mask + (long long)b * Nk;

  // does this CTA hold an unpadded key?
  bool live = false;
  if (tid < ROWS / 16 && k0 + 16 * tid < Nk)
    live = vs::any_live16(mrow + k0 + 16 * tid);
  if (!__syncthreads_or(live)) {
    copy_rows<DH, THREADS>(a.dk_out + rk * DH, a.dk_in + rk * DH, k0, ROWS,
                           Nk);
    copy_rows<DH, THREADS>(a.dv_out + rk * DH, a.dv_in + rk * DH, k0, ROWS,
                           Nk);
    return;
  }

  fma_stage<DH, THREADS>(Ks, a.k + rk * DH, DH, k0, ROWS, Nk);
  fma_stage<DH, THREADS>(Vs, a.v + rk * DH, DH, k0, ROWS, Nk);
  auto load_q = [&](int qt) {
    const int q0 = qt * kT, buf = qt & 1;
    fma_stage<DH, THREADS>(Qs + buf * TILE, a.q + rq * DH, DH, q0, kT, Nq);
    fma_stage<DH, THREADS>(Gs + buf * TILE, a.g + rq * DH, DH, q0, kT, Nq);
    if (tid < 3 * kT / 4) {
      const int w = tid / (kT / 4), c = 4 * (tid % (kT / 4));
      const float* src = w == 0 ? a.m_in : w == 1 ? a.l_in : a.D;
      cp_async16(St + (buf * 3 + w) * kT + c, src + rq + q0 + c);
    }
    cp_async_commit();
  };
  load_q(0);  // one group with K and V

  const unsigned base = hash_base(kHashBlock, a.seed, a.b0 + b, h);
  bool km[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int key = k0 + ty + TY * i;
    km[i] = key >= Nk || mrow[key] != 0;
  }
  float acc[RI][COLS];  // dV in group 0, dK in group 1
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int n = 0; n < COLS; ++n) acc[i][n] = 0.f;

  const int ntq = Nq / kT;
  for (int qt = 0; qt < ntq; ++qt) {
    const int buf = qt & 1, q0 = qt * kT;
    if (qt + 1 < ntq) {
      load_q(qt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (tid < kT / 2) {
      // the m or l whose copy this thread issued: m -> +inf on a row below
      // _DEAD (its weights are 0), l -> 1 / l (1 where l is 0)
      float* x = St + (buf * 3 + tid / (kT / 4)) * kT + 4 * (tid % (kT / 4));
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[j] = tid < kT / 4 ? (x[j] < kDead ? INFINITY : x[j])
                            : 1.f / (x[j] == 0.f ? 1.f : x[j]);
    }
    __syncthreads();  // this q/g tile and its rows' m, 1 / l, D
    const float* Qt = Qs + buf * TILE;
    const float* Gt = Gs + buf * TILE;
    const float* Mt = St + buf * 3 * kT;
    const float* Lt = Mt + kT;
    const float* Dt = Lt + kT;
    float s[RI][kSj];
    if (grp == 0) {
      fma_scores<DH, RI, TY>(s, Ks, Qt, ty, tx);  // s^T
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < kSj; ++j) {
          const int qj = tx + kTx * j, o = (ty + TY * i) * kSLd + qj;
          const float sv = km[i] ? -INFINITY : s[i][j];
          const float w = ex2((sv - Mt[qj]) * kLog2e) * Lt[qj];
          Ss[o] = w;
          Pd[o] = keep_bit(base, a.q0 + q0 + qj, a.k0 + k0 + ty + TY * i,
                           a.thr) ? w * a.kscale : 0.f;
        }
    } else {
      fma_scores<DH, RI, TY>(s, Vs, Gt, ty, tx);  // dp^T
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < kSj; ++j)
          s[i][j] = keep_bit(base, a.q0 + q0 + tx + kTx * j,
                             a.k0 + k0 + ty + TY * i, a.thr)
                        ? s[i][j] * a.kscale : 0.f;
    }
    __syncthreads();  // w
    if (grp == 1) {
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < kSj; ++j) {
          const int qj = tx + kTx * j;
          float* sp = Ss + (ty + TY * i) * kSLd + qj;
          *sp = *sp * (s[i][j] - Dt[qj]);
        }
    }
    __syncthreads();  // ds
    if (grp == 0)
      fma_rows_mul<DH, RI, TY, COLS>(acc, Pd, Gt, 0, ty, tx);
    else
      fma_rows_mul<DH, RI, TY, COLS>(acc, Ss, Qt, 0, ty, tx);
    __syncthreads();  // this buffer, Pd and Ss are free
  }

  float* dst = grp == 0 ? a.dv_out : a.dk_out;
  const float* src = grp == 0 ? a.dv_in : a.dk_in;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int key = k0 + ty + TY * i;
    if (key < Nk)
      add_row<DH, COLS>(dst, src, acc[i], rk + key, 0, tx, km[i]);
  }
}

// --------------------------------------------------------- head_dim slices
// The three kernels over a head of nsl * 128 columns (attention_core.cuh's
// head_dim slices): the tensors are (B, H, N, nsl * 128), grid.y runs over
// (head, slice). s and dp are summed over the slices, one 128-column slice
// of each operand staged at a time (cp.async, then a wait), each score's
// FMAs in increasing column order over the whole head, so every slice CTA
// of a row folds the same scores into the same m and l; the products that
// keep head_dim take the CTA's own slice of v, o, dq, dk and dv, and the
// slice-0 CTA writes m and l (the others hold the same bits). The carries
// of a block with no unpadded key, and the dk, dv rows of a CTA whose keys
// are all padded, pass through slice by slice. CTA shapes: (16, 4) forward
// and dQ, (8, 4) dK/dV (ring_shapes past head_dim 64 and 128); the shared
// memory of the unsliced kernels at 128 (fwd_floats, dq_floats,
// dkdv_floats: 119,872, 221,312 and 188,928 bytes, plus the tile lists).

// rows r0 .. r0 + rows - 1 (those below N) of the own 128-column slice c0
// of a matrix at row stride ld, copied
template <int THREADS>
__device__ __forceinline__ void copy_slice_rows(float* dst, const float* src,
                                                int r0, int rows, int N,
                                                long long ld, int c0) {
  constexpr int CH = vs::attn::kSliceDh / 4;
  const int n = min(rows, N - r0) * CH;
  for (int c = threadIdx.x; c < n; c += THREADS) {
    const long long e = (long long)(r0 + c / CH) * ld + c0 + (c % CH) * 4;
    *reinterpret_cast<float4*>(dst + e) =
        *reinterpret_cast<const float4*>(src + e);
  }
}

// add_row at row stride ld
template <int COLS>
__device__ __forceinline__ void add_slice_row(float* out, const float* in,
                                              const float (&acc)[COLS],
                                              long long row, long long ld,
                                              int c0, int tx, bool pass) {
  constexpr int CW = kFmaCw<COLS>;
#pragma unroll
  for (int n = 0; n < COLS; n += CW) {
    const long long e = row * ld + c0 + fma_col<COLS>(tx, n);
    float x[CW];
    ld_vec<CW>(x, in + e);
    if (!pass) {
#pragma unroll
      for (int j = 0; j < CW; ++j) x[j] += acc[n + j];
    }
    st_vec<CW>(out + e, x);
  }
}

template <int TY, int RI>
__global__ void __launch_bounds__(kTx * TY, 2)
    ring_fwd_sliced_kernel(const RingArgs a) {
  constexpr int DH = vs::attn::kSliceDh, ROWS = RI * TY, THREADS = kTx * TY;
  constexpr int LD = kFmaLd<DH>, COLS = DH / kTx, CW = kFmaCw<COLS>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // [ROWS][LD], slice j
  float* Ks = Qs + ROWS * LD;  // [kT][LD], slice j
  float* Vs = Ks + kT * LD;    // [kT][LD], own slice
  float* Ps = Vs + kT * LD;    // [ROWS][kSLd], dropped p
  unsigned char* Ms = reinterpret_cast<unsigned char*>(Ps + ROWS * kSLd);
  int* tiles = reinterpret_cast<int*>(Ms + kT);
  int* count = tiles + a.Nk / kT;

  const int nsl = a.nsl, tid = threadIdx.x, ty = tid / kTx, tx = tid % kTx;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y / nsl;
  const int sl = blockIdx.y % nsl, b = blockIdx.z;
  const int Nq = a.Nq, Nk = a.Nk;
  const long long RS = (long long)nsl * DH;  // row stride
  const long long rq = ((long long)b * a.H + h) * Nq;
  const long long rk = ((long long)b * a.H + h) * Nk;
  const float* qh = a.q + rq * RS;
  const float* kh = a.k + rk * RS;
  const float* vh = a.v + rk * RS + sl * DH;
  const unsigned char* mrow = a.mask + (long long)b * Nk;
  const unsigned base = hash_base(kHashBlock, a.seed, a.b0 + b, h);

  live_tiles(mrow, Nk, tiles, count, false);
  __syncthreads();  // the tile list
  const int nlive = *count;
  if (nlive == 0) {  // no unpadded key: the carry passes through
    copy_slice_rows<THREADS>(a.o_out + rq * RS, a.o_in + rq * RS, q0, ROWS,
                             Nq, RS, sl * DH);
    if (sl == 0)
      for (int r = tid; r < ROWS && q0 + r < Nq; r += THREADS) {
        a.m_out[rq + q0 + r] = a.m_in[rq + q0 + r];
        a.l_out[rq + q0 + r] = a.l_in[rq + q0 + r];
      }
    return;
  }

  float m[RI], l[RI], acc[RI][COLS];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + TY * i;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < COLS; ++n) acc[i][n] = 0.f;
    if (row < Nq) {
      m[i] = a.m_in[rq + row];
      l[i] = a.l_in[rq + row];
#pragma unroll
      for (int n = 0; n < COLS; n += CW)
        ld_vec<CW>(&acc[i][n],
                   a.o_in + (rq + row) * RS + sl * DH + fma_col<COLS>(tx, n));
    }
  }
  for (int it = 0; it < nlive; ++it) {
    const int kt = tiles[it] * kT;
    float s[RI][kSj];
    for (int j = 0; j < nsl; ++j) {
      __syncthreads();  // the last readers of every tile and of Ps are done
      fma_stage<DH, THREADS>(Qs, qh + j * DH, RS, q0, ROWS, Nq);
      fma_stage<DH, THREADS>(Ks, kh + j * DH, RS, kt, kT, Nk);
      if (j == 0 && tid < kT / 16)
        cp_async16(Ms + 16 * tid, mrow + kt + 16 * tid);
      if (j == nsl - 1) fma_stage<DH, THREADS>(Vs, vh, RS, kt, kT, Nk);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (j == 0)
        fma_scores<DH, RI, TY>(s, Qs, Ks, ty, tx);
      else
        fma_scores<DH, RI, TY, false>(s, Qs, Ks, ty, tx);
    }
    bool km[kSj];
#pragma unroll
    for (int j = 0; j < kSj; ++j) km[j] = Ms[tx + kTx * j] != 0;
    const int k0 = a.k0 + kt;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qi = a.q0 + q0 + ty + TY * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kSj; ++j) {
        if (km[j]) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max<kTx>(mx));
      const bool dead = m_new < kDead;
      const float m_safe = dead ? 0.f : m_new;
      const float corr = m[i] < kDead ? 0.f : ex2((m[i] - m_safe) * kLog2e);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kSj; ++j) {
        const int kj = tx + kTx * j;
        const float p = dead ? 0.f : ex2((s[i][j] - m_safe) * kLog2e);
        rs += p;
        Ps[(ty + TY * i) * kSLd + kj] =
            keep_bit(base, qi, k0 + kj, a.thr) ? p * a.kscale : 0.f;
      }
      l[i] = l[i] * corr + group_sum<kTx>(rs);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < COLS; ++n) acc[i][n] *= corr;
    }
    __syncthreads();  // P written
    fma_rows_mul<DH, RI, TY, COLS>(acc, Ps, Vs, 0, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + TY * i;
    if (row >= Nq) continue;
#pragma unroll
    for (int n = 0; n < COLS; n += CW)
      st_vec<CW>(a.o_out + (rq + row) * RS + sl * DH + fma_col<COLS>(tx, n),
                 &acc[i][n]);
    if (sl == 0 && tx == 0) {
      a.m_out[rq + row] = m[i];
      a.l_out[rq + row] = l[i];
    }
  }
}

template <int TY, int RI>
__global__ void __launch_bounds__(2 * kTx * TY, 1)
    ring_dq_sliced_kernel(const RingArgs a) {
  constexpr int DH = vs::attn::kSliceDh, ROWS = RI * TY, GROUP = kTx * TY;
  constexpr int THREADS = 2 * GROUP, LD = kFmaLd<DH>;
  constexpr int COLS = DH / (2 * kTx);
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // [ROWS][LD], slice j
  float* Gs = Qs + ROWS * LD;    // [ROWS][LD], slice j
  float* Ks = Gs + ROWS * LD;    // [2][kT][LD]: slice j, own slice
  float* Vs = Ks + 2 * kT * LD;  // [kT][LD], slice j
  float* Ss = Vs + 2 * kT * LD;  // [ROWS][kSLd]: w, then ds
  unsigned char* Ms = reinterpret_cast<unsigned char*>(Ss + ROWS * kSLd);
  int* tiles = reinterpret_cast<int*>(Ms + 2 * kT);
  int* count = tiles + a.Nk / kT;

  const int nsl = a.nsl, tid = threadIdx.x, grp = tid / GROUP;
  const int gt = tid % GROUP, ty = gt / kTx, tx = gt % kTx;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y / nsl;
  const int sl = blockIdx.y % nsl, b = blockIdx.z;
  const int Nq = a.Nq, Nk = a.Nk;
  const long long RS = (long long)nsl * DH;
  const long long rq = ((long long)b * a.H + h) * Nq;
  const long long rk = ((long long)b * a.H + h) * Nk;
  const float* qh = a.q + rq * RS;
  const float* gh = a.g + rq * RS;
  const float* kh = a.k + rk * RS;
  const float* vh = a.v + rk * RS;
  const unsigned char* mrow = a.mask + (long long)b * Nk;
  const unsigned base = hash_base(kHashBlock, a.seed, a.b0 + b, h);

  live_tiles(mrow, Nk, tiles, count, false);
  __syncthreads();  // the tile list
  const int nlive = *count;
  if (nlive == 0) {  // no unpadded key: dq passes through
    copy_slice_rows<THREADS>(a.dq_out + rq * RS, a.dq_in + rq * RS, q0, ROWS,
                             Nq, RS, sl * DH);
    return;
  }

  float ra[RI], rb[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + TY * i;
    ra[i] = grp == 0 ? INFINITY : 0.f;
    rb[i] = 0.f;
    if (row >= Nq) continue;
    if (grp == 0) {
      const float mi = a.m_in[rq + row], li = a.l_in[rq + row];
      ra[i] = mi < kDead ? INFINITY : mi;
      rb[i] = 1.f / (li == 0.f ? 1.f : li);
    } else {
      ra[i] = a.D[rq + row];
    }
  }

  float acc[RI][COLS];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int n = 0; n < COLS; ++n) acc[i][n] = 0.f;
  for (int v = 0; v < nlive; ++v) {
    const int kt = tiles[v] * kT;
    float s[RI][kSj];
    for (int j = 0; j < nsl; ++j) {
      __syncthreads();  // the last readers of every tile and of Ss are done
      fma_stage<DH, THREADS>(Qs, qh + j * DH, RS, q0, ROWS, Nq);
      fma_stage<DH, THREADS>(Gs, gh + j * DH, RS, q0, ROWS, Nq);
      fma_stage<DH, THREADS>(Ks, kh + j * DH, RS, kt, kT, Nk);
      fma_stage<DH, THREADS>(Vs, vh + j * DH, RS, kt, kT, Nk);
      if (j == 0 && tid < kT / 16)
        cp_async16(Ms + 16 * tid, mrow + kt + 16 * tid);
      if (j == nsl - 1)
        fma_stage<DH, THREADS>(Ks + kT * LD, kh + sl * DH, RS, kt, kT, Nk);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      const float* A = grp == 0 ? Qs : Gs;
      const float* Bt = grp == 0 ? Ks : Vs;
      if (j == 0)
        fma_scores<DH, RI, TY>(s, A, Bt, ty, tx);
      else
        fma_scores<DH, RI, TY, false>(s, A, Bt, ty, tx);
    }
    const int k0 = a.k0 + kt;
    if (grp == 0) {
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < kSj; ++j) {
          const float sv = Ms[tx + kTx * j] != 0 ? -INFINITY : s[i][j];
          Ss[(ty + TY * i) * kSLd + tx + kTx * j] =
              ex2((sv - ra[i]) * kLog2e) * rb[i];
        }
    } else {
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < kSj; ++j)
          s[i][j] = keep_bit(base, a.q0 + q0 + ty + TY * i, k0 + tx + kTx * j,
                             a.thr) ? s[i][j] * a.kscale : 0.f;
    }
    __syncthreads();  // w
    if (grp == 1) {
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < kSj; ++j) {
          float* sp = Ss + (ty + TY * i) * kSLd + tx + kTx * j;
          *sp = *sp * (s[i][j] - ra[i]);
        }
    }
    __syncthreads();  // ds
    fma_rows_mul<DH, RI, TY, COLS>(acc, Ss, Ks + kT * LD, grp * (DH / 2), ty,
                                   tx);
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + TY * i;
    if (row < Nq)
      add_slice_row<COLS>(a.dq_out, a.dq_in, acc[i], rq + row, RS,
                          sl * DH + grp * (DH / 2), tx, false);
  }
}

template <int TY, int RI>
__global__ void __launch_bounds__(2 * kTx * TY, 1)
    ring_dkdv_sliced_kernel(const RingArgs a) {
  constexpr int DH = vs::attn::kSliceDh, ROWS = RI * TY, GROUP = kTx * TY;
  constexpr int THREADS = 2 * GROUP, LD = kFmaLd<DH>;
  constexpr int COLS = DH / kTx, TILE = kT * LD;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                // [ROWS][LD], slice j
  float* Vs = Ks + ROWS * LD;      // [ROWS][LD], slice j
  float* Qs = Vs + ROWS * LD;      // [2][kT][LD]: slice j, own slice
  float* Gs = Qs + 2 * TILE;       // [2][kT][LD]: slice j, own slice
  float* Pd = Gs + 2 * TILE;       // [ROWS][kSLd], keys x queries
  float* Ss = Pd + ROWS * kSLd;    // [ROWS][kSLd]: w, then ds
  float* St = Ss + ROWS * kSLd;    // [3][kT]: m, 1 / l, D

  const int nsl = a.nsl, tid = threadIdx.x, grp = tid / GROUP;
  const int gt = tid % GROUP, ty = gt / kTx, tx = gt % kTx;
  const int k0 = blockIdx.x * ROWS, h = blockIdx.y / nsl;
  const int sl = blockIdx.y % nsl, b = blockIdx.z;
  const int Nq = a.Nq, Nk = a.Nk;
  const long long RS = (long long)nsl * DH;
  const long long rq = ((long long)b * a.H + h) * Nq;
  const long long rk = ((long long)b * a.H + h) * Nk;
  const unsigned char* mrow = a.mask + (long long)b * Nk;

  bool live = false;
  if (tid < ROWS / 16 && k0 + 16 * tid < Nk)
    live = vs::any_live16(mrow + k0 + 16 * tid);
  if (!__syncthreads_or(live)) {
    copy_slice_rows<THREADS>(a.dk_out + rk * RS, a.dk_in + rk * RS, k0, ROWS,
                             Nk, RS, sl * DH);
    copy_slice_rows<THREADS>(a.dv_out + rk * RS, a.dv_in + rk * RS, k0, ROWS,
                             Nk, RS, sl * DH);
    return;
  }

  const float* kh = a.k + rk * RS;
  const float* vh = a.v + rk * RS;
  const float* qh = a.q + rq * RS;
  const float* gh = a.g + rq * RS;
  const unsigned base = hash_base(kHashBlock, a.seed, a.b0 + b, h);
  bool km[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int key = k0 + ty + TY * i;
    km[i] = key >= Nk || mrow[key] != 0;
  }
  float acc[RI][COLS];  // dV in group 0, dK in group 1
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int n = 0; n < COLS; ++n) acc[i][n] = 0.f;

  const int ntq = Nq / kT;
  for (int qt = 0; qt < ntq; ++qt) {
    const int q0 = qt * kT;
    float s[RI][kSj];
    for (int j = 0; j < nsl; ++j) {
      __syncthreads();  // the last readers of every tile, Pd and Ss are done
      fma_stage<DH, THREADS>(Ks, kh + j * DH, RS, k0, ROWS, Nk);
      fma_stage<DH, THREADS>(Vs, vh + j * DH, RS, k0, ROWS, Nk);
      fma_stage<DH, THREADS>(Qs, qh + j * DH, RS, q0, kT, Nq);
      fma_stage<DH, THREADS>(Gs, gh + j * DH, RS, q0, kT, Nq);
      if (j == 0 && tid < 3 * kT / 4) {
        const int w = tid / (kT / 4), c = 4 * (tid % (kT / 4));
        const float* src = w == 0 ? a.m_in : w == 1 ? a.l_in : a.D;
        cp_async16(St + w * kT + c, src + rq + q0 + c);
      }
      if (j == nsl - 1) {
        fma_stage<DH, THREADS>(Qs + TILE, qh + sl * DH, RS, q0, kT, Nq);
        fma_stage<DH, THREADS>(Gs + TILE, gh + sl * DH, RS, q0, kT, Nq);
      }
      cp_async_commit();
      cp_async_wait<0>();
      if (j == 0 && tid < kT / 2) {
        // the m or l whose copy this thread issued: m -> +inf on a row
        // below _DEAD, l -> 1 / l (1 where l is 0)
        float* x = St + (tid / (kT / 4)) * kT + 4 * (tid % (kT / 4));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[e] = tid < kT / 4 ? (x[e] < kDead ? INFINITY : x[e])
                              : 1.f / (x[e] == 0.f ? 1.f : x[e]);
      }
      __syncthreads();
      const float* A = grp == 0 ? Ks : Vs;
      const float* Bt = grp == 0 ? Qs : Gs;
      if (j == 0)
        fma_scores<DH, RI, TY>(s, A, Bt, ty, tx);
      else
        fma_scores<DH, RI, TY, false>(s, A, Bt, ty, tx);
    }
    const float* Mt = St;
    const float* Lt = Mt + kT;
    const float* Dt = Lt + kT;
    if (grp == 0) {
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < kSj; ++j) {
          const int qj = tx + kTx * j, o = (ty + TY * i) * kSLd + qj;
          const float sv = km[i] ? -INFINITY : s[i][j];
          const float w = ex2((sv - Mt[qj]) * kLog2e) * Lt[qj];
          Ss[o] = w;
          Pd[o] = keep_bit(base, a.q0 + q0 + qj, a.k0 + k0 + ty + TY * i,
                           a.thr) ? w * a.kscale : 0.f;
        }
    } else {
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < kSj; ++j)
          s[i][j] = keep_bit(base, a.q0 + q0 + tx + kTx * j,
                             a.k0 + k0 + ty + TY * i, a.thr)
                        ? s[i][j] * a.kscale : 0.f;
    }
    __syncthreads();  // w
    if (grp == 1) {
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < kSj; ++j) {
          const int qj = tx + kTx * j;
          float* sp = Ss + (ty + TY * i) * kSLd + qj;
          *sp = *sp * (s[i][j] - Dt[qj]);
        }
    }
    __syncthreads();  // ds
    if (grp == 0)
      fma_rows_mul<DH, RI, TY, COLS>(acc, Pd, Gs + TILE, 0, ty, tx);
    else
      fma_rows_mul<DH, RI, TY, COLS>(acc, Ss, Qs + TILE, 0, ty, tx);
  }

  float* dst = grp == 0 ? a.dv_out : a.dk_out;
  const float* src = grp == 0 ? a.dv_in : a.dk_in;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int key = k0 + ty + TY * i;
    if (key < Nk)
      add_slice_row<COLS>(dst, src, acc[i], rk + key, RS, sl * DH, tx, km[i]);
  }
}

// ------------------------------------------------------------------ launches
bool shape_ok(int B, int H, int Nq, int Nk, int Dh) {
  return B > 0 && H > 0 && Nq > 0 && Nk > 0 && Nq % kT == 0 &&
         Nk % kT == 0 && B <= 65535 && H <= 65535 &&
         vs::attn::head_dim_ok(Dh);
}

bool aligned(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (!vs::aligned16(p)) return false;
  return true;
}

// One launch of kernel K (0 forward, 1 dQ, 2 dK/dV) in the CTA shape
// (TY, RI), or with slots given, the CTAs of that shape an SM holds
template <int K, int DH, int TY, int RI>
cudaError_t run(const RingArgs& a, int B, cudaStream_t s, int* slots) {
  constexpr int ROWS = RI * TY, THREADS = (K == 0 ? 1 : 2) * kTx * TY;
  void (*kernel)(const RingArgs);
  int floats, rows;
  if constexpr (K == 0) {
    kernel = ring_fwd_kernel<DH, TY, RI>;
    floats = fwd_floats<DH, TY, RI>() + a.Nk / kT + 1;
    rows = a.Nq;
  } else if constexpr (K == 1) {
    kernel = ring_dq_kernel<DH, TY, RI>;
    floats = dq_floats<DH, TY, RI>() + a.Nk / kT + 1;
    rows = a.Nq;
  } else {
    kernel = ring_dkdv_kernel<DH, TY, RI>;
    floats = dkdv_floats<DH, TY, RI>();
    rows = a.Nk;
  }
  const int bytes = floats * (int)sizeof(float);
  cudaError_t err = vs::attn::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  if (slots != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(slots, kernel,
                                                         THREADS, bytes);
  kernel<<<dim3((rows + ROWS - 1) / ROWS, a.H, B), THREADS, bytes, s>>>(a);
  return cudaGetLastError();
}

// The CTA shapes (TY, RI) of every kernel: (16, 8) and (16, 4) at head_dim
// <= 64; (16, 4) alone at 96 and 128 ((8, 4) was slower at every grid
// timed), but (8, 4) for dK/dV at 128 (a 16-deep CTA would need 240 KB of
// shared memory)
template <int K, int DH>
cudaError_t run_shape(const RingArgs& a, int B, int depth, int ri,
                      cudaStream_t s, int* slots) {
  if constexpr (kFmaRi<DH> == 8) {
    if (depth == 16 && ri == 8) return run<K, DH, 16, 8>(a, B, s, slots);
  }
  if constexpr (K == 2 && DH == 128) {
    if (depth == 8 && ri == 4) return run<K, DH, 8, 4>(a, B, s, slots);
  } else {
    if (depth == 16 && ri == 4) return run<K, DH, 16, 4>(a, B, s, slots);
  }
  return cudaErrorInvalidValue;
}

// One launch of sliced kernel K over nsl slices, in its one CTA shape
// ((16, 4) forward and dQ, (8, 4) dK/dV), or with slots given, the CTAs of
// it an SM holds
template <int K>
cudaError_t run_sliced(const RingArgs& a, int B, int nsl, int depth, int ri,
                       cudaStream_t s, int* slots) {
  constexpr int DH = vs::attn::kSliceDh, TY = K == 2 ? 8 : 16, RI = 4;
  constexpr int ROWS = RI * TY, THREADS = (K == 0 ? 1 : 2) * kTx * TY;
  if (depth != TY || ri != RI || nsl <= 0 || (long long)a.H * nsl > 65535)
    return cudaErrorInvalidValue;
  void (*kernel)(const RingArgs);
  int floats, rows;
  if constexpr (K == 0) {
    kernel = ring_fwd_sliced_kernel<TY, RI>;
    floats = fwd_floats<DH, TY, RI>() + a.Nk / kT + 1;
    rows = a.Nq;
  } else if constexpr (K == 1) {
    kernel = ring_dq_sliced_kernel<TY, RI>;
    floats = dq_floats<DH, TY, RI>() + a.Nk / kT + 1;
    rows = a.Nq;
  } else {
    kernel = ring_dkdv_sliced_kernel<TY, RI>;
    floats = dkdv_floats<DH, TY, RI>();
    rows = a.Nk;
  }
  const int bytes = floats * (int)sizeof(float);
  cudaError_t err = vs::attn::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  if (slots != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(slots, kernel,
                                                         THREADS, bytes);
  RingArgs b = a;
  b.nsl = nsl;
  kernel<<<dim3((rows + ROWS - 1) / ROWS, a.H * nsl, B), THREADS, bytes, s>>>(
      b);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch(const RingArgs& a, int B, int Dh, int depth, int ri,
                   cudaStream_t s, int* slots = nullptr) {
  switch (Dh) {
    case 16: return run_shape<K, 16>(a, B, depth, ri, s, slots);
    case 32: return run_shape<K, 32>(a, B, depth, ri, s, slots);
    case 64: return run_shape<K, 64>(a, B, depth, ri, s, slots);
    case 96: return run_shape<K, 96>(a, B, depth, ri, s, slots);
    case 128: return run_shape<K, 128>(a, B, depth, ri, s, slots);
    default:
      return run_sliced<K>(a, B, vs::attn::head_slices(Dh), depth, ri, s,
                           slots);
  }
}

}  // namespace

// One forward step: _ring_block_kernel at thr 0 (rate 0: keep_bit keeps
// every weight and hashes nothing), _ring_train_fwd_kernel with the bits of
// (seed, b0, q0, k0) at threshold thr. (depth, ri): the CTA shape (TY, RI).
extern "C" int vs_ring_fwd(const float* q, const float* k, const float* v,
                           const unsigned char* mask, const float* o_in,
                           const float* m_in, const float* l_in, float* o_out,
                           float* m_out, float* l_out, int B, int H, int Nq,
                           int Nk, int Dh, int depth, int ri, unsigned seed,
                           int b0, int q0, int k0, unsigned thr, float kscale,
                           void* stream) {
  if (!shape_ok(B, H, Nq, Nk, Dh)) return (int)cudaErrorInvalidValue;
  if (!aligned({q, k, v, mask, o_in, m_in, l_in, o_out, m_out, l_out}))
    return (int)cudaErrorMisalignedAddress;
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
  return (int)launch<0>(a, B, Dh, depth, ri,
                        static_cast<cudaStream_t>(stream));
}

// The backward of one ring step: (dq, dk, dv)_out = (dq, dk, dv)_in + this
// block's terms; (depth_q, ri_q) and (depth_k, ri_k): the dQ and dK/dV
// CTA shapes
extern "C" int vs_ring_bwd(const float* q, const float* k, const float* v,
                           const float* g, const float* D, const float* m,
                           const float* l, const unsigned char* mask,
                           const float* dq_in, const float* dk_in,
                           const float* dv_in, float* dq_out, float* dk_out,
                           float* dv_out, int B, int H, int Nq, int Nk, int Dh,
                           int depth_q, int ri_q, int depth_k, int ri_k,
                           unsigned seed, int b0, int q0, int k0, unsigned thr,
                           float kscale, void* stream) {
  if (!shape_ok(B, H, Nq, Nk, Dh)) return (int)cudaErrorInvalidValue;
  if (!aligned({q, k, v, g, D, m, l, mask, dq_in, dk_in, dv_in, dq_out,
                dk_out, dv_out}))
    return (int)cudaErrorMisalignedAddress;
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
  const cudaError_t err = launch<1>(a, B, Dh, depth_q, ri_q, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch<2>(a, B, Dh, depth_k, ri_k, s);
}

// The CTAs of kernel `kernel` (0 forward, 1 dQ, 2 dK/dV) in the shape
// (depth, ri) that an SM holds at once, for Nk keys, into *slots
extern "C" int vs_ring_slots(int kernel, int Dh, int depth, int ri, int Nk,
                             int* slots) {
  if (!vs::attn::head_dim_ok(Dh) || Nk <= 0 || Nk % kT != 0)
    return (int)cudaErrorInvalidValue;
  RingArgs a{};
  a.Nk = Nk;
  *slots = 0;
  switch (kernel) {
    case 0: return (int)launch<0>(a, 1, Dh, depth, ri, nullptr, slots);
    case 1: return (int)launch<1>(a, 1, Dh, depth, ri, nullptr, slots);
    case 2: return (int)launch<2>(a, 1, Dh, depth, ri, nullptr, slots);
    default: return (int)cudaErrorInvalidValue;
  }
}
