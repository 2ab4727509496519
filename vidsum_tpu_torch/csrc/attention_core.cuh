// Masked attention with counter-hash dropout on the softmax weights, forward
// and backward, in exact f32 on the FMA units (no TF32: it would not compute
// what the TPU's f32 kernels compute), for sm_90a.
//
// Replaces, for f32 inputs, the TPU kernels
// vidsum_tpu/ops/attention_train.py:83 _fwd_kernel, :112 _bwd_kernel, :175
// _fwd_kernel_folded and :228 _bwd_kernel_folded (attention_train.cu; bf16
// takes attention_train_mma.cuh's tensor-core kernels on both routes), and
// the attention inside vidsum_tpu/ops/block_train.py:198 _fwd_kernel, :221
// _bwd_kernel, :410 _fwd_kernel_grouped and :421 _bwd_kernel_grouped
// (block_train.cu, on its fused (B*N, 3d) QKV buffer), and, forward only,
// the f32 serving attention: vidsum_tpu/ops/
// attention.py:40 _attention_kernel, :76 _attention_kernel_folded and the
// attention inside ops/block_kernel.py:39 _block_kernel and :98
// _block_kernel_grouped (masked_attention.cu's launch_fma). The ring's
// kernels (ring_attention.cu) are built from its tiles too.
//
// Bound on the card: the products, 4 d N sum(valid keys) operations forward
// and 8 d N sum(valid) backward (d = H Dh), at the f32 FMA peak of 67
// TFLOP/s: at (B, H, N, Dh) = (2, 4, 8192, 64), valid (8100, 5000), 1.64 ms
// forward and 3.28 ms backward; moving its tensors (~70 MB) takes ~0.02 ms
// at 3.35 TB/s. The backward recomputes s in both kernels and dp in both,
// 7 Dh FMAs a (query, key) pair against the bound's 4. On an H100 80GB
// HBM3 (700 W) the forward ran at ~47 % of the FMA peak and the backward
// at ~40 % on its own FMAs (PERF.md, chip_smoke.py's attention lines).
//
//   fma_fwd_kernel   per RI TY query rows: one pass over the live key tiles,
//                    the online fold; writes o and, if asked, lse.
//   fma_dq_kernel    per RI TY query rows: D (rowsum(dO * o), or a first
//                    pass summing rowsum(g * p) when no o is given), then
//                    dQ over the live key tiles; writes D.
//   fma_dkdv_kernel  per RI TY keys, looping over the query tiles: dV, dK.
//
// What the design does about what held the first family (4 x 4 blocks over
// transposed tiles) back:
// 1. Shared-memory issue. A thread holds RI x 8 scores (8 x 8; 4 x 8 at head
//    dim 96 and 128) and RI rows of each product's output, and reads row-major
//    tiles as float4: per 4 steps of a score product, 8 + RI vector reads
//    feed 32 RI FMAs (256 per 16 at RI 8, against 16 per 8 scalar reads), and
//    the products P.V, dS.K, pd^T.dO and dS^T.Q likewise. Rows of DH + 4 and
//    72 floats keep every warp's reads free of bank conflicts (fma_scores,
//    fma_rows_mul).
// 2. Loads overlapped with products. Row-major tiles arrive by 16-byte
//    cp.async: the forward's K tile loads during the fold and P.V, its V
//    tile during the next scores (one buffer each); dQ double-buffers K/V,
//    dK/dV Q/dO with their lse and D.
// 3. Live key tiles only. A key tile with no unpadded key adds exact zeros
//    to every sum and nothing to any max (the fold leaves m, l and o bit for
//    bit), so the forward and dQ walk the live tiles of their element
//    (mma_tiles.cuh's live_tiles) and a dK/dV CTA whose keys are all padded
//    writes zeros. Padded query rows are computed as before.
// 4. One forward pass. In f32 nothing is rounded between the two passes of
//    the normalise-first order, so both routes fold online (scores in log2
//    units, the _DEAD guards, one reciprocal of l per row, lse = (m +
//    log2 l) ln 2); the route only decides what an element with no
//    unpadded key gives: the fold walks no tile (o = 0, lse = -inf), the
//    single pass and the block every tile (NaN o, lse = -inf, as before).
// 5. D = rowsum(dO * o). The single-pass route takes it from o like the
//    folded route and the block (the same quantity: o = sum_j pd_j v_j, so
//    dO . o = sum_j p_j g_j); a first pass over the keys for rowsum(g * p)
//    runs only when the caller gives no o.
// 6. Per score: 2^x of pre-scaled scores on the MUFU unit (mma_tiles.cuh's
//    ex2: exp2f less its fix-up of denormal results, which a softmax
//    weight below 2^-126 does not need), the hash only where rate > 0
//    (keep_bit's early return; its bits unchanged, both families).
// Two groups of 8 TY threads share each backward CTA (256 threads at TY 16):
// dQ's group 0 computes s and p, group 1 dp, g and ds, both half of dQ; dK/
// dV's group 0 p, pd and dV, group 1 dp, ds and dK, so that each thread
// keeps one set of accumulators. The CTA takes 16-deep thread tiles (128
// rows; 64 at head dim 96 and 128) on large grids and 8-deep ones below
// (fma_wide). Nothing of size N x N reaches device memory; no
// kernel uses atomics, so two runs of the backward give identical bits.
//
// Layouts are strided so that one family reads the training block's fused
// (B*N, 3d) QKV buffer (head h at column h*DH) and (B, H, N, DH) tensors
// alike: element (b, h, row, c) of a tensor lies at b*sb + h*sh + row*sn + c,
// with one stride set for q/k/v/dq/dk/dv ("in") and one for o/dO ("out");
// lse and D are (B, H, N) f32. Every pointer the kernels copy from or store
// to lies on 16 bytes and every stride is a multiple of 4 floats
// (fma_layout_ok; the wrappers check it first and raise).
#pragma once

#include "common.cuh"
#include "mma_tiles.cuh"

namespace vs {
namespace attn {

constexpr int kT = 64;     // query and key tile
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
  int online;       // forward: the folded route (1) or the single pass (0)
  int d_from_o;     // backward: D = rowsum(dO * o) (1) or rowsum(dp * p)
  int guard;        // backward: p = 0 where lse < kDead
  int nsl;          // the sliced kernels: 128-column slices of a head
};

// ------------------------------------------------------------- FMA tiles
// What the f32 family (fma_fwd_kernel, fma_dq_kernel, fma_dkdv_kernel) is
// built from. A group of 8 TY threads holds a tile of RI TY rows (queries,
// or keys in dK/dV) by 64 columns: thread (ty, tx) = (g / 8, g % 8) holds
// rows ty + TY i (i < RI) and columns tx + 8 j (j < 8), and of a product's
// output the same rows and the columns fma_col(tx, n). Operand tiles sit
// row-major in shared memory, DH + 4 floats a row (16-byte aligned, rows 4
// banks apart), score tiles kSLd = 72 floats a row (rows 8 banks apart), so
// that every float4 read of a warp (4 rows x 8 columns of threads) and every
// scalar store of a score hits distinct banks or broadcasts.

constexpr int kTx = 8;         // threads across a score tile's 64 columns
constexpr int kSj = kT / kTx;  // score columns a thread holds
constexpr int kSLd = kT + 8;   // floats a row of a score tile
constexpr float kLn2 = 0.69314718055994531f;

template <int DH>
constexpr int kFmaLd = DH + 4;
// rows a thread holds: 8, or 4 at head_dim 96 and 128 (their accumulators
// are 1.5 and 2 times as wide)
template <int DH>
constexpr int kFmaRi = DH > 64 ? 4 : 8;

template <int W>
__device__ __forceinline__ void ld_vec(float* d, const float* s) {
  if constexpr (W == 4) {
    const float4 v = *reinterpret_cast<const float4*>(s);
    d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
  } else if constexpr (W == 2) {
    const float2 v = *reinterpret_cast<const float2*>(s);
    d[0] = v.x, d[1] = v.y;
  } else {
    d[0] = s[0];
  }
}

template <int W>
__device__ __forceinline__ void st_vec(float* d, const float* s) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(d) = make_float4(s[0], s[1], s[2], s[3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(d) = make_float2(s[0], s[1]);
  } else {
    d[0] = s[0];
  }
}

// Output column n (< COLS) of thread tx: chunks of CW columns (4, or 2 or 1
// where COLS is no multiple of 4: 6 in dQ at head_dim 96), 8 CW apart, so
// that a warp's 8 tx read 8 CW contiguous floats
template <int COLS>
constexpr int kFmaCw = COLS % 4 == 0 ? 4 : COLS % 2 == 0 ? 2 : 1;
template <int COLS>
__device__ __forceinline__ int fma_col(int tx, int n) {
  constexpr int CW = kFmaCw<COLS>;
  return tx * CW + 8 * CW * (n / CW) + n % CW;
}

// rows r0 .. r0 + rows - 1 of a head's (N, DH) f32 matrix at row stride sn
// into dst (kFmaLd<DH> floats a row) by 16-byte cp.async copies from
// THREADS threads, not committed; rows at or past N are zeros
template <int DH, int THREADS>
__device__ __forceinline__ void fma_stage(float* dst, const float* head,
                                          long long sn, int r0, int rows,
                                          int N) {
  constexpr int LD = kFmaLd<DH>, CH = DH / 4;
  for (int c = threadIdx.x; c < rows * CH; c += THREADS) {
    const int r = c / CH, cc = (c % CH) * 4;
    float* d = dst + r * LD + cc;
    if (r0 + r < N)
      cp_async16(d, head + (long long)(r0 + r) * sn + cc);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// s[i][j] = sum_c A[ty + TY i][c] B[tx + 8 j][c] over c in increasing order,
// A and B staged tiles: per 4 c, 8 + RI float4 reads feed 32 RI FMAs. ZERO
// false adds the products to s (the next head_dim slice of the same sum).
template <int DH, int RI, int TY, bool ZERO = true>
__device__ __forceinline__ void fma_scores(float (&s)[RI][kSj],
                                           const float* A, const float* B,
                                           int ty, int tx) {
  constexpr int LD = kFmaLd<DH>;
  if constexpr (ZERO) {
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < kSj; ++j) s[i][j] = 0.f;
  }
  const float* a0 = A + ty * LD;
  const float* b0 = B + tx * LD;
  // two steps of 4 at a time (one at head_dim 16, where a whole unrolled
  // product let ptxas hoist every load and spill); deeper unrolling was
  // slower on the card
  constexpr int U = DH > 16 ? 2 : 1;
#pragma unroll U
  for (int c = 0; c < DH; c += 4) {
    float4 y[kSj];
#pragma unroll
    for (int j = 0; j < kSj; ++j)
      y[j] = *reinterpret_cast<const float4*>(b0 + j * kTx * LD + c);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(a0 + i * TY * LD + c);
#pragma unroll
      for (int j = 0; j < kSj; ++j) {
        s[i][j] = fmaf(x.x, y[j].x, s[i][j]);
        s[i][j] = fmaf(x.y, y[j].y, s[i][j]);
        s[i][j] = fmaf(x.z, y[j].z, s[i][j]);
        s[i][j] = fmaf(x.w, y[j].w, s[i][j]);
      }
    }
  }
}

// acc[i][n] += sum_k P[ty + TY i][k] X[k][c0 + fma_col(tx, n)] over the 64
// k in increasing order, P a score tile, X a staged tile: per 4 k, RI + 4
// NC vector reads feed 4 RI COLS FMAs
template <int DH, int RI, int TY, int COLS>
__device__ __forceinline__ void fma_rows_mul(float (&acc)[RI][COLS],
                                             const float* P, const float* X,
                                             int c0, int ty, int tx) {
  constexpr int LD = kFmaLd<DH>, CW = kFmaCw<COLS>, NC = COLS / CW;
  const float* p0 = P + ty * kSLd;
  const float* x0 = X + c0 + tx * CW;
#pragma unroll 1
  for (int k = 0; k < kT; k += 4) {
    float x[4][COLS];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nc = 0; nc < NC; ++nc)
        ld_vec<CW>(&x[kk][nc * CW], x0 + (k + kk) * LD + nc * kTx * CW);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float4 p = *reinterpret_cast<const float4*>(p0 + i * TY * kSLd + k);
#pragma unroll
      for (int n = 0; n < COLS; ++n) {
        acc[i][n] = fmaf(p.x, x[0][n], acc[i][n]);
        acc[i][n] = fmaf(p.y, x[1][n], acc[i][n]);
        acc[i][n] = fmaf(p.z, x[2][n], acc[i][n]);
        acc[i][n] = fmaf(p.w, x[3][n], acc[i][n]);
      }
    }
  }
}

// ------------------------------------------------------------------ forward
template <int DH, int TY, int RI = kFmaRi<DH>>
constexpr int fma_fwd_floats() {
  constexpr int ROWS = RI * TY;
  // Q; K and V (one tile each, staggered); P; the K tile's mask bytes
  return ROWS * kFmaLd<DH> + 2 * kT * kFmaLd<DH> + ROWS * kSLd + kT / 4;
}

// One pass over the live key tiles of RI TY query rows in both modes (f32
// rounds nothing between the passes of a normalise-first order, so the fold
// computes the same function): scores in log2 units, the online fold with
// the _DEAD guards, o = acc / l and lse = (m + log2 l) ln 2 at the end.
// online (the folded route): an element with no unpadded key walks no tile
// and gives o = 0, lse = -inf; else (the single pass and the block) it
// walks every tile and gives NaN o and lse = -inf, as the normalise-first
// order does. K and V tiles stream through one buffer each: the next K
// tile loads during the fold and P.V, the next V tile during the next
// scores. With ANY_N (the serving entries) N need not be a multiple of the
// 64-row tile: rows past N stage as zeros, keys past N as padded, and a
// mask row off 16 bytes is read byte by byte; without, the training
// shapes' N % 64 == 0 and a 16-byte aligned mask are taken as given. RI,
// the rows a thread holds, is 4 in the serving entries' 64-row CTAs of 16
// TY at every head_dim.
template <int DH, int TY, int RI = kFmaRi<DH>, bool ANY_N = false>
__global__ void __launch_bounds__(kTx * TY, 2) fma_fwd_kernel(const Args a) {
  constexpr int ROWS = RI * TY, THREADS = kTx * TY;
  constexpr int LD = kFmaLd<DH>, COLS = DH / kTx, CW = kFmaCw<COLS>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // [ROWS][LD]
  float* Ks = Qs + ROWS * LD;    // [kT][LD]
  float* Vs = Ks + kT * LD;      // [kT][LD]
  float* Ps = Vs + kT * LD;      // [ROWS][kSLd], dropped e
  unsigned char* Ms = reinterpret_cast<unsigned char*>(Ps + ROWS * kSLd);
  int* tiles = reinterpret_cast<int*>(Ms + kT);
  const int N = a.N, ntiles = ANY_N ? (N + kT - 1) / kT : N / kT;
  int* count = tiles + ntiles;

  const int tid = threadIdx.x, ty = tid / kTx, tx = tid % kTx;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const long long ih = b * a.isb + h * a.ish;
  const float* kh = static_cast<const float*>(a.k) + ih;
  const float* vh = static_cast<const float*>(a.v) + ih;
  const unsigned char* mrow = a.mask + (long long)b * N;
  const unsigned base = hash_base(a.hash, a.seed, b, h);
  const float sc2 = a.scale * kLog2e;
  // mask rows on 16-byte boundaries take 16-byte copies
  const bool mvec =
      !ANY_N ||
      (N % 16 == 0 && reinterpret_cast<uintptr_t>(a.mask) % 16 == 0);

  live_tiles(mrow, N, tiles, count, !a.online, mvec);
  fma_stage<DH, THREADS>(Qs, static_cast<const float*>(a.q) + ih, a.isn, q0,
                         ROWS, N);
  cp_async_commit();
  __syncthreads();  // the tile list
  const int nlive = *count;
  auto load_k = [&](int it) {
    if (it < nlive) {
      const int k0 = tiles[it] * kT;
      fma_stage<DH, THREADS>(Ks, kh, a.isn, k0, kT, N);
      if (!ANY_N || (mvec && k0 + kT <= N)) {
        if (tid < kT / 16) cp_async16(Ms + 16 * tid, mrow + k0 + 16 * tid);
      } else if (tid < kT) {
        Ms[tid] = k0 + tid < N ? mrow[k0 + tid] : 1;  // past N: padded
      }
    }
    cp_async_commit();
  };
  auto load_v = [&](int it) {
    if (it < nlive) fma_stage<DH, THREADS>(Vs, vh, a.isn, tiles[it] * kT,
                                           kT, N);
    cp_async_commit();
  };
  load_k(0);
  load_v(0);

  float m[RI], l[RI], acc[RI][COLS];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < COLS; ++n) acc[i][n] = 0.f;
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
    const int k0 = tiles[it] * kT;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qi = q0 + ty + TY * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kSj; ++j) {
        s[i][j] = km[j] ? -INFINITY : s[i][j] * sc2;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max<kTx>(mx));
      const bool dead = m_new < kDead;
      const float m_safe = dead ? 0.f : m_new;
      const float corr = m[i] < kDead ? 0.f : ex2(m[i] - m_safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kSj; ++j) {
        const int kj = tx + kTx * j;
        const float e = dead ? 0.f : ex2(s[i][j] - m_safe);
        rs += e;
        Ps[(ty + TY * i) * kSLd + kj] =
            keep_bit(base, qi, k0 + kj, a.thr) ? e * a.kscale : 0.f;
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

  const long long oh = b * a.osb + h * a.osh;
  const long long sh = ((long long)b * a.H + h) * N;
  float* out = static_cast<float*>(a.out) + oh;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + TY * i;
    if (qi >= N) continue;
    const bool empty = a.online && l[i] == 0.f;
    const float f = empty ? 0.f : 1.f / l[i];
    float* orow = out + (long long)qi * a.osn;
#pragma unroll
    for (int n = 0; n < COLS; n += CW) {
      float v[CW];
#pragma unroll
      for (int e = 0; e < CW; ++e) v[e] = acc[i][n + e] * f;
      st_vec<CW>(orow + fma_col<COLS>(tx, n), v);
    }
    if (tx == 0 && a.lse != nullptr)
      a.lse[sh + qi] = empty ? -INFINITY : (m[i] + log2f(l[i])) * kLn2;
  }
}

// ----------------------------------------------------------------- backward
// Two groups of 8 TY threads share a tile of RI TY rows: in dQ, group 0
// computes s and p, group 1 dp and the dropped g = keep dp / (1 - rate) and
// then ds = p (g - D) (p through shared memory), and both take half of dQ's
// columns; in dK/dV, group 0 computes p and the dropped pd and accumulates
// dV, group 1 dp, ds and dK. p = exp2(s log2(e) scale - lse log2(e)).
template <int DH, int TY>
constexpr int fma_dq_floats() {
  constexpr int ROWS = kFmaRi<DH> * TY;
  // Q, dO; K and V double-buffered; P then dS; the K tiles' mask bytes
  return 2 * ROWS * kFmaLd<DH> + 4 * kT * kFmaLd<DH> + ROWS * kSLd +
         2 * kT / 4;
}

// Per RI TY query rows over their element's live key tiles (every tile of
// an element with no unpadded key unless guarded): with d_from_o, D =
// rowsum(dO * o) from the staged dO rows; without, a first pass over the
// live tiles sums D = rowsum(g * p). Writes D for dK/dV.
template <int DH, int TY>
__global__ void __launch_bounds__(2 * kTx * TY, 1) fma_dq_kernel(const Args a) {
  constexpr int RI = kFmaRi<DH>, ROWS = RI * TY, GROUP = kTx * TY;
  constexpr int THREADS = 2 * GROUP, LD = kFmaLd<DH>;
  constexpr int COLS = DH / (2 * kTx), CW = kFmaCw<COLS>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                // [ROWS][LD]
  float* dOs = Qs + ROWS * LD;     // [ROWS][LD]
  float* Ks = dOs + ROWS * LD;     // [2][kT][LD]
  float* Vs = Ks + 2 * kT * LD;    // [2][kT][LD]
  float* Ss = Vs + 2 * kT * LD;    // [ROWS][kSLd]: p, then ds
  unsigned char* Ms = reinterpret_cast<unsigned char*>(Ss + ROWS * kSLd);
  int* tiles = reinterpret_cast<int*>(Ms + 2 * kT);
  const int N = a.N, ntiles = N / kT;
  int* count = tiles + ntiles;

  const int tid = threadIdx.x, grp = tid / GROUP, gt = tid % GROUP;
  const int ty = gt / kTx, tx = gt % kTx;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const long long ih = b * a.isb + h * a.ish;
  const long long oh = b * a.osb + h * a.osh;
  const long long sh = ((long long)b * a.H + h) * N;
  const float* kh = static_cast<const float*>(a.k) + ih;
  const float* vh = static_cast<const float*>(a.v) + ih;
  const unsigned char* mrow = a.mask + (long long)b * N;
  const unsigned base = hash_base(a.hash, a.seed, b, h);
  const float sc2 = a.scale * kLog2e;

  live_tiles(mrow, N, tiles, count, !a.guard);
  fma_stage<DH, THREADS>(Qs, static_cast<const float*>(a.q) + ih, a.isn, q0,
                         ROWS, N);
  fma_stage<DH, THREADS>(dOs, static_cast<const float*>(a.dO) + oh, a.osn,
                         q0, ROWS, N);
  cp_async_commit();
  __syncthreads();  // the tile list
  const int nlive = *count;
  const int total = (a.d_from_o ? 1 : 2) * nlive;  // the D pass first
  auto tile_of = [&](int v) { return tiles[v < nlive ? v : v - nlive]; };
  auto load_kv = [&](int v) {
    if (v < total) {
      const int buf = v & 1, k0 = tile_of(v) * kT;
      fma_stage<DH, THREADS>(Ks + buf * kT * LD, kh, a.isn, k0, kT, N);
      fma_stage<DH, THREADS>(Vs + buf * kT * LD, vh, a.isn, k0, kT, N);
      if (tid < kT / 16)
        cp_async16(Ms + buf * kT + 16 * tid, mrow + k0 + 16 * tid);
    }
    cp_async_commit();
  };
  load_kv(0);

  float lr[RI], Dr[RI], part[RI];
  bool live[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + TY * i;
    const float x = row < N ? a.lse[sh + row] : 0.f;
    live[i] = !a.guard || x >= kDead;
    lr[i] = live[i] ? x * kLog2e : 0.f;
    Dr[i] = part[i] = 0.f;
  }
  cp_async_wait<1>();  // Q and dO
  __syncthreads();
  if (grp == 1 && (a.d_from_o || nlive == 0)) {
    const float* o = static_cast<const float*>(a.o) + oh;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + TY * i;
      float p = 0.f;
      if (a.d_from_o && q0 + r < N) {
#pragma unroll
        for (int u = 0; u < DH / kTx; ++u)
          p += dOs[r * LD + tx + kTx * u] *
               o[(long long)(q0 + r) * a.osn + tx + kTx * u];
      }
      Dr[i] = group_sum<kTx>(p);
      if (tx == 0 && q0 + r < N) a.D[sh + q0 + r] = Dr[i];
    }
  }

  float acc[RI][COLS];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int n = 0; n < COLS; ++n) acc[i][n] = 0.f;
  for (int v = 0; v < total; ++v) {
    const int buf = v & 1;
    if (v + 1 < total) {
      load_kv(v + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this K/V tile
    const bool dpass = v < total - nlive;
    const int k0 = tile_of(v) * kT;
    const float* Kt = Ks + buf * kT * LD;
    const unsigned char* Mb = Ms + buf * kT;
    float s[RI][kSj];
    if (grp == 0) {
      fma_scores<DH, RI, TY>(s, Qs, Kt, ty, tx);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < kSj; ++j) {
          const float sv =
              Mb[tx + kTx * j] != 0 ? -INFINITY : s[i][j] * sc2;
          Ss[(ty + TY * i) * kSLd + tx + kTx * j] =
              live[i] ? ex2(sv - lr[i]) : 0.f;
        }
    } else {
      fma_scores<DH, RI, TY>(s, dOs, Vs + buf * kT * LD, ty, tx);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < kSj; ++j)
          s[i][j] = keep_bit(base, q0 + ty + TY * i, k0 + tx + kTx * j,
                             a.thr) ? s[i][j] * a.kscale : 0.f;
    }
    __syncthreads();  // p
    if (grp == 1) {
#pragma unroll
      for (int i = 0; i < RI; ++i) {
#pragma unroll
        for (int j = 0; j < kSj; ++j) {
          float* sp = Ss + (ty + TY * i) * kSLd + tx + kTx * j;
          if (dpass)
            part[i] += s[i][j] * *sp;
          else
            *sp = *sp * (s[i][j] - Dr[i]);
        }
        if (dpass && v == nlive - 1) {
          const int r = q0 + ty + TY * i;
          Dr[i] = group_sum<kTx>(part[i]);
          if (tx == 0 && r < N) a.D[sh + r] = Dr[i];
        }
      }
    }
    __syncthreads();  // ds
    if (!dpass) fma_rows_mul<DH, RI, TY, COLS>(acc, Ss, Kt, grp * (DH / 2),
                                               ty, tx);
    __syncthreads();  // this buffer and Ss are free
  }

  float* dqh = static_cast<float*>(a.dq) + ih + grp * (DH / 2);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + TY * i;
    if (row >= N) continue;
#pragma unroll
    for (int n = 0; n < COLS; n += CW) {
      float v[CW];
#pragma unroll
      for (int e = 0; e < CW; ++e) v[e] = acc[i][n + e] * a.scale;
      st_vec<CW>(dqh + (long long)row * a.isn + fma_col<COLS>(tx, n), v);
    }
  }
}

template <int DH, int TY>
constexpr int fma_dkdv_floats() {
  constexpr int ROWS = kFmaRi<DH> * TY;
  // K, V; Q and dO double-buffered; pd; p then ds; lse and D double-buffered
  return 2 * ROWS * kFmaLd<DH> + 4 * kT * kFmaLd<DH> + 2 * ROWS * kSLd +
         4 * kT;
}

// Per RI TY keys, looping over every 64-query tile: s^T and dp^T, then
// dV += pd^T . dO (group 0) and dK += ds^T . Q (group 1). A CTA whose keys
// are all padded writes zeros and returns, unless no key of the element is
// unpadded and the route is unguarded (then it runs, as dQ walks every
// tile).
template <int DH, int TY>
__global__ void __launch_bounds__(2 * kTx * TY, 1)
    fma_dkdv_kernel(const Args a) {
  constexpr int RI = kFmaRi<DH>, ROWS = RI * TY, GROUP = kTx * TY;
  constexpr int THREADS = 2 * GROUP, LD = kFmaLd<DH>;
  constexpr int COLS = DH / kTx, CW = kFmaCw<COLS>, TILE = kT * LD;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                // [ROWS][LD]
  float* Vs = Ks + ROWS * LD;      // [ROWS][LD]
  float* Qs = Vs + ROWS * LD;      // [2][kT][LD]
  float* dOs = Qs + 2 * TILE;      // [2][kT][LD]
  float* Pd = dOs + 2 * TILE;      // [ROWS][kSLd], keys x queries
  float* Ss = Pd + ROWS * kSLd;    // [ROWS][kSLd]: p, then ds
  float* Ls = Ss + ROWS * kSLd;    // [2][kT] lse in log2 units
  float* Dq = Ls + 2 * kT;         // [2][kT] D

  const int tid = threadIdx.x, grp = tid / GROUP, gt = tid % GROUP;
  const int ty = gt / kTx, tx = gt % kTx;
  const int k0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int N = a.N;
  const long long ih = b * a.isb + h * a.ish;
  const long long oh = b * a.osb + h * a.osh;
  const long long sh = ((long long)b * a.H + h) * N;
  const unsigned char* mrow = a.mask + (long long)b * N;
  float* dkh = static_cast<float*>(a.dk) + ih;
  float* dvh = static_cast<float*>(a.dv) + ih;

  bool mine = false, any = false;
  for (int c = tid * 16; c < N; c += THREADS * 16) {
    const bool live = any_live16(mrow + c);
    any |= live;
    mine |= live && c >= k0 && c < k0 + ROWS;
  }
  any = __syncthreads_or(any);
  mine = __syncthreads_or(mine);
  if ((any || a.guard) && !mine) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int e = tid; e < ROWS * (DH / 4); e += THREADS) {
      const int r = e / (DH / 4), c = (e % (DH / 4)) * 4;
      if (k0 + r >= N) continue;
      *reinterpret_cast<float4*>(dkh + (long long)(k0 + r) * a.isn + c) = z;
      *reinterpret_cast<float4*>(dvh + (long long)(k0 + r) * a.isn + c) = z;
    }
    return;
  }

  fma_stage<DH, THREADS>(Ks, static_cast<const float*>(a.k) + ih, a.isn, k0,
                         ROWS, N);
  fma_stage<DH, THREADS>(Vs, static_cast<const float*>(a.v) + ih, a.isn, k0,
                         ROWS, N);
  const float* qh = static_cast<const float*>(a.q) + ih;
  const float* dOh = static_cast<const float*>(a.dO) + oh;
  auto load_q = [&](int qt) {
    const int q0 = qt * kT, buf = qt & 1;
    fma_stage<DH, THREADS>(Qs + buf * TILE, qh, a.isn, q0, kT, N);
    fma_stage<DH, THREADS>(dOs + buf * TILE, dOh, a.osn, q0, kT, N);
    if (tid < kT / 4)
      cp_async16(Ls + buf * kT + 4 * tid, a.lse + sh + q0 + 4 * tid);
    else if (tid < kT / 2)
      cp_async16(Dq + buf * kT + 4 * (tid - kT / 4),
                 a.D + sh + q0 + 4 * (tid - kT / 4));
    cp_async_commit();
  };
  load_q(0);  // one group with K and V

  const unsigned base = hash_base(a.hash, a.seed, b, h);
  const float sc2 = a.scale * kLog2e;
  bool km[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int key = k0 + ty + TY * i;
    km[i] = key >= N || mrow[key] != 0;
  }
  float acc[RI][COLS];  // dV in group 0, dK in group 1
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int n = 0; n < COLS; ++n) acc[i][n] = 0.f;

  const int ntq = N / kT;
  for (int qt = 0; qt < ntq; ++qt) {
    const int buf = qt & 1, q0 = qt * kT;
    if (qt + 1 < ntq) {
      load_q(qt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (tid < kT / 4) {
      // the lse whose copy this thread issued, in log2 units; +inf on a row
      // below _DEAD when guarded, so that its p = exp2(s - inf) = 0
      float* x = Ls + buf * kT + 4 * tid;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[j] = a.guard && !(x[j] >= kDead) ? INFINITY : x[j] * kLog2e;
    }
    __syncthreads();  // this Q/dO tile, its lse and D
    const float* Qt = Qs + buf * TILE;
    const float* dOt = dOs + buf * TILE;
    const float* Lt = Ls + buf * kT;
    const float* Dt = Dq + buf * kT;
    float s[RI][kSj];
    if (grp == 0) {
      fma_scores<DH, RI, TY>(s, Ks, Qt, ty, tx);  // s^T
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < kSj; ++j) {
          const int qj = tx + kTx * j, o = (ty + TY * i) * kSLd + qj;
          const float sv = km[i] ? -INFINITY : s[i][j] * sc2;
          const float p = ex2(sv - Lt[qj]);
          Ss[o] = p;
          Pd[o] = keep_bit(base, q0 + qj, k0 + ty + TY * i, a.thr)
                      ? p * a.kscale : 0.f;
        }
    } else {
      fma_scores<DH, RI, TY>(s, Vs, dOt, ty, tx);  // dp^T
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < kSj; ++j)
          s[i][j] = keep_bit(base, q0 + tx + kTx * j, k0 + ty + TY * i,
                             a.thr) ? s[i][j] * a.kscale : 0.f;
    }
    __syncthreads();  // p
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
      fma_rows_mul<DH, RI, TY, COLS>(acc, Pd, dOt, 0, ty, tx);
    else
      fma_rows_mul<DH, RI, TY, COLS>(acc, Ss, Qt, 0, ty, tx);
    __syncthreads();  // this buffer, Pd and Ss are free
  }

  float* dst = grp == 0 ? dvh : dkh;
  const float f = grp == 0 ? 1.f : a.scale;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int key = k0 + ty + TY * i;
    if (key >= N) continue;
#pragma unroll
    for (int n = 0; n < COLS; n += CW) {
      float v[CW];
#pragma unroll
      for (int e = 0; e < CW; ++e) v[e] = acc[i][n + e] * f;
      st_vec<CW>(dst + (long long)key * a.isn + fma_col<COLS>(tx, n), v);
    }
  }
}

// --------------------------------------------------------- head_dim slices
// A head wider than the widest instantiation (kSliceDh = 128 columns: the
// register tiles above end there) runs in slices of it. The wrappers
// zero-pad the head to nsl * 128 columns (ops/_cuda.kernel_head_dim: 160 ->
// 256, the second slice 32 columns wide and zero-padded), and each (row
// tile, head, element) gets nsl CTAs, blockIdx.y = h * nsl + sl. Every
// slice CTA accumulates its scores (and, backward, dp) over all nsl slices
// of the operands, staging one 128-column slice of each at a time through
// the tiles the unsliced kernel uses, in slice order 0, 1, ...: each score
// is the FMAs of its columns in increasing order, as one full-width sum
// would be, so every slice CTA of a row holds the same scores, maxima,
// sums and lse, whatever the slice count, the CTA or the batch. Each CTA
// then multiplies by, and writes, its own slice of V, O, dQ, dK and dV;
// the slice-0 CTA writes lse and D (the others hold the same bits). The
// dropout bits hash (b, h, row, column) as before. The scores are
// recomputed nsl times and nothing is double-buffered (the staging waits
// before each product): the simple form, which the bound counts once.
constexpr int kSliceDh = 128;

// nsl for a kernel head_dim past kSliceDh, else 0
inline int head_slices(int Dh) {
  return Dh > kSliceDh && Dh % kSliceDh == 0 ? Dh / kSliceDh : 0;
}

// Sliced forward: fma_fwd_kernel's fold on scores summed over the slices
template <int TY, int RI, bool ANY_N>
__global__ void __launch_bounds__(kTx * TY, 2)
    fma_fwd_sliced_kernel(const Args a) {
  constexpr int DH = kSliceDh, ROWS = RI * TY, THREADS = kTx * TY;
  constexpr int LD = kFmaLd<DH>, COLS = DH / kTx, CW = kFmaCw<COLS>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // [ROWS][LD], slice j of the query rows
  float* Ks = Qs + ROWS * LD;    // [kT][LD], slice j of the key tile
  float* Vs = Ks + kT * LD;      // [kT][LD], the own slice of V
  float* Ps = Vs + kT * LD;      // [ROWS][kSLd], dropped e
  unsigned char* Ms = reinterpret_cast<unsigned char*>(Ps + ROWS * kSLd);
  int* tiles = reinterpret_cast<int*>(Ms + kT);
  const int N = a.N, ntiles = ANY_N ? (N + kT - 1) / kT : N / kT;
  int* count = tiles + ntiles;

  const int nsl = a.nsl, tid = threadIdx.x, ty = tid / kTx, tx = tid % kTx;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y / nsl;
  const int sl = blockIdx.y % nsl, b = blockIdx.z;
  const long long ih = b * a.isb + h * a.ish;
  const float* qh = static_cast<const float*>(a.q) + ih;
  const float* kh = static_cast<const float*>(a.k) + ih;
  const float* vh = static_cast<const float*>(a.v) + ih + sl * DH;
  const unsigned char* mrow = a.mask + (long long)b * N;
  const unsigned base = hash_base(a.hash, a.seed, b, h);
  const float sc2 = a.scale * kLog2e;
  const bool mvec =
      !ANY_N ||
      (N % 16 == 0 && reinterpret_cast<uintptr_t>(a.mask) % 16 == 0);

  live_tiles(mrow, N, tiles, count, !a.online, mvec);
  __syncthreads();  // the tile list
  const int nlive = *count;

  float m[RI], l[RI], acc[RI][COLS];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < COLS; ++n) acc[i][n] = 0.f;
  }
  for (int it = 0; it < nlive; ++it) {
    const int k0 = tiles[it] * kT;
    float s[RI][kSj];
    for (int j = 0; j < nsl; ++j) {
      __syncthreads();  // the last readers of Qs, Ks, Ms, Vs and Ps are done
      fma_stage<DH, THREADS>(Qs, qh + j * DH, a.isn, q0, ROWS, N);
      fma_stage<DH, THREADS>(Ks, kh + j * DH, a.isn, k0, kT, N);
      if (j == 0) {
        if (!ANY_N || (mvec && k0 + kT <= N)) {
          if (tid < kT / 16) cp_async16(Ms + 16 * tid, mrow + k0 + 16 * tid);
        } else if (tid < kT) {
          Ms[tid] = k0 + tid < N ? mrow[k0 + tid] : 1;  // past N: padded
        }
      }
      if (j == nsl - 1) fma_stage<DH, THREADS>(Vs, vh, a.isn, k0, kT, N);
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
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qi = q0 + ty + TY * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kSj; ++j) {
        s[i][j] = km[j] ? -INFINITY : s[i][j] * sc2;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max<kTx>(mx));
      const bool dead = m_new < kDead;
      const float m_safe = dead ? 0.f : m_new;
      const float corr = m[i] < kDead ? 0.f : ex2(m[i] - m_safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kSj; ++j) {
        const int kj = tx + kTx * j;
        const float e = dead ? 0.f : ex2(s[i][j] - m_safe);
        rs += e;
        Ps[(ty + TY * i) * kSLd + kj] =
            keep_bit(base, qi, k0 + kj, a.thr) ? e * a.kscale : 0.f;
      }
      l[i] = l[i] * corr + group_sum<kTx>(rs);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < COLS; ++n) acc[i][n] *= corr;
    }
    __syncthreads();  // P written
    fma_rows_mul<DH, RI, TY, COLS>(acc, Ps, Vs, 0, ty, tx);
  }

  const long long oh = b * a.osb + h * a.osh + sl * DH;
  const long long sh = ((long long)b * a.H + h) * N;
  float* out = static_cast<float*>(a.out) + oh;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + TY * i;
    if (qi >= N) continue;
    const bool empty = a.online && l[i] == 0.f;
    const float f = empty ? 0.f : 1.f / l[i];
    float* orow = out + (long long)qi * a.osn;
#pragma unroll
    for (int n = 0; n < COLS; n += CW) {
      float v[CW];
#pragma unroll
      for (int e = 0; e < CW; ++e) v[e] = acc[i][n + e] * f;
      st_vec<CW>(orow + fma_col<COLS>(tx, n), v);
    }
    if (sl == 0 && tx == 0 && a.lse != nullptr)
      a.lse[sh + qi] = empty ? -INFINITY : (m[i] + log2f(l[i])) * kLn2;
  }
}

// Sliced dQ: fma_dq_kernel's arithmetic with s and dp summed over the
// slices; D = rowsum(dO * o) over the whole head from device memory (the
// columns of each of a row's 8 threads in increasing order, as unsliced);
// the own slice of K for dS.K in the second K buffer
template <int TY>
__global__ void __launch_bounds__(2 * kTx * TY, 1)
    fma_dq_sliced_kernel(const Args a) {
  constexpr int DH = kSliceDh, RI = kFmaRi<DH>, ROWS = RI * TY;
  constexpr int GROUP = kTx * TY, THREADS = 2 * GROUP, LD = kFmaLd<DH>;
  constexpr int COLS = DH / (2 * kTx), CW = kFmaCw<COLS>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                // [ROWS][LD], slice j
  float* dOs = Qs + ROWS * LD;     // [ROWS][LD], slice j
  float* Ks = dOs + ROWS * LD;     // [2][kT][LD]: slice j, the own slice
  float* Vs = Ks + 2 * kT * LD;    // [kT][LD], slice j
  float* Ss = Vs + 2 * kT * LD;    // [ROWS][kSLd]: p, then ds
  unsigned char* Ms = reinterpret_cast<unsigned char*>(Ss + ROWS * kSLd);
  int* tiles = reinterpret_cast<int*>(Ms + 2 * kT);
  const int N = a.N, ntiles = N / kT;
  int* count = tiles + ntiles;

  const int nsl = a.nsl, tid = threadIdx.x, grp = tid / GROUP;
  const int gt = tid % GROUP, ty = gt / kTx, tx = gt % kTx;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y / nsl;
  const int sl = blockIdx.y % nsl, b = blockIdx.z;
  const long long ih = b * a.isb + h * a.ish;
  const long long oh = b * a.osb + h * a.osh;
  const long long sh = ((long long)b * a.H + h) * N;
  const float* qh = static_cast<const float*>(a.q) + ih;
  const float* kh = static_cast<const float*>(a.k) + ih;
  const float* vh = static_cast<const float*>(a.v) + ih;
  const float* dOh = static_cast<const float*>(a.dO) + oh;
  const unsigned char* mrow = a.mask + (long long)b * N;
  const unsigned base = hash_base(a.hash, a.seed, b, h);
  const float sc2 = a.scale * kLog2e;

  live_tiles(mrow, N, tiles, count, !a.guard);
  __syncthreads();  // the tile list
  const int nlive = *count;
  const int total = (a.d_from_o ? 1 : 2) * nlive;  // the D pass first
  auto tile_of = [&](int v) { return tiles[v < nlive ? v : v - nlive]; };

  float lr[RI], Dr[RI], part[RI];
  bool live[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + TY * i;
    const float x = row < N ? a.lse[sh + row] : 0.f;
    live[i] = !a.guard || x >= kDead;
    lr[i] = live[i] ? x * kLog2e : 0.f;
    Dr[i] = part[i] = 0.f;
  }
  if (grp == 1 && (a.d_from_o || nlive == 0)) {
    const float* o = static_cast<const float*>(a.o) + oh;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + TY * i;
      float p = 0.f;
      if (a.d_from_o && q0 + r < N) {
        const long long row = (long long)(q0 + r) * a.osn;
        for (int c = tx; c < nsl * DH; c += kTx)
          p += dOh[row + c] * o[row + c];
      }
      Dr[i] = group_sum<kTx>(p);
      if (sl == 0 && tx == 0 && q0 + r < N) a.D[sh + q0 + r] = Dr[i];
    }
  }

  float acc[RI][COLS];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int n = 0; n < COLS; ++n) acc[i][n] = 0.f;
  for (int v = 0; v < total; ++v) {
    const bool dpass = v < total - nlive;
    const int k0 = tile_of(v) * kT;
    float s[RI][kSj];
    for (int j = 0; j < nsl; ++j) {
      __syncthreads();  // the last readers of every tile and of Ss are done
      fma_stage<DH, THREADS>(Qs, qh + j * DH, a.isn, q0, ROWS, N);
      fma_stage<DH, THREADS>(dOs, dOh + j * DH, a.osn, q0, ROWS, N);
      fma_stage<DH, THREADS>(Ks, kh + j * DH, a.isn, k0, kT, N);
      fma_stage<DH, THREADS>(Vs, vh + j * DH, a.isn, k0, kT, N);
      if (j == 0 && tid < kT / 16)
        cp_async16(Ms + 16 * tid, mrow + k0 + 16 * tid);
      if (j == nsl - 1 && !dpass)
        fma_stage<DH, THREADS>(Ks + kT * LD, kh + sl * DH, a.isn, k0, kT, N);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      const float* A = grp == 0 ? Qs : dOs;
      const float* Bt = grp == 0 ? Ks : Vs;
      if (j == 0)
        fma_scores<DH, RI, TY>(s, A, Bt, ty, tx);
      else
        fma_scores<DH, RI, TY, false>(s, A, Bt, ty, tx);
    }
    if (grp == 0) {
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < kSj; ++j) {
          const float sv = Ms[tx + kTx * j] != 0 ? -INFINITY : s[i][j] * sc2;
          Ss[(ty + TY * i) * kSLd + tx + kTx * j] =
              live[i] ? ex2(sv - lr[i]) : 0.f;
        }
    } else {
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < kSj; ++j)
          s[i][j] = keep_bit(base, q0 + ty + TY * i, k0 + tx + kTx * j,
                             a.thr) ? s[i][j] * a.kscale : 0.f;
    }
    __syncthreads();  // p
    if (grp == 1) {
#pragma unroll
      for (int i = 0; i < RI; ++i) {
#pragma unroll
        for (int j = 0; j < kSj; ++j) {
          float* sp = Ss + (ty + TY * i) * kSLd + tx + kTx * j;
          if (dpass)
            part[i] += s[i][j] * *sp;
          else
            *sp = *sp * (s[i][j] - Dr[i]);
        }
        if (dpass && v == nlive - 1) {
          const int r = q0 + ty + TY * i;
          Dr[i] = group_sum<kTx>(part[i]);
          if (sl == 0 && tx == 0 && r < N) a.D[sh + r] = Dr[i];
        }
      }
    }
    __syncthreads();  // ds
    if (!dpass)
      fma_rows_mul<DH, RI, TY, COLS>(acc, Ss, Ks + kT * LD, grp * (DH / 2),
                                     ty, tx);
  }

  float* dqh = static_cast<float*>(a.dq) + ih + sl * DH + grp * (DH / 2);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + TY * i;
    if (row >= N) continue;
#pragma unroll
    for (int n = 0; n < COLS; n += CW) {
      float v[CW];
#pragma unroll
      for (int e = 0; e < CW; ++e) v[e] = acc[i][n + e] * a.scale;
      st_vec<CW>(dqh + (long long)row * a.isn + fma_col<COLS>(tx, n), v);
    }
  }
}

// Sliced dK/dV: fma_dkdv_kernel's arithmetic with s^T and dp^T summed over
// the slices (K, V and the query tile's Q, dO restaged per slice); the own
// slices of Q and dO for the two products in the second buffers
template <int TY>
__global__ void __launch_bounds__(2 * kTx * TY, 1)
    fma_dkdv_sliced_kernel(const Args a) {
  constexpr int DH = kSliceDh, RI = kFmaRi<DH>, ROWS = RI * TY;
  constexpr int GROUP = kTx * TY, THREADS = 2 * GROUP, LD = kFmaLd<DH>;
  constexpr int COLS = DH / kTx, CW = kFmaCw<COLS>, TILE = kT * LD;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                // [ROWS][LD], slice j
  float* Vs = Ks + ROWS * LD;      // [ROWS][LD], slice j
  float* Qs = Vs + ROWS * LD;      // [2][kT][LD]: slice j, the own slice
  float* dOs = Qs + 2 * TILE;      // [2][kT][LD]: slice j, the own slice
  float* Pd = dOs + 2 * TILE;      // [ROWS][kSLd], keys x queries
  float* Ss = Pd + ROWS * kSLd;    // [ROWS][kSLd]: p, then ds
  float* Ls = Ss + ROWS * kSLd;    // [kT] lse in log2 units
  float* Dq = Ls + 2 * kT;         // [kT] D

  const int nsl = a.nsl, tid = threadIdx.x, grp = tid / GROUP;
  const int gt = tid % GROUP, ty = gt / kTx, tx = gt % kTx;
  const int k0 = blockIdx.x * ROWS, h = blockIdx.y / nsl;
  const int sl = blockIdx.y % nsl, b = blockIdx.z;
  const int N = a.N;
  const long long ih = b * a.isb + h * a.ish;
  const long long oh = b * a.osb + h * a.osh;
  const long long sh = ((long long)b * a.H + h) * N;
  const unsigned char* mrow = a.mask + (long long)b * N;
  float* dkh = static_cast<float*>(a.dk) + ih + sl * DH;
  float* dvh = static_cast<float*>(a.dv) + ih + sl * DH;

  bool mine = false, any = false;
  for (int c = tid * 16; c < N; c += THREADS * 16) {
    const bool live = any_live16(mrow + c);
    any |= live;
    mine |= live && c >= k0 && c < k0 + ROWS;
  }
  any = __syncthreads_or(any);
  mine = __syncthreads_or(mine);
  if ((any || a.guard) && !mine) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int e = tid; e < ROWS * (DH / 4); e += THREADS) {
      const int r = e / (DH / 4), c = (e % (DH / 4)) * 4;
      if (k0 + r >= N) continue;
      *reinterpret_cast<float4*>(dkh + (long long)(k0 + r) * a.isn + c) = z;
      *reinterpret_cast<float4*>(dvh + (long long)(k0 + r) * a.isn + c) = z;
    }
    return;
  }

  const float* kh = static_cast<const float*>(a.k) + ih;
  const float* vh = static_cast<const float*>(a.v) + ih;
  const float* qh = static_cast<const float*>(a.q) + ih;
  const float* dOh = static_cast<const float*>(a.dO) + oh;
  const unsigned base = hash_base(a.hash, a.seed, b, h);
  const float sc2 = a.scale * kLog2e;
  bool km[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int key = k0 + ty + TY * i;
    km[i] = key >= N || mrow[key] != 0;
  }
  float acc[RI][COLS];  // dV in group 0, dK in group 1
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int n = 0; n < COLS; ++n) acc[i][n] = 0.f;

  const int ntq = N / kT;
  for (int qt = 0; qt < ntq; ++qt) {
    const int q0 = qt * kT;
    float s[RI][kSj];
    for (int j = 0; j < nsl; ++j) {
      __syncthreads();  // the last readers of every tile, Pd and Ss are done
      fma_stage<DH, THREADS>(Ks, kh + j * DH, a.isn, k0, ROWS, N);
      fma_stage<DH, THREADS>(Vs, vh + j * DH, a.isn, k0, ROWS, N);
      fma_stage<DH, THREADS>(Qs, qh + j * DH, a.isn, q0, kT, N);
      fma_stage<DH, THREADS>(dOs, dOh + j * DH, a.osn, q0, kT, N);
      if (j == 0) {
        if (tid < kT / 4)
          cp_async16(Ls + 4 * tid, a.lse + sh + q0 + 4 * tid);
        else if (tid < kT / 2)
          cp_async16(Dq + 4 * (tid - kT / 4),
                     a.D + sh + q0 + 4 * (tid - kT / 4));
      }
      if (j == nsl - 1) {
        fma_stage<DH, THREADS>(Qs + TILE, qh + sl * DH, a.isn, q0, kT, N);
        fma_stage<DH, THREADS>(dOs + TILE, dOh + sl * DH, a.osn, q0, kT, N);
      }
      cp_async_commit();
      cp_async_wait<0>();
      if (j == 0 && tid < kT / 4) {
        // the lse whose copy this thread issued, in log2 units; +inf on a
        // row below _DEAD when guarded, so that its p = exp2(s - inf) = 0
        float* x = Ls + 4 * tid;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[e] = a.guard && !(x[e] >= kDead) ? INFINITY : x[e] * kLog2e;
      }
      __syncthreads();
      const float* A = grp == 0 ? Ks : Vs;
      const float* Bt = grp == 0 ? Qs : dOs;
      if (j == 0)
        fma_scores<DH, RI, TY>(s, A, Bt, ty, tx);
      else
        fma_scores<DH, RI, TY, false>(s, A, Bt, ty, tx);
    }
    if (grp == 0) {
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < kSj; ++j) {
          const int qj = tx + kTx * j, o = (ty + TY * i) * kSLd + qj;
          const float sv = km[i] ? -INFINITY : s[i][j] * sc2;
          const float p = ex2(sv - Ls[qj]);
          Ss[o] = p;
          Pd[o] = keep_bit(base, q0 + qj, k0 + ty + TY * i, a.thr)
                      ? p * a.kscale : 0.f;
        }
    } else {
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < kSj; ++j)
          s[i][j] = keep_bit(base, q0 + tx + kTx * j, k0 + ty + TY * i,
                             a.thr) ? s[i][j] * a.kscale : 0.f;
    }
    __syncthreads();  // p
    if (grp == 1) {
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < kSj; ++j) {
          const int qj = tx + kTx * j;
          float* sp = Ss + (ty + TY * i) * kSLd + qj;
          *sp = *sp * (s[i][j] - Dq[qj]);
        }
    }
    __syncthreads();  // ds
    if (grp == 0)
      fma_rows_mul<DH, RI, TY, COLS>(acc, Pd, dOs + TILE, 0, ty, tx);
    else
      fma_rows_mul<DH, RI, TY, COLS>(acc, Ss, Qs + TILE, 0, ty, tx);
  }

  float* dst = grp == 0 ? dvh : dkh;
  const float f = grp == 0 ? 1.f : a.scale;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int key = k0 + ty + TY * i;
    if (key >= N) continue;
#pragma unroll
    for (int n = 0; n < COLS; n += CW) {
      float v[CW];
#pragma unroll
      for (int e = 0; e < CW; ++e) v[e] = acc[i][n + e] * f;
      st_vec<CW>(dst + (long long)key * a.isn + fma_col<COLS>(tx, n), v);
    }
  }
}

// ------------------------------------------------------------------ launches
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, int bytes) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// head_dim 16, 32, 64, 96 or 128 (ops/_cuda.HEAD_DIMS), or a multiple of
// 128 past it (the sliced kernels)
inline bool head_dim_ok(int Dh) {
  return Dh == 16 || Dh == 32 || Dh == 64 || Dh == 96 || Dh == 128 ||
         head_slices(Dh) > 0;
}

// the serving forward's shapes (masked_attention.cu, f32): any N
inline bool serve_shape_ok(int B, int H, int N, int Dh) {
  return B > 0 && H > 0 && N > 0 && B <= 65535 && H <= 65535 &&
         head_dim_ok(Dh);
}

// the training shapes: N a multiple of the 64-row tile
inline bool shape_ok(int B, int H, int N, int Dh) {
  return serve_shape_ok(B, H, N, Dh) && N % kT == 0;
}

// The FMA family stages its operands by 16-byte cp.async copies and writes
// its outputs by 16-byte stores: every base pointer it copies from or
// stores to on a 16-byte boundary and every stride a multiple of 4 floats
// (ops/block_train.attention_layout_ok and ops/attention.attention_takes_fma
// check the same before a launch). The backward's o is read by scalar
// loads; the forward reads a mask row off 16 bytes byte by byte.
inline bool fma_layout_ok(const Args& a, bool bwd) {
  const bool strides = a.isb % 4 == 0 && a.ish % 4 == 0 && a.isn % 4 == 0 &&
                       a.osb % 4 == 0 && a.osh % 4 == 0 && a.osn % 4 == 0;
  const bool ins = aligned16(a.q) && aligned16(a.k) && aligned16(a.v);
  if (!bwd) return strides && ins && aligned16(a.out);
  return strides && ins && aligned16(a.mask) && aligned16(a.dO) &&
         aligned16(a.lse) && aligned16(a.D) && aligned16(a.dq) &&
         aligned16(a.dk) && aligned16(a.dv);
}

inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// True when a grid of CTAs of `rows` rows holds at least `per_sm` CTAs an
// SM: the forward takes 16-deep thread tiles (128 rows, or 64 at head_dim
// 128) where they fill both of every SM's CTA slots, the backward kernels
// (one CTA an SM) where they fill half the SMs, else the 8-deep ones (half
// the rows, twice the CTAs): at one CTA an SM, 16-deep CTAs on most SMs
// beat twice as many 8-deep ones, which hold half the warps each.
inline bool fma_wide(int B, int H, int N, int rows, float per_sm) {
  return (float)((N + rows - 1) / rows) * H * B >= per_sm * sm_count();
}

template <int DH, int TY, int RI = kFmaRi<DH>, bool ANY_N = false>
cudaError_t launch_fma_fwd(const Args& a, int B, cudaStream_t s) {
  constexpr int ROWS = RI * TY;
  const int bytes =
      (fma_fwd_floats<DH, TY, RI>() + (a.N + kT - 1) / kT + 1) * 4;
  auto kernel = fma_fwd_kernel<DH, TY, RI, ANY_N>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.N + ROWS - 1) / ROWS, a.H, B), kTx * TY, bytes, s>>>(a);
  return cudaGetLastError();
}

// fma_dq_kernel writes D, which fma_dkdv_kernel reads after it on the same
// stream
template <int DH, int TYQ, int TYK>
cudaError_t launch_fma_bwd(const Args& a, int B, cudaStream_t s) {
  constexpr int RQ = kFmaRi<DH> * TYQ, RK = kFmaRi<DH> * TYK;
  const int dq_bytes = (fma_dq_floats<DH, TYQ>() + a.N / kT + 1) * 4;
  const int kv_bytes = fma_dkdv_floats<DH, TYK>() * 4;
  cudaError_t err = allow_smem(fma_dq_kernel<DH, TYQ>, dq_bytes);
  if (err == cudaSuccess)
    err = allow_smem(fma_dkdv_kernel<DH, TYK>, kv_bytes);
  if (err != cudaSuccess) return err;
  fma_dq_kernel<DH, TYQ><<<dim3((a.N + RQ - 1) / RQ, a.H, B),
                           2 * kTx * TYQ, dq_bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fma_dkdv_kernel<DH, TYK><<<dim3((a.N + RK - 1) / RK, a.H, B),
                             2 * kTx * TYK, kv_bytes, s>>>(a);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_fwd(const Args& a, int B, cudaStream_t s) {
  if (!fma_layout_ok(a, false)) return cudaErrorMisalignedAddress;
  return fma_wide(B, a.H, a.N, kFmaRi<DH> * 16, 2.f)
             ? launch_fma_fwd<DH, 16>(a, B, s)
             : launch_fma_fwd<DH, 8>(a, B, s);
}

// At head_dim 128 a 16-deep dK/dV CTA would need 240 KB of shared memory:
// it keeps 8-deep ones (at 96, 4 rows a thread, it needs 191 KB)
template <int DH>
cudaError_t launch_bwd(const Args& a, int B, cudaStream_t s) {
  if (a.d_from_o && a.o == nullptr) return cudaErrorInvalidValue;
  if (!fma_layout_ok(a, true)) return cudaErrorMisalignedAddress;
  constexpr int TYK = DH >= 128 ? 8 : 16;
  return fma_wide(B, a.H, a.N, kFmaRi<DH> * 16, 0.5f)
             ? launch_fma_bwd<DH, 16, TYK>(a, B, s)
             : launch_fma_bwd<DH, 8, 8>(a, B, s);
}

// The sliced kernels over a head of nsl * 128 columns: 64-row CTAs (16 TY,
// 4 rows a thread) forward, 32-row ones (8 TY) in dQ and dK/dV, in the
// shared memory of the unsliced kernels at head_dim 128 in the same shapes
// (119,872 bytes forward, 178,304 dQ, 188,416 dK/dV, plus the live-tile
// list)
inline bool sliced_grid_ok(const Args& a) {
  return a.nsl > 0 && (long long)a.H * a.nsl <= 65535;
}

template <bool ANY_N>
cudaError_t launch_fwd_sliced(const Args& a, int B, cudaStream_t s) {
  constexpr int TY = 16, RI = kFmaRi<kSliceDh>, ROWS = RI * TY;
  if (!sliced_grid_ok(a)) return cudaErrorInvalidValue;
  if (!fma_layout_ok(a, false)) return cudaErrorMisalignedAddress;
  const int bytes =
      (fma_fwd_floats<kSliceDh, TY, RI>() + (a.N + kT - 1) / kT + 1) * 4;
  auto kernel = fma_fwd_sliced_kernel<TY, RI, ANY_N>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.N + ROWS - 1) / ROWS, a.H * a.nsl, B), kTx * TY, bytes,
           s>>>(a);
  return cudaGetLastError();
}

inline cudaError_t launch_bwd_sliced(const Args& a, int B, cudaStream_t s) {
  constexpr int TY = 8, ROWS = kFmaRi<kSliceDh> * TY;
  if (!sliced_grid_ok(a)) return cudaErrorInvalidValue;
  if (a.d_from_o && a.o == nullptr) return cudaErrorInvalidValue;
  if (!fma_layout_ok(a, true)) return cudaErrorMisalignedAddress;
  const int dq_bytes = (fma_dq_floats<kSliceDh, TY>() + a.N / kT + 1) * 4;
  const int kv_bytes = fma_dkdv_floats<kSliceDh, TY>() * 4;
  cudaError_t err = allow_smem(fma_dq_sliced_kernel<TY>, dq_bytes);
  if (err == cudaSuccess)
    err = allow_smem(fma_dkdv_sliced_kernel<TY>, kv_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + ROWS - 1) / ROWS, a.H * a.nsl, B);
  fma_dq_sliced_kernel<TY><<<grid, 2 * kTx * TY, dq_bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fma_dkdv_sliced_kernel<TY><<<grid, 2 * kTx * TY, kv_bytes, s>>>(a);
  return cudaGetLastError();
}

// Dispatch on head_dim (shape_ok's)
inline cudaError_t launch_fwd_dh(const Args& a, int B, int Dh,
                                 cudaStream_t s) {
  switch (Dh) {
    case 16: return launch_fwd<16>(a, B, s);
    case 32: return launch_fwd<32>(a, B, s);
    case 64: return launch_fwd<64>(a, B, s);
    case 96: return launch_fwd<96>(a, B, s);
    case 128: return launch_fwd<128>(a, B, s);
    default: {
      Args b = a;
      b.nsl = head_slices(Dh);
      return launch_fwd_sliced<false>(b, B, s);
    }
  }
}

inline cudaError_t launch_bwd_dh(const Args& a, int B, int Dh,
                                 cudaStream_t s) {
  switch (Dh) {
    case 16: return launch_bwd<16>(a, B, s);
    case 32: return launch_bwd<32>(a, B, s);
    case 64: return launch_bwd<64>(a, B, s);
    case 96: return launch_bwd<96>(a, B, s);
    case 128: return launch_bwd<128>(a, B, s);
    default: {
      Args b = a;
      b.nsl = head_slices(Dh);
      return launch_bwd_sliced(b, B, s);
    }
  }
}

}  // namespace attn
}  // namespace vs
