// attention_train_mma: the bf16 training attention on the tensor cores, both
// routes, for sm_90a.
//
// Replaces, for bf16 inputs, the TPU kernels
// vidsum_tpu/ops/attention_train.py:83 _fwd_kernel (normalise-first forward),
// :112 _bwd_kernel (its backward, D = rowsum(dp * p) over the full row),
// :175 _fwd_kernel_folded (the online forward over key blocks) and
// :228 _bwd_kernel_folded (its backward, D = rowsum(dO * o), the lse guard).
// f32 keeps attention_core.cuh's FMA family on both routes: a TF32 product
// would not compute what the TPU's f32 kernels compute. What is computed is
// the TPU kernels' function, rounded where they round:
//   forward   s = q . k^T (bf16 operands, f32 accumulate), scaled, -inf at
//             padded keys.
//             normalise-first: pass 1 folds the row max m and sum l over the
//             key tiles; pass 2 p = exp(s - m) / l in f32, dropped and
//             scaled by 1 / (1 - rate), rounded to bf16, then P.V (f32
//             accumulate); lse = m + log(l).
//             online (the folded route): one pass folds m and l with the
//             _DEAD guards (e = 0 on a row whose max is below _DEAD, the
//             correction exp(m_old - m) = 0 while m_old is), l sums the raw
//             e, the dropped e is rounded to bf16 unnormalised against the
//             tile's running max and o = o * corr + e . V; at the end
//             o = o / l and lse = m + log(l), or o = 0 and lse = -inf on a
//             row with l = 0.
//   backward  p = exp(s - lse) (folded: 0 on a row whose lse is below
//             _DEAD); dp = dO . V^T (bf16 values, whose products are exact
//             in f32: the TPU's f32 x f32 product up to summation order),
//             dropped; D = rowsum(dp * p) over the full row, or (folded)
//             rowsum(dO * o) from the forward's bf16 o; ds = p (dp - D)
//             rounded to bf16 for dQ = ds . K and dK = ds^T . Q; dV = pd^T .
//             dO with the dropped pd kept in f32, unrounded, as on the TPU:
//             pd is split into three bf16 terms (hi = bf16(pd), mid =
//             bf16(pd - hi), lo = bf16(pd - hi - mid): 3 x 8 significand
//             bits, f32's 24), each multiplied on the tensor cores.
// The dropout bits are attention_core.cuh's kHashAttention family
// (_keep_mask_block), computed in the accumulator layout: each thread knows
// the (row, column) of every element it holds, with the row term
// base ^ row * 0xC2B2AE3D kept per row and the column term col * 0x27D4EB2F
// built from one product per tile.
//
// Layout. A CTA of W warps takes 16 W query rows (forward, dQ) or keys
// (dK/dV); each warp owns 16 of them as mma.sync m16n8k16 tiles (bf16 in,
// f32 accumulate). Operand tiles of 64 rows sit in shared memory row-major,
// each row padded by 8 bf16, so that every 32-bit fragment load and every
// ldmatrix phase of a warp hits distinct banks. A-fragments of P and dS are
// packed straight from the score accumulators (FlashAttention-2); the
// B-fragments of V, K, Q and dO where the product contracts over rows come
// from ldmatrix.trans. The streamed tiles (K/V in the forward and dQ, Q/dO
// with their lse and D in dK/dV) are double-buffered with 16-byte cp.async
// copies, so tile i + 1 loads while tile i computes. Key tiles whose 64 keys
// are all padded add exact zeros to every sum and nothing to any max (in the
// online fold they leave m, l and o bit for bit: corr = exp(0) = 1), so the
// forward and dQ walk only the live tiles of their element and a dK/dV CTA
// whose keys are all padded writes zeros. An element with no unpadded key at
// all walks every tile on the single-pass route and gives what the FMA
// family gives it (NaN o); on the folded route it walks none and gives
// o = 0, lse = -inf and zero grads, the FMA family's bits. The folded mode
// is the single-pass kernels with a template flag: the forward fuses the
// two passes into one, and dQ takes D from the o and dO rows of its own
// warp in place of its first pass over the keys. The backward is
// deterministic: dQ per query tile, dK/dV per key tile over the query
// tiles, no atomics. The staging, the live-tile scan and the fragment
// helpers are mma_tiles.cuh's, shared with the bf16 serving attention.
//
// Bound on the card (B, H, N, Dh) = (2, 4, 8192, 64), valid (8100, 5000):
// the forward's products are 4 Dh H N sum(valid) = 0.11 TFLOP, 0.11 ms at
// the bf16 peak on either route; the backward's dp, dQ, dK and dV's three
// split products 0.33 TFLOP, 0.33 ms (the recompute of s not counted).
// Below that lies the work per score element (H N sum(valid) = 0.43 G
// elements a pass): an exp in every pass at 16 MUFU ops per clock and SM,
// and the ~11-op hash in every dropout pass. The single pass makes 2
// forward and 3 backward passes (1 and 3 of them hashed), so its floor is
// ~0.5 ms forward and ~1.2 ms backward; the fold makes 1 and 2 (all
// hashed), ~0.4 ms and ~0.9 ms. mma.sync is enough to reach that floor
// (wgmma and TMA would speed the part already under it).
#pragma once

#include "attention_core.cuh"
#include "mma_tiles.cuh"

namespace vs {
namespace attn_mma {

using bf = __nv_bfloat16;
using attn::Args;

// Warps per CTA (W) of each kernel; a warp owns 16 rows (queries, or keys
// in dK/dV), so a CTA owns 16 W rows and every streamed tile is shared by W
// warps. The forward and dQ take 8 at head_dim <= 64, so a K/V tile read
// from L2 feeds 128 query rows, and 4 at 96 and 128, where their registers
// bound the warps an SM holds; dK/dV takes 4. The backward's launch bounds
// cap its registers at head_dim <= 64 so that more warps share an SM (dQ
// 16, at <= 128 registers; dK/dV 12, at <= 168). Each choice won a
// comparison of variants on the card; at 96 and 128 the accumulators need
// the registers, and the kernels take no cap.
template <int DH>
constexpr int kFwdWarps = DH > 64 ? 4 : 8;
template <int DH>
constexpr int kDqWarps = DH > 64 ? 4 : 8;
constexpr int kDkdvWarps = 4;
constexpr int kT = kKeyTile;  // rows of a streamed tile
constexpr unsigned kRowMul = 0xC2B2AE3Du;  // _keep_mask_block's row term
constexpr unsigned kColMul = 0x27D4EB2Fu;  // and its column term

// keep_bit's mixing of x = base ^ row term ^ column term against thr
__device__ __forceinline__ bool keep_mix(unsigned x, unsigned thr) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= thr;
}

// ------------------------------------------------------------------ forward
template <int DH, int W>
constexpr int fwd_smem_fixed() {
  // Q, K x2, V x2, masks x2
  return (16 * W + 4 * kT) * (DH + kLdsPad) * 2 + 2 * kT;
}

// ONLINE: the folded route's one-pass forward (_fwd_kernel_folded); else
// the single-pass route's normalise-first one (_fwd_kernel). Both modes ask
// for two CTAs per SM: at head_dim <= 64 (8 warps) that caps a thread at
// 128 registers, which both fit without a spill; at 96 and 128 (4 warps)
// it caps nothing. Without it the online mode took 141 registers, one CTA
// per SM, and an explicit minimum of one CTA slowed the normalise-first
// mode by a third, in comparisons on the card.
template <int DH, int W, bool ONLINE>
__global__ void __launch_bounds__(32 * W, 2) fwd_mma_kernel(const Args a) {
  constexpr int LD = DH + kLdsPad, KS = DH / 16, ND = DH / 8;
  constexpr int TILE = kT * LD, THREADS = 32 * W, ROWS = 16 * W;
  extern __shared__ __align__(16) unsigned char smem[];
  bf* Qs = reinterpret_cast<bf*>(smem);  // [ROWS][LD]
  bf* Ks = Qs + ROWS * LD;  // [2][kT][LD]
  bf* Vs = Ks + 2 * TILE;  // [2][kT][LD]
  unsigned char* Ms = reinterpret_cast<unsigned char*>(Vs + 2 * TILE);
  int* tiles = reinterpret_cast<int*>(Ms + 2 * kT);
  const int N = a.N, ntiles = N / kT;
  int* count = tiles + ntiles;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const long long ih = b * a.isb + h * a.ish;
  const bf* kh = static_cast<const bf*>(a.k) + ih;
  const bf* vh = static_cast<const bf*>(a.v) + ih;
  const unsigned char* mrow = a.mask + (long long)b * N;
  const unsigned base = attn::hash_base(a.hash, a.seed, b, h);
  const bool drop = a.thr != 0u;
  const int r = warp * 16 + g;  // the warp's rows r and r + 8 of the tile

  stage_rows<DH, THREADS>(Qs, static_cast<const bf*>(a.q) + ih, a.isn, q0,
                           ROWS, N);
  cp_async_commit();
  live_tiles(mrow, N, tiles, count, !ONLINE);
  cp_async_wait<0>();
  __syncthreads();
  const int nlive = *count;
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) load_a<LD>(qa[ks], Qs, r, ks, t);

  unsigned rowx[2], tcol[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    rowx[hh] = base ^ ((unsigned)(q0 + r + 8 * hh) * kRowMul);
    tcol[hh] = (unsigned)(2 * t + hh) * kColMul;
  }

  // the i-th live tile (and its V rows) into buffer i & 1
  auto load_tile = [&](int i, bool with_v) {
    const int k0 = tiles[i] * kT, buf = i & 1;
    stage_rows<DH, THREADS>(Ks + buf * TILE, kh, a.isn, k0, kT, N);
    if (with_v)
      stage_rows<DH, THREADS>(Vs + buf * TILE, vh, a.isn, k0, kT, N);
    if (tid < kT / 16)
      cp_async16(Ms + buf * kT + 16 * tid, mrow + k0 + 16 * tid);
    cp_async_commit();
  };
  // wait for tile i, with tile i + 1 in flight
  auto next_tile = [&](int i, bool with_v) {
    if (i + 1 < nlive) {
      load_tile(i + 1, with_v);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
  };
  // S of the tile in buffer buf, scaled, -inf at padded keys
  auto scores = [&](int buf, float (&s)[8][4]) {
    const bf* Kt = Ks + buf * TILE;
    const unsigned char* Mt = Ms + buf * kT;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        mma_rows(s[ni], qa[ks], Kt + (ni * 8 + g) * LD, ks, t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[ni][e] = Mt[ni * 8 + 2 * t + (e & 1)] != 0 ? -INFINITY
                                                      : s[ni][e] * a.scale;
    }
  };
  // the weights in s, dropped and scaled, into the bf16 A-fragments of P.V
  auto accumulate = [&](int i, const float (&w)[8][4], float (&o)[ND][4]) {
    const bf* Vt = Vs + (i & 1) * TILE;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t pa[4];
      pack_a<8>(pa, w, kc);
      mma_cols<DH>(o, pa, Vt + kc * 16 * LD, lane);
    }
  };
  // keep bit of element (ni, e) of the tile whose column term is cbase
  auto keep = [&](unsigned cbase, int ni, int e) {
    const unsigned col = cbase + (unsigned)(ni * 8) * kColMul + tcol[e & 1];
    return keep_mix(rowx[e >> 1] ^ col, a.thr);
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  if constexpr (ONLINE) {
    // one pass: the denominator sums the raw e, the dropped unnormalised e
    // is rounded and accumulated, with the _DEAD guards
    if (nlive > 0) load_tile(0, true);
    for (int i = 0; i < nlive; ++i) {
      next_tile(i, true);
      float s[8][4];
      scores(i & 1, s);
      const unsigned cbase = (unsigned)(tiles[i] * kT) * kColMul;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
          mx = fmaxf(mx, fmaxf(s[ni][2 * hh], s[ni][2 * hh + 1]));
        const float m_new = fmaxf(m[hh], vs::group_max<4>(mx));
        const bool dead = m_new < attn::kDead;
        const float m_safe = dead ? 0.f : m_new;
        const float ml = m_safe * kLog2e;
        const float corr =
            m[hh] < attn::kDead ? 0.f : ex2((m[hh] - m_safe) * kLog2e);
        float rs = 0.f;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 2 * hh + c;
            float ev = dead ? 0.f : ex2(fmaf(s[ni][e], kLog2e, -ml));
            rs += ev;
            if (drop) ev = keep(cbase, ni, e) ? ev * a.kscale : 0.f;
            s[ni][e] = ev;
          }
        l[hh] = l[hh] * corr + vs::group_sum<4>(rs);
        m[hh] = m_new;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          acc[nd][2 * hh] *= corr;
          acc[nd][2 * hh + 1] *= corr;
        }
      }
      accumulate(i, s, acc);
      __syncthreads();  // buffer i & 1 is free for tile i + 2
    }
  } else {
    // pass 1: the row max and the sum of exp(s - max), online over the tiles
    load_tile(0, false);
    for (int i = 0; i < nlive; ++i) {
      next_tile(i, false);
      float s[8][4];
      scores(i & 1, s);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
          mx = fmaxf(mx, fmaxf(s[ni][2 * hh], s[ni][2 * hh + 1]));
        const float m_new = fmaxf(m[hh], vs::group_max<4>(mx));
        const bool none = m_new == -INFINITY;  // no unpadded key yet
        const float ml = m_new * kLog2e;
        float rs = 0.f;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            rs += none ? 0.f : ex2(fmaf(s[ni][2 * hh + c], kLog2e, -ml));
        const float corr =
            m[hh] == -INFINITY ? 0.f : ex2((m[hh] - m_new) * kLog2e);
        l[hh] = l[hh] * corr + vs::group_sum<4>(rs);
        m[hh] = m_new;
      }
      __syncthreads();  // buffer i & 1 is free for tile i + 2
    }

    // pass 2: p = e / l, dropped, rounded to bf16, then P.V
    float ml[2], inv_l[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      ml[hh] = m[hh] * kLog2e;
      inv_l[hh] = 1.f / l[hh];
    }
    load_tile(0, true);
    for (int i = 0; i < nlive; ++i) {
      next_tile(i, true);
      float s[8][4];
      scores(i & 1, s);
      const unsigned cbase = (unsigned)(tiles[i] * kT) * kColMul;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          float p = ex2(fmaf(s[ni][e], kLog2e, -ml[hh])) * inv_l[hh];
          if (drop) p = keep(cbase, ni, e) ? p * a.kscale : 0.f;
          s[ni][e] = p;
        }
      accumulate(i, s, acc);
      __syncthreads();
    }
  }

  const long long oh = b * a.osb + h * a.osh;
  const long long sh = ((long long)b * a.H + h) * N;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int n = q0 + r + 8 * hh;
    if (n >= N) continue;
    float f = 1.f, ls = m[hh] + logf(l[hh]);
    if (ONLINE) {  // a row with no unpadded key: o = 0, lse = -inf
      const bool empty = l[hh] == 0.f;
      f = empty ? 0.f : 1.f / l[hh];
      ls = empty ? -INFINITY : ls;
    }
    bf* orow = static_cast<bf*>(a.out) + oh + (long long)n * a.osn;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(orow + nd * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[nd][2 * hh] * f,
                                acc[nd][2 * hh + 1] * f);
    if (t == 0 && a.lse != nullptr) a.lse[sh + n] = ls;
  }
}

// ----------------------------------------------------------- backward: dQ
template <int DH, int W>
constexpr int dq_smem_fixed() {
  // Q, dO, K x2, V x2, masks x2
  return (32 * W + 4 * kT) * (DH + kLdsPad) * 2 + 2 * kT;
}

// FOLDED: the folded route's backward (_bwd_kernel_folded: D = rowsum(dO *
// o), p = 0 on rows whose lse is below _DEAD); else the single-pass one
template <int DH, int W, bool FOLDED>
__global__ void __launch_bounds__(32 * W, DH > 64 ? 1 : 16 / W)
    dq_mma_kernel(const Args a) {
  constexpr int LD = DH + kLdsPad, KS = DH / 16, ND = DH / 8;
  constexpr int TILE = kT * LD, THREADS = 32 * W, ROWS = 16 * W;
  extern __shared__ __align__(16) unsigned char smem[];
  bf* Qs = reinterpret_cast<bf*>(smem);  // [ROWS][LD]
  bf* dOs = Qs + ROWS * LD;
  bf* Ks = dOs + ROWS * LD;  // [2][kT][LD]
  bf* Vs = Ks + 2 * TILE;  // [2][kT][LD]
  unsigned char* Ms = reinterpret_cast<unsigned char*>(Vs + 2 * TILE);
  int* tiles = reinterpret_cast<int*>(Ms + 2 * kT);
  const int N = a.N, ntiles = N / kT;
  int* count = tiles + ntiles;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const long long ih = b * a.isb + h * a.ish;
  const long long oh = b * a.osb + h * a.osh;
  const long long sh = ((long long)b * a.H + h) * N;
  const bf* kh = static_cast<const bf*>(a.k) + ih;
  const bf* vh = static_cast<const bf*>(a.v) + ih;
  const unsigned char* mrow = a.mask + (long long)b * N;
  const unsigned base = attn::hash_base(a.hash, a.seed, b, h);
  const bool drop = a.thr != 0u;
  const int r = warp * 16 + g;

  stage_rows<DH, THREADS>(Qs, static_cast<const bf*>(a.q) + ih, a.isn, q0,
                           ROWS, N);
  stage_rows<DH, THREADS>(dOs, static_cast<const bf*>(a.dO) + oh, a.osn,
                           q0, ROWS, N);
  cp_async_commit();
  live_tiles(mrow, N, tiles, count, !FOLDED);
  // lse * log2(e) of rows r and r + 8 (0 past N); folded, +inf on a row
  // whose lse is below _DEAD, so that its p = exp2(s log2(e) - inf) = 0
  float ll[2];
  unsigned rowx[2], tcol[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int n = q0 + r + 8 * hh;
    const float x = n < N ? a.lse[sh + n] : 0.f;
    ll[hh] = FOLDED && !(x >= attn::kDead) ? INFINITY : x * kLog2e;
    rowx[hh] = base ^ ((unsigned)(q0 + r + 8 * hh) * kRowMul);
    tcol[hh] = (unsigned)(2 * t + hh) * kColMul;
  }
  cp_async_wait<0>();
  __syncthreads();
  const int nlive = *count;

  auto load_tile = [&](int i) {
    const int k0 = tiles[i] * kT, buf = i & 1;
    stage_rows<DH, THREADS>(Ks + buf * TILE, kh, a.isn, k0, kT, N);
    stage_rows<DH, THREADS>(Vs + buf * TILE, vh, a.isn, k0, kT, N);
    if (tid < kT / 16)
      cp_async16(Ms + buf * kT + 16 * tid, mrow + k0 + 16 * tid);
    cp_async_commit();
  };
  auto next_tile = [&](int i) {
    if (i + 1 < nlive) {
      load_tile(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
  };
  // p = exp(s - lse) into s and the dropped dp into dp, for the tile of
  // live index i
  auto probs = [&](int i, float (&s)[8][4], float (&dp)[8][4]) {
    const int buf = i & 1;
    const bf* Kt = Ks + buf * TILE;
    const bf* Vt = Vs + buf * TILE;
    const unsigned char* Mt = Ms + buf * kT;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] = dp[ni][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4], da[4];
      load_a<LD>(qa, Qs, r, ks, t);
      load_a<LD>(da, dOs, r, ks, t);
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        mma_rows(s[ni], qa, Kt + (ni * 8 + g) * LD, ks, t);
        mma_rows(dp[ni], da, Vt + (ni * 8 + g) * LD, ks, t);
      }
    }
    const unsigned cbase = (unsigned)(tiles[i] * kT) * kColMul;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const float sv = Mt[ni * 8 + 2 * t + (e & 1)] != 0
                             ? -INFINITY
                             : s[ni][e] * a.scale;
        s[ni][e] = ex2(fmaf(sv, kLog2e, -ll[hh]));
        if (drop) {
          const unsigned col = cbase + (unsigned)(ni * 8) * kColMul +
                               tcol[e & 1];
          dp[ni][e] =
              keep_mix(rowx[hh] ^ col, a.thr) ? dp[ni][e] * a.kscale : 0.f;
        }
      }
  };

  float Dr[2];
  if constexpr (FOLDED) {
    // D = rowsum(dO * o) over the warp's own rows: dO from shared memory,
    // the forward's o from device memory, pairs at columns 8 j + 2 t
    const bf* o_h = static_cast<const bf*>(a.o) + oh;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int n = q0 + r + 8 * hh;
      float part = 0.f;
      if (n < N) {
        const bf* orow = o_h + (long long)n * a.osn;
        const bf* drow = dOs + (r + 8 * hh) * LD;
#pragma unroll
        for (int c = 2 * t; c < DH; c += 8) {
          const float2 ov = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(orow + c));
          const float2 dv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(drow + c));
          part += dv.x * ov.x + dv.y * ov.y;
        }
      }
      Dr[hh] = vs::group_sum<4>(part);
      if (t == 0 && n < N) a.D[sh + n] = Dr[hh];
    }
  } else {
    // D = rowsum(dp * p) over the full row
    float part[2] = {0.f, 0.f};
    load_tile(0);
    for (int i = 0; i < nlive; ++i) {
      next_tile(i);
      float p[8][4], dp[8][4];
      probs(i, p, dp);
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[e >> 1] += dp[ni][e] * p[ni][e];
      __syncthreads();
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      Dr[hh] = vs::group_sum<4>(part[hh]);
      if (t == 0 && q0 + r + 8 * hh < N) a.D[sh + q0 + r + 8 * hh] = Dr[hh];
    }
  }

  // dQ = bf16(p (dp - D)) . K
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  if (nlive > 0) load_tile(0);
  for (int i = 0; i < nlive; ++i) {
    next_tile(i);
    float p[8][4], dp[8][4];
    probs(i, p, dp);
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[ni][e] = p[ni][e] * (dp[ni][e] - Dr[e >> 1]);
    const bf* Kt = Ks + (i & 1) * TILE;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t sa[4];
      pack_a<8>(sa, p, kc);
      mma_cols<DH>(acc, sa, Kt + kc * 16 * LD, lane);
    }
    __syncthreads();
  }

  bf* dqh = static_cast<bf*>(a.dq) + ih;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (q0 + r + 8 * hh >= N) continue;
    bf* row = dqh + (long long)(q0 + r + 8 * hh) * a.isn;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(row + nd * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[nd][2 * hh] * a.scale,
                                acc[nd][2 * hh + 1] * a.scale);
  }
}

// -------------------------------------------------------- backward: dK, dV
// Each warp owns 16 keys of the CTA's 16 W; the transposed score tiles
// (keys x queries) are taken QC queries at a time (32 at DH 96 and 128,
// where the dK and dV accumulators take 96 and 128 registers).
template <int DH, int W>
constexpr int dkdv_smem_bytes() {
  // K, V; Q x2, dO x2; lse x2, D x2
  return (32 * W + 4 * kT) * (DH + kLdsPad) * 2 + 4 * kT * 4;
}

// FOLDED: p = 0 on query rows whose lse is below _DEAD (_bwd_kernel_folded)
template <int DH, int W, bool FOLDED>
__global__ void __launch_bounds__(32 * W, DH > 64 ? 1 : 12 / W)
    dkdv_mma_kernel(const Args a) {
  constexpr int LD = DH + kLdsPad, KS = DH / 16, ND = DH / 8;
  constexpr int TILE = kT * LD, QC = DH > 64 ? 32 : 64, NI = QC / 8;
  constexpr int THREADS = 32 * W, ROWS = 16 * W;
  extern __shared__ __align__(16) unsigned char smem[];
  bf* Ks = reinterpret_cast<bf*>(smem);  // [ROWS][LD]
  bf* Vs = Ks + ROWS * LD;
  bf* Qs = Vs + ROWS * LD;  // [2][kT][LD]
  bf* dOs = Qs + 2 * TILE;  // [2][kT][LD]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * TILE);  // [2][kT] lse
  float* Dq = Ls + 2 * kT;                               // [2][kT] D

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int N = a.N, ntiles = N / kT;
  const long long ih = b * a.isb + h * a.ish;
  const long long oh = b * a.osb + h * a.osh;
  const long long sh = ((long long)b * a.H + h) * N;
  const unsigned char* mrow = a.mask + (long long)b * N;
  const int r = warp * 16 + g;  // the warp's keys r and r + 8 of the tile
  bf* dkh = static_cast<bf*>(a.dk) + ih;
  bf* dvh = static_cast<bf*>(a.dv) + ih;

  // keys whose 16 W are all padded get exact zeros, unless no key of the
  // element is unpadded on the single-pass route (then every tile runs, as
  // in dQ; on the folded route every row of such an element is dead)
  bool mine = false, any = false;
  for (int c = tid * 16; c < N; c += THREADS * 16) {
    const bool live = any_live16(mrow + c);
    any |= live;
    mine |= live && c >= k0 && c < k0 + ROWS;
  }
  any = __syncthreads_or(any);
  mine = __syncthreads_or(mine);
  if ((any || FOLDED) && !mine) {
    const __nv_bfloat162 z = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (k0 + r + 8 * hh >= N) continue;
      const long long row = (long long)(k0 + r + 8 * hh) * a.isn;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        *reinterpret_cast<__nv_bfloat162*>(dkh + row + nd * 8 + 2 * t) = z;
        *reinterpret_cast<__nv_bfloat162*>(dvh + row + nd * 8 + 2 * t) = z;
      }
    }
    return;
  }

  stage_rows<DH, THREADS>(Ks, static_cast<const bf*>(a.k) + ih, a.isn, k0,
                           ROWS, N);
  stage_rows<DH, THREADS>(Vs, static_cast<const bf*>(a.v) + ih, a.isn, k0,
                           ROWS, N);
  const bf* qh = static_cast<const bf*>(a.q) + ih;
  const bf* dOh = static_cast<const bf*>(a.dO) + oh;
  auto load_tile = [&](int qt) {
    const int q0 = qt * kT, buf = qt & 1;
    stage_rows<DH, THREADS>(Qs + buf * TILE, qh, a.isn, q0, kT, N);
    stage_rows<DH, THREADS>(dOs + buf * TILE, dOh, a.osn, q0, kT, N);
    if (tid < kT / 4)
      cp_async16(Ls + buf * kT + 4 * tid, a.lse + sh + q0 + 4 * tid);
    else if (tid < kT / 2)
      cp_async16(Dq + buf * kT + 4 * (tid - kT / 4),
                 a.D + sh + q0 + 4 * (tid - kT / 4));
    cp_async_commit();
  };
  load_tile(0);  // one group with K and V

  const unsigned base = attn::hash_base(a.hash, a.seed, b, h);
  const bool drop = a.thr != 0u;
  bool km[2];
  unsigned keyx[2], tq[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k0 + r + 8 * hh;
    km[hh] = key >= N || mrow[key] != 0;
    keyx[hh] = base ^ ((unsigned)(k0 + r + 8 * hh) * kColMul);
    tq[hh] = (unsigned)(2 * t + hh) * kRowMul;
  }
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nd][e] = dva[nd][e] = 0.f;

  for (int qt = 0; qt < ntiles; ++qt) {
    if (qt + 1 < ntiles) {
      load_tile(qt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (FOLDED && tid < kT / 4) {
      // the lse guard, by the thread whose copy just landed: +inf on a
      // dead row, so that its p = exp2(s log2(e) - inf) = 0 below
      float* x = Ls + (qt & 1) * kT + 4 * tid;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (!(x[j] >= attn::kDead)) x[j] = INFINITY;
    }
    __syncthreads();
    const int buf = qt & 1;
    const bf* Qt = Qs + buf * TILE;
    const bf* dOt = dOs + buf * TILE;
    const float* Lt = Ls + buf * kT;
    const float* Dt = Dq + buf * kT;
    const unsigned qbase = (unsigned)(qt * kT) * kRowMul;
#pragma unroll
    for (int qc0 = 0; qc0 < kT; qc0 += QC) {
      // s^T = K . Q^T and dp^T = V . dO^T: element (ni, e) is key
      // r + 8 (e >> 1), query qc0 + ni*8 + 2t + (e & 1)
      float s[NI][4], dp[NI][4];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[ni][e] = dp[ni][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ka[4], va[4];
        load_a<LD>(ka, Ks, r, ks, t);
        load_a<LD>(va, Vs, r, ks, t);
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          mma_rows(s[ni], ka, Qt + (qc0 + ni * 8 + g) * LD, ks, t);
          mma_rows(dp[ni], va, dOt + (qc0 + ni * 8 + g) * LD, ks, t);
        }
      }
      // p into s, the dropped pd into dp's place after ds is formed
      float ds[NI][4];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1, qj = qc0 + ni * 8 + 2 * t + (e & 1);
          const float sv = km[hh] ? -INFINITY : s[ni][e] * a.scale;
          const float p = ex2(fmaf(sv, kLog2e, -Lt[qj] * kLog2e));
          bool keep = true;
          if (drop) {
            const unsigned row = qbase + (unsigned)(qc0 + ni * 8) * kRowMul +
                                 tq[e & 1];
            keep = keep_mix(keyx[hh] ^ row, a.thr);
          }
          const float gd = keep ? dp[ni][e] * a.kscale : 0.f;
          ds[ni][e] = p * (gd - Dt[qj]);
          dp[ni][e] = keep ? p * a.kscale : 0.f;  // pd
        }
#pragma unroll
      for (int kc = 0; kc < QC / 16; ++kc) {
        const bf* qrows = Qt + (qc0 + kc * 16) * LD;
        const bf* drows = dOt + (qc0 + kc * 16) * LD;
        uint32_t fa[4];
        pack_a<NI>(fa, ds, kc);
        mma_cols<DH>(dka, fa, qrows, lane);
        // pd = hi + mid + lo, each a bf16 operand
#pragma unroll
        for (int term = 0; term < 3; ++term) {
          pack_a<NI>(fa, dp, kc);
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dp[2 * kc + j][e] -=
                  __bfloat162float(__float2bfloat16(dp[2 * kc + j][e]));
          mma_cols<DH>(dva, fa, drows, lane);
        }
      }
    }
    __syncthreads();  // buffer qt & 1 is free for tile qt + 2
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (k0 + r + 8 * hh >= N) continue;
    const long long row = (long long)(k0 + r + 8 * hh) * a.isn;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(dkh + row + nd * 8 + 2 * t) =
          __floats2bfloat162_rn(dka[nd][2 * hh] * a.scale,
                                dka[nd][2 * hh + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvh + row + nd * 8 + 2 * t) =
          __floats2bfloat162_rn(dva[nd][2 * hh], dva[nd][2 * hh + 1]);
    }
  }
}

// --------------------------------------------------------- head_dim slices
// The three kernels over a head of nsl * 128 columns (attention_core.cuh's
// head_dim slices), 4 warps each, grid.y over (head, slice): every product
// that contracts over head_dim (s = Q.K^T and dp = dO.V^T, or their
// transposes) is summed over the slices, one 128-column slice of each
// operand staged at a time into the unsliced kernel's buffer 0 (cp.async,
// then a wait: nothing double-buffered), its fragments loaded per slice and
// each element's k16 steps in increasing order over the whole head, so every
// slice CTA of a row holds the same s, dp, max, sum, lse and D. The products
// that keep head_dim (P.V, dS.K, dS^T.Q, pd^T.dO) take the CTA's own slice,
// staged into buffer 1 where the kernel streams two tiles. The slice-0 CTA
// writes lse and D. The shared memory is the unsliced kernels' at 128
// (fwd_smem_fixed, dq_smem_fixed, dkdv_smem_bytes: 87,168, 104,576 and
// 105,472 bytes, plus the live-tile lists).
template <bool ONLINE>
__global__ void __launch_bounds__(128, 2) fwd_mma_sliced_kernel(const Args a) {
  constexpr int DH = attn::kSliceDh, W = 4;
  constexpr int LD = DH + kLdsPad, KS = DH / 16, ND = DH / 8;
  constexpr int TILE = kT * LD, THREADS = 32 * W, ROWS = 16 * W;
  extern __shared__ __align__(16) unsigned char smem[];
  bf* Qs = reinterpret_cast<bf*>(smem);  // [ROWS][LD], slice j
  bf* Ks = Qs + ROWS * LD;               // [kT][LD] of [2], slice j
  bf* Vs = Ks + 2 * TILE;                // [kT][LD] of [2], own slice
  unsigned char* Ms = reinterpret_cast<unsigned char*>(Vs + 2 * TILE);
  int* tiles = reinterpret_cast<int*>(Ms + 2 * kT);
  const int N = a.N, ntiles = N / kT, nsl = a.nsl;
  int* count = tiles + ntiles;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y / nsl;
  const int sl = blockIdx.y % nsl, b = blockIdx.z;
  const long long ih = b * a.isb + h * a.ish;
  const bf* qh = static_cast<const bf*>(a.q) + ih;
  const bf* kh = static_cast<const bf*>(a.k) + ih;
  const bf* vh = static_cast<const bf*>(a.v) + ih + sl * DH;
  const unsigned char* mrow = a.mask + (long long)b * N;
  const unsigned base = attn::hash_base(a.hash, a.seed, b, h);
  const bool drop = a.thr != 0u;
  const int r = warp * 16 + g;

  live_tiles(mrow, N, tiles, count, !ONLINE);
  __syncthreads();  // the tile list
  const int nlive = *count;

  unsigned rowx[2], tcol[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    rowx[hh] = base ^ ((unsigned)(q0 + r + 8 * hh) * kRowMul);
    tcol[hh] = (unsigned)(2 * t + hh) * kColMul;
  }

  // S of live tile i summed over the slices, scaled, -inf at padded keys;
  // with_v also stages the tile's rows of the own slice of V
  auto scores = [&](int i, bool with_v, float (&s)[8][4]) {
    const int k0 = tiles[i] * kT;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] = 0.f;
    for (int j = 0; j < nsl; ++j) {
      __syncthreads();  // the last readers of every tile are done
      stage_rows<DH, THREADS>(Qs, qh + j * DH, a.isn, q0, ROWS, N);
      stage_rows<DH, THREADS>(Ks, kh + j * DH, a.isn, k0, kT, N);
      if (j == 0 && tid < kT / 16)
        cp_async16(Ms + 16 * tid, mrow + k0 + 16 * tid);
      if (with_v && j == nsl - 1)
        stage_rows<DH, THREADS>(Vs, vh, a.isn, k0, kT, N);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t qa[4];
        load_a<LD>(qa, Qs, r, ks, t);
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
          mma_rows(s[ni], qa, Ks + (ni * 8 + g) * LD, ks, t);
      }
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[ni][e] = Ms[ni * 8 + 2 * t + (e & 1)] != 0 ? -INFINITY
                                                      : s[ni][e] * a.scale;
  };
  auto accumulate = [&](const float (&w)[8][4], float (&o)[ND][4]) {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t pa[4];
      pack_a<8>(pa, w, kc);
      mma_cols<DH>(o, pa, Vs + kc * 16 * LD, lane);
    }
  };
  auto keep = [&](unsigned cbase, int ni, int e) {
    const unsigned col = cbase + (unsigned)(ni * 8) * kColMul + tcol[e & 1];
    return keep_mix(rowx[e >> 1] ^ col, a.thr);
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  if constexpr (ONLINE) {
    for (int i = 0; i < nlive; ++i) {
      float s[8][4];
      scores(i, true, s);
      const unsigned cbase = (unsigned)(tiles[i] * kT) * kColMul;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
          mx = fmaxf(mx, fmaxf(s[ni][2 * hh], s[ni][2 * hh + 1]));
        const float m_new = fmaxf(m[hh], vs::group_max<4>(mx));
        const bool dead = m_new < attn::kDead;
        const float m_safe = dead ? 0.f : m_new;
        const float ml = m_safe * kLog2e;
        const float corr =
            m[hh] < attn::kDead ? 0.f : ex2((m[hh] - m_safe) * kLog2e);
        float rs = 0.f;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 2 * hh + c;
            float ev = dead ? 0.f : ex2(fmaf(s[ni][e], kLog2e, -ml));
            rs += ev;
            if (drop) ev = keep(cbase, ni, e) ? ev * a.kscale : 0.f;
            s[ni][e] = ev;
          }
        l[hh] = l[hh] * corr + vs::group_sum<4>(rs);
        m[hh] = m_new;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          acc[nd][2 * hh] *= corr;
          acc[nd][2 * hh + 1] *= corr;
        }
      }
      accumulate(s, acc);
    }
  } else {
    for (int i = 0; i < nlive; ++i) {
      float s[8][4];
      scores(i, false, s);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
          mx = fmaxf(mx, fmaxf(s[ni][2 * hh], s[ni][2 * hh + 1]));
        const float m_new = fmaxf(m[hh], vs::group_max<4>(mx));
        const bool none = m_new == -INFINITY;
        const float ml = m_new * kLog2e;
        float rs = 0.f;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            rs += none ? 0.f : ex2(fmaf(s[ni][2 * hh + c], kLog2e, -ml));
        const float corr =
            m[hh] == -INFINITY ? 0.f : ex2((m[hh] - m_new) * kLog2e);
        l[hh] = l[hh] * corr + vs::group_sum<4>(rs);
        m[hh] = m_new;
      }
    }
    float ml[2], inv_l[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      ml[hh] = m[hh] * kLog2e;
      inv_l[hh] = 1.f / l[hh];
    }
    for (int i = 0; i < nlive; ++i) {
      float s[8][4];
      scores(i, true, s);
      const unsigned cbase = (unsigned)(tiles[i] * kT) * kColMul;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          float p = ex2(fmaf(s[ni][e], kLog2e, -ml[hh])) * inv_l[hh];
          if (drop) p = keep(cbase, ni, e) ? p * a.kscale : 0.f;
          s[ni][e] = p;
        }
      accumulate(s, acc);
    }
  }

  const long long oh = b * a.osb + h * a.osh + sl * DH;
  const long long sh = ((long long)b * a.H + h) * N;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int n = q0 + r + 8 * hh;
    if (n >= N) continue;
    float f = 1.f, ls = m[hh] + logf(l[hh]);
    if (ONLINE) {  // a row with no unpadded key: o = 0, lse = -inf
      const bool empty = l[hh] == 0.f;
      f = empty ? 0.f : 1.f / l[hh];
      ls = empty ? -INFINITY : ls;
    }
    bf* orow = static_cast<bf*>(a.out) + oh + (long long)n * a.osn;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(orow + nd * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[nd][2 * hh] * f,
                                acc[nd][2 * hh + 1] * f);
    if (sl == 0 && t == 0 && a.lse != nullptr) a.lse[sh + n] = ls;
  }
}

template <bool FOLDED>
__global__ void __launch_bounds__(128, 1) dq_mma_sliced_kernel(const Args a) {
  constexpr int DH = attn::kSliceDh, W = 4;
  constexpr int LD = DH + kLdsPad, KS = DH / 16, ND = DH / 8;
  constexpr int TILE = kT * LD, THREADS = 32 * W, ROWS = 16 * W;
  extern __shared__ __align__(16) unsigned char smem[];
  bf* Qs = reinterpret_cast<bf*>(smem);  // [ROWS][LD], slice j
  bf* dOs = Qs + ROWS * LD;              // [ROWS][LD], slice j
  bf* Ks = dOs + ROWS * LD;              // [2][kT][LD]: slice j, own slice
  bf* Vs = Ks + 2 * TILE;                // [kT][LD] of [2], slice j
  unsigned char* Ms = reinterpret_cast<unsigned char*>(Vs + 2 * TILE);
  int* tiles = reinterpret_cast<int*>(Ms + 2 * kT);
  const int N = a.N, ntiles = N / kT, nsl = a.nsl;
  int* count = tiles + ntiles;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y / nsl;
  const int sl = blockIdx.y % nsl, b = blockIdx.z;
  const long long ih = b * a.isb + h * a.ish;
  const long long oh = b * a.osb + h * a.osh;
  const long long sh = ((long long)b * a.H + h) * N;
  const bf* qh = static_cast<const bf*>(a.q) + ih;
  const bf* kh = static_cast<const bf*>(a.k) + ih;
  const bf* vh = static_cast<const bf*>(a.v) + ih;
  const bf* dOh = static_cast<const bf*>(a.dO) + oh;
  const unsigned char* mrow = a.mask + (long long)b * N;
  const unsigned base = attn::hash_base(a.hash, a.seed, b, h);
  const bool drop = a.thr != 0u;
  const int r = warp * 16 + g;

  live_tiles(mrow, N, tiles, count, !FOLDED);
  float ll[2];
  unsigned rowx[2], tcol[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int n = q0 + r + 8 * hh;
    const float x = n < N ? a.lse[sh + n] : 0.f;
    ll[hh] = FOLDED && !(x >= attn::kDead) ? INFINITY : x * kLog2e;
    rowx[hh] = base ^ ((unsigned)(q0 + r + 8 * hh) * kRowMul);
    tcol[hh] = (unsigned)(2 * t + hh) * kColMul;
  }
  __syncthreads();  // the tile list
  const int nlive = *count;

  // p = exp(s - lse) into s and the dropped dp into dp for live tile i, s
  // and dp summed over the slices; own_k also stages the tile's rows of the
  // own slice of K into buffer 1
  auto probs = [&](int i, bool own_k, float (&s)[8][4], float (&dp)[8][4]) {
    const int k0 = tiles[i] * kT;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] = dp[ni][e] = 0.f;
    for (int j = 0; j < nsl; ++j) {
      __syncthreads();  // the last readers of every tile are done
      stage_rows<DH, THREADS>(Qs, qh + j * DH, a.isn, q0, ROWS, N);
      stage_rows<DH, THREADS>(dOs, dOh + j * DH, a.osn, q0, ROWS, N);
      stage_rows<DH, THREADS>(Ks, kh + j * DH, a.isn, k0, kT, N);
      stage_rows<DH, THREADS>(Vs, vh + j * DH, a.isn, k0, kT, N);
      if (j == 0 && tid < kT / 16)
        cp_async16(Ms + 16 * tid, mrow + k0 + 16 * tid);
      if (own_k && j == nsl - 1)
        stage_rows<DH, THREADS>(Ks + TILE, kh + sl * DH, a.isn, k0, kT, N);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t qa[4], da[4];
        load_a<LD>(qa, Qs, r, ks, t);
        load_a<LD>(da, dOs, r, ks, t);
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          mma_rows(s[ni], qa, Ks + (ni * 8 + g) * LD, ks, t);
          mma_rows(dp[ni], da, Vs + (ni * 8 + g) * LD, ks, t);
        }
      }
    }
    const unsigned cbase = (unsigned)(k0)*kColMul;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const float sv = Ms[ni * 8 + 2 * t + (e & 1)] != 0
                             ? -INFINITY
                             : s[ni][e] * a.scale;
        s[ni][e] = ex2(fmaf(sv, kLog2e, -ll[hh]));
        if (drop) {
          const unsigned col = cbase + (unsigned)(ni * 8) * kColMul +
                               tcol[e & 1];
          dp[ni][e] =
              keep_mix(rowx[hh] ^ col, a.thr) ? dp[ni][e] * a.kscale : 0.f;
        }
      }
  };

  float Dr[2];
  if constexpr (FOLDED) {
    // D = rowsum(dO * o) over the whole head, both from device memory,
    // pairs at columns 8 j + 2 t
    const bf* o_h = static_cast<const bf*>(a.o) + oh;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int n = q0 + r + 8 * hh;
      float part = 0.f;
      if (n < N) {
        const bf* orow = o_h + (long long)n * a.osn;
        const bf* drow = dOh + (long long)n * a.osn;
        for (int c = 2 * t; c < nsl * DH; c += 8) {
          const float2 ov = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(orow + c));
          const float2 dv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(drow + c));
          part += dv.x * ov.x + dv.y * ov.y;
        }
      }
      Dr[hh] = vs::group_sum<4>(part);
      if (sl == 0 && t == 0 && n < N) a.D[sh + n] = Dr[hh];
    }
  } else {
    float part[2] = {0.f, 0.f};
    for (int i = 0; i < nlive; ++i) {
      float p[8][4], dp[8][4];
      probs(i, false, p, dp);
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[e >> 1] += dp[ni][e] * p[ni][e];
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      Dr[hh] = vs::group_sum<4>(part[hh]);
      if (sl == 0 && t == 0 && q0 + r + 8 * hh < N)
        a.D[sh + q0 + r + 8 * hh] = Dr[hh];
    }
  }

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  for (int i = 0; i < nlive; ++i) {
    float p[8][4], dp[8][4];
    probs(i, true, p, dp);
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[ni][e] = p[ni][e] * (dp[ni][e] - Dr[e >> 1]);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t sa[4];
      pack_a<8>(sa, p, kc);
      mma_cols<DH>(acc, sa, Ks + TILE + kc * 16 * LD, lane);
    }
  }

  bf* dqh = static_cast<bf*>(a.dq) + ih + sl * DH;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (q0 + r + 8 * hh >= N) continue;
    bf* row = dqh + (long long)(q0 + r + 8 * hh) * a.isn;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(row + nd * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[nd][2 * hh] * a.scale,
                                acc[nd][2 * hh + 1] * a.scale);
  }
}

template <bool FOLDED>
__global__ void __launch_bounds__(128, 1)
    dkdv_mma_sliced_kernel(const Args a) {
  constexpr int DH = attn::kSliceDh, W = 4;
  constexpr int LD = DH + kLdsPad, KS = DH / 16, ND = DH / 8;
  constexpr int TILE = kT * LD, QC = 32, NI = QC / 8;
  constexpr int THREADS = 32 * W, ROWS = 16 * W;
  extern __shared__ __align__(16) unsigned char smem[];
  bf* Ks = reinterpret_cast<bf*>(smem);  // [ROWS][LD], slice j
  bf* Vs = Ks + ROWS * LD;               // [ROWS][LD], slice j
  bf* Qs = Vs + ROWS * LD;               // [2][kT][LD]: slice j, own slice
  bf* dOs = Qs + 2 * TILE;               // [2][kT][LD]: slice j, own slice
  float* Ls = reinterpret_cast<float*>(dOs + 2 * TILE);  // [kT] lse
  float* Dq = Ls + 2 * kT;                               // [kT] D

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nsl = a.nsl, k0 = blockIdx.x * ROWS, h = blockIdx.y / nsl;
  const int sl = blockIdx.y % nsl, b = blockIdx.z;
  const int N = a.N, ntiles = N / kT;
  const long long ih = b * a.isb + h * a.ish;
  const long long oh = b * a.osb + h * a.osh;
  const long long sh = ((long long)b * a.H + h) * N;
  const unsigned char* mrow = a.mask + (long long)b * N;
  const int r = warp * 16 + g;
  bf* dkh = static_cast<bf*>(a.dk) + ih + sl * DH;
  bf* dvh = static_cast<bf*>(a.dv) + ih + sl * DH;

  bool mine = false, any = false;
  for (int c = tid * 16; c < N; c += THREADS * 16) {
    const bool live = any_live16(mrow + c);
    any |= live;
    mine |= live && c >= k0 && c < k0 + ROWS;
  }
  any = __syncthreads_or(any);
  mine = __syncthreads_or(mine);
  if ((any || FOLDED) && !mine) {
    const __nv_bfloat162 z = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (k0 + r + 8 * hh >= N) continue;
      const long long row = (long long)(k0 + r + 8 * hh) * a.isn;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        *reinterpret_cast<__nv_bfloat162*>(dkh + row + nd * 8 + 2 * t) = z;
        *reinterpret_cast<__nv_bfloat162*>(dvh + row + nd * 8 + 2 * t) = z;
      }
    }
    return;
  }

  const bf* kh = static_cast<const bf*>(a.k) + ih;
  const bf* vh = static_cast<const bf*>(a.v) + ih;
  const bf* qh = static_cast<const bf*>(a.q) + ih;
  const bf* dOh = static_cast<const bf*>(a.dO) + oh;
  const unsigned base = attn::hash_base(a.hash, a.seed, b, h);
  const bool drop = a.thr != 0u;
  bool km[2];
  unsigned keyx[2], tq[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k0 + r + 8 * hh;
    km[hh] = key >= N || mrow[key] != 0;
    keyx[hh] = base ^ ((unsigned)(k0 + r + 8 * hh) * kColMul);
    tq[hh] = (unsigned)(2 * t + hh) * kRowMul;
  }
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nd][e] = dva[nd][e] = 0.f;

  for (int qt = 0; qt < ntiles; ++qt) {
    const int q0 = qt * kT;
    const unsigned qbase = (unsigned)(qt * kT) * kRowMul;
#pragma unroll 1
    for (int qc0 = 0; qc0 < kT; qc0 += QC) {
      // s^T = K . Q^T and dp^T = V . dO^T over the slices: element (ni, e)
      // is key r + 8 (e >> 1), query qc0 + ni*8 + 2t + (e & 1)
      float s[NI][4], dp[NI][4];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[ni][e] = dp[ni][e] = 0.f;
      for (int j = 0; j < nsl; ++j) {
        __syncthreads();  // the last readers of every tile are done
        stage_rows<DH, THREADS>(Ks, kh + j * DH, a.isn, k0, ROWS, N);
        stage_rows<DH, THREADS>(Vs, vh + j * DH, a.isn, k0, ROWS, N);
        stage_rows<DH, THREADS>(Qs, qh + j * DH, a.isn, q0, kT, N);
        stage_rows<DH, THREADS>(dOs, dOh + j * DH, a.osn, q0, kT, N);
        if (qc0 == 0 && j == 0) {
          if (tid < kT / 4)
            cp_async16(Ls + 4 * tid, a.lse + sh + q0 + 4 * tid);
          else if (tid < kT / 2)
            cp_async16(Dq + 4 * (tid - kT / 4),
                       a.D + sh + q0 + 4 * (tid - kT / 4));
        }
        if (qc0 == 0 && j == nsl - 1) {
          stage_rows<DH, THREADS>(Qs + TILE, qh + sl * DH, a.isn, q0, kT, N);
          stage_rows<DH, THREADS>(dOs + TILE, dOh + sl * DH, a.osn, q0, kT,
                                  N);
        }
        cp_async_commit();
        cp_async_wait<0>();
        if (FOLDED && qc0 == 0 && j == 0 && tid < kT / 4) {
          // the lse guard, by the thread whose copy just landed
          float* x = Ls + 4 * tid;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!(x[e] >= attn::kDead)) x[e] = INFINITY;
        }
        __syncthreads();
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t ka[4], va[4];
          load_a<LD>(ka, Ks, r, ks, t);
          load_a<LD>(va, Vs, r, ks, t);
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) {
            mma_rows(s[ni], ka, Qs + (qc0 + ni * 8 + g) * LD, ks, t);
            mma_rows(dp[ni], va, dOs + (qc0 + ni * 8 + g) * LD, ks, t);
          }
        }
      }
      float ds[NI][4];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1, qj = qc0 + ni * 8 + 2 * t + (e & 1);
          const float sv = km[hh] ? -INFINITY : s[ni][e] * a.scale;
          const float p = ex2(fmaf(sv, kLog2e, -Ls[qj] * kLog2e));
          bool keep = true;
          if (drop) {
            const unsigned row = qbase + (unsigned)(qc0 + ni * 8) * kRowMul +
                                 tq[e & 1];
            keep = keep_mix(keyx[hh] ^ row, a.thr);
          }
          const float gd = keep ? dp[ni][e] * a.kscale : 0.f;
          ds[ni][e] = p * (gd - Dq[qj]);
          dp[ni][e] = keep ? p * a.kscale : 0.f;  // pd
        }
#pragma unroll
      for (int kc = 0; kc < QC / 16; ++kc) {
        const bf* qrows = Qs + TILE + (qc0 + kc * 16) * LD;
        const bf* drows = dOs + TILE + (qc0 + kc * 16) * LD;
        uint32_t fa[4];
        pack_a<NI>(fa, ds, kc);
        mma_cols<DH>(dka, fa, qrows, lane);
#pragma unroll
        for (int term = 0; term < 3; ++term) {
          pack_a<NI>(fa, dp, kc);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dp[2 * kc + jj][e] -=
                  __bfloat162float(__float2bfloat16(dp[2 * kc + jj][e]));
          mma_cols<DH>(dva, fa, drows, lane);
        }
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (k0 + r + 8 * hh >= N) continue;
    const long long row = (long long)(k0 + r + 8 * hh) * a.isn;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(dkh + row + nd * 8 + 2 * t) =
          __floats2bfloat162_rn(dka[nd][2 * hh] * a.scale,
                                dka[nd][2 * hh + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvh + row + nd * 8 + 2 * t) =
          __floats2bfloat162_rn(dva[nd][2 * hh], dva[nd][2 * hh + 1]);
    }
  }
}

// ------------------------------------------------------------------ launches
// The mma route reads 16-byte chunks of q, k, v, dO, the mask, lse and D
// (and, folded, o by pairs: the wrapper gives it aligned too)
inline bool layout_ok(const Args& a) {
  return a.isn % 8 == 0 && a.isb % 8 == 0 && a.ish % 8 == 0 &&
         a.osn % 8 == 0 && a.osb % 8 == 0 && a.osh % 8 == 0 &&
         aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
         aligned16(a.mask);
}

// CTAs along N for W warps (16 W rows each; the last may be ragged)
inline unsigned ctas(int N, int W) { return (N + 16 * W - 1) / (16 * W); }

template <int DH, bool ONLINE>
cudaError_t launch_fwd(const Args& a, int B, cudaStream_t s) {
  constexpr int W = kFwdWarps<DH>;
  if (!layout_ok(a)) return cudaErrorMisalignedAddress;
  const int bytes = fwd_smem_fixed<DH, W>() + (a.N / kT + 1) * 4;
  cudaError_t err = attn::allow_smem(fwd_mma_kernel<DH, W, ONLINE>, bytes);
  if (err != cudaSuccess) return err;
  fwd_mma_kernel<DH, W, ONLINE>
      <<<dim3(ctas(a.N, W), a.H, B), 32 * W, bytes, s>>>(a);
  return cudaGetLastError();
}

// dq_mma_kernel writes D, which dkdv_mma_kernel reads after it on the same
// stream
template <int DH, bool FOLDED>
cudaError_t launch_bwd(const Args& a, int B, cudaStream_t s) {
  if (!layout_ok(a) || !aligned16(a.dO) || !aligned16(a.lse) ||
      !aligned16(a.D) || (FOLDED && !aligned16(a.o)))
    return cudaErrorMisalignedAddress;
  constexpr int WQ = kDqWarps<DH>, WK = kDkdvWarps;
  const int dq_bytes = dq_smem_fixed<DH, WQ>() + (a.N / kT + 1) * 4;
  const int kv_bytes = dkdv_smem_bytes<DH, WK>();
  cudaError_t err =
      attn::allow_smem(dq_mma_kernel<DH, WQ, FOLDED>, dq_bytes);
  if (err == cudaSuccess)
    err = attn::allow_smem(dkdv_mma_kernel<DH, WK, FOLDED>, kv_bytes);
  if (err != cudaSuccess) return err;
  dq_mma_kernel<DH, WQ, FOLDED>
      <<<dim3(ctas(a.N, WQ), a.H, B), 32 * WQ, dq_bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_mma_kernel<DH, WK, FOLDED>
      <<<dim3(ctas(a.N, WK), a.H, B), 32 * WK, kv_bytes, s>>>(a);
  return cudaGetLastError();
}

template <bool ONLINE>
cudaError_t launch_mma_fwd_sliced(const Args& a, int B, cudaStream_t s) {
  constexpr int DH = attn::kSliceDh, W = 4;
  if (!layout_ok(a)) return cudaErrorMisalignedAddress;
  if (!attn::sliced_grid_ok(a)) return cudaErrorInvalidValue;
  const int bytes = fwd_smem_fixed<DH, W>() + (a.N / kT + 1) * 4;
  cudaError_t err = attn::allow_smem(fwd_mma_sliced_kernel<ONLINE>, bytes);
  if (err != cudaSuccess) return err;
  fwd_mma_sliced_kernel<ONLINE>
      <<<dim3(ctas(a.N, W), a.H * a.nsl, B), 32 * W, bytes, s>>>(a);
  return cudaGetLastError();
}

template <bool FOLDED>
cudaError_t launch_mma_bwd_sliced(const Args& a, int B, cudaStream_t s) {
  constexpr int DH = attn::kSliceDh, W = 4;
  if (!layout_ok(a) || !aligned16(a.dO) || !aligned16(a.lse) ||
      !aligned16(a.D) || (FOLDED && !aligned16(a.o)))
    return cudaErrorMisalignedAddress;
  if (!attn::sliced_grid_ok(a)) return cudaErrorInvalidValue;
  const int dq_bytes = dq_smem_fixed<DH, W>() + (a.N / kT + 1) * 4;
  const int kv_bytes = dkdv_smem_bytes<DH, W>();
  cudaError_t err = attn::allow_smem(dq_mma_sliced_kernel<FOLDED>, dq_bytes);
  if (err == cudaSuccess)
    err = attn::allow_smem(dkdv_mma_sliced_kernel<FOLDED>, kv_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(ctas(a.N, W), a.H * a.nsl, B);
  dq_mma_sliced_kernel<FOLDED><<<grid, 32 * W, dq_bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_mma_sliced_kernel<FOLDED><<<grid, 32 * W, kv_bytes, s>>>(a);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_fwd_route(const Args& a, int B, cudaStream_t s) {
  return a.online ? launch_fwd<DH, true>(a, B, s)
                  : launch_fwd<DH, false>(a, B, s);
}

// the folded backward takes both D = rowsum(dO * o) and the lse guard
template <int DH>
cudaError_t launch_bwd_route(const Args& a, int B, cudaStream_t s) {
  if (a.d_from_o != a.guard) return cudaErrorInvalidValue;
  return a.d_from_o ? launch_bwd<DH, true>(a, B, s)
                    : launch_bwd<DH, false>(a, B, s);
}

// Dispatch on head_dim (attn::shape_ok's) and, through a.online and
// a.d_from_o, on the route
inline cudaError_t launch_fwd_dh(const Args& a, int B, int Dh,
                                 cudaStream_t s) {
  switch (Dh) {
    case 16: return launch_fwd_route<16>(a, B, s);
    case 32: return launch_fwd_route<32>(a, B, s);
    case 64: return launch_fwd_route<64>(a, B, s);
    case 96: return launch_fwd_route<96>(a, B, s);
    case 128: return launch_fwd_route<128>(a, B, s);
    default: {
      Args b = a;
      b.nsl = attn::head_slices(Dh);
      return b.online ? launch_mma_fwd_sliced<true>(b, B, s)
                      : launch_mma_fwd_sliced<false>(b, B, s);
    }
  }
}

inline cudaError_t launch_bwd_dh(const Args& a, int B, int Dh,
                                 cudaStream_t s) {
  switch (Dh) {
    case 16: return launch_bwd_route<16>(a, B, s);
    case 32: return launch_bwd_route<32>(a, B, s);
    case 64: return launch_bwd_route<64>(a, B, s);
    case 96: return launch_bwd_route<96>(a, B, s);
    case 128: return launch_bwd_route<128>(a, B, s);
    default: {
      if (a.d_from_o != a.guard) return cudaErrorInvalidValue;
      Args b = a;
      b.nsl = attn::head_slices(Dh);
      return b.d_from_o ? launch_mma_bwd_sliced<true>(b, B, s)
                        : launch_mma_bwd_sliced<false>(b, B, s);
    }
  }
}

}  // namespace attn_mma
}  // namespace vs
