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
// two orders agree up to summation order, so f32 always folds online, on
// attention_core.cuh's FMA forward (launch_fma: the f32 training
// attention's kernel, fma_fwd_kernel, with no dropout and no lse). The fold
// keeps the folded kernel's _DEAD guards: a row that has
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
// (mma.sync m16n8k16, f32 accumulate) with S, P and O in registers, K/V
// double-buffered by cp.async, only the key tiles that hold an unpadded key
// walked, 128-query CTAs where the grid fills the card and exp on the MUFU
// unit (the normalise-first order computes Q.K^T twice: 1.5x the bound's
// work); f32 stays exact (no TF32) on the FMA units (67 TFLOP/s: 0.13 ms at
// B=32, N=512, 3.1 ms at N=16,384 with a ragged mask): fma_fwd_kernel's
// 8 x 8 score and output blocks a thread (4 x 8 at head_dim 96 and 128)
// read as float4 from row-major tiles that 16-byte cp.async streams in,
// over the live key tiles only, in one online pass.
//
// The int8 block (vidsum_tpu/ops/block_kernel_int8.py::_block_kernel_int8,
// ::_block_kernel_int8_grouped) runs this attention with two differences
// (block_kernel_int8.py:93-123): its output attn stays f32, to be quantised
// straight from f32 for the projection, so the normalise-first bf16 kernel
// also writes f32 (OutT); and with qk_int8 the scores are
// i8dot(q8, k8) * (qs * ks) * scale from int8 Q and K with per-row f32
// scales (QK8): the bf16 kernel takes them on the int8 tensor cores
// (mma.sync m16n8k32; head_dim 16 is zero-padded to one k32 step, 96 takes
// three), the f32 route on masked_attention_q8_kernel, the first FMA
// kernel of this file kept for QK8 alone (4 x 4 score blocks over
// transposed tiles, K/V loads not overlapped), where the dot of int8 values
// is an exact integer (Dh * 127^2 < 2^24). V, P and P.V are as above.
#include "attention_core.cuh"
#include "mma_tiles.cuh"

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
         + kBKey;       // the keys' int8 scales
}

// The f32 int8 block's attention with qk_int8 (QK8): Q and K int8 codes with
// per-row scales qsc / ksc (element strides c_b, c_h, c_n), V and o f32.
// Each thread holds a 4 x 4 score block and a 4 x (DH / 16) output block
// over transposed, padded shared tiles; the dot of int8 values is an exact
// integer in f32 (DH * 127^2 < 2^24), then (dot * (qs * ks)) * scale as
// the TPU kernel rounds it; the online softmax with the _DEAD guards.
template <int DH>
__global__ void __launch_bounds__(kThreads)
masked_attention_q8_kernel(const int8_t* __restrict__ q8,
                           const int8_t* __restrict__ k8,
                           const float* __restrict__ v,
                           const unsigned char* __restrict__ mask,
                           const float* __restrict__ qsc,
                           const float* __restrict__ ksc,
                           float* __restrict__ o, int N, long long s_b,
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
    Qt[c * kPad + r] = n < N ? (float)q8[base + n * s_n + c] : 0.f;
  }
  float qs[4] = {1.f, 1.f, 1.f, 1.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + rg * 4 + i;
    if (n < N) qs[i] = qsc[cbase + n * c_n];
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
      Kt[c * kPad + r] = ok ? (float)k8[base + n * s_n + c] : 0.f;
      Vs[r * DH + c] = ok ? v[base + n * s_n + c] : 0.f;
    }
    if (tid < kBKey) {
      const int n = k0 + tid;
      Km[tid] = (n >= N || mrow[n] != 0) ? 1.f : 0.f;
      Ksc[tid] = n < N ? ksc[cbase + n * c_n] : 0.f;
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
        // s is the exact integer dot; (dot * (qs * ks)) * scale
        const float sj = __fmul_rn(
            __fmul_rn(s[i][j], __fmul_rn(qs[i], Ksc[cg + 16 * j])), scale);
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
        Pt[(cg + 16 * j) * kPad + rg * 4 + i] = e;
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
      o[obase + n * o_s_n + cg + 16 * d] = acc[i][d] * inv;
  }
}

// The f32 QK8 kernel over a head of nsl * 128 columns (attention_core.cuh's
// head_dim slices): grid.y runs over (head, slice); per key tile the int8
// dot is summed over the slices, staging one 128-column slice of Q and K at
// a time through Qt and Kt in slice order, each slice's dot an exact integer
// in f32 (128 * 127^2 < 2^24) added to an int32 sum (exact at any width);
// then (dot * (qs * ks)) * scale with the whole head's row scales, the
// online softmax, and P.V on the CTA's own slice of V.
__global__ void __launch_bounds__(kThreads)
masked_attention_q8_sliced_kernel(const int8_t* __restrict__ q8,
                                  const int8_t* __restrict__ k8,
                                  const float* __restrict__ v,
                                  const unsigned char* __restrict__ mask,
                                  const float* __restrict__ qsc,
                                  const float* __restrict__ ksc,
                                  float* __restrict__ o, int N, int nsl,
                                  long long s_b, long long s_h, long long s_n,
                                  long long o_s_b, long long o_s_h,
                                  long long o_s_n, long long c_b,
                                  long long c_h, long long c_n, float scale) {
  constexpr int DH = vs::attn::kSliceDh, DPT = DH / 16;
  extern __shared__ float smem[];
  float* Qt = smem;
  float* Kt = Qt + DH * kPad;
  float* Vs = Kt + DH * kPad;
  float* Pt = Vs + kBKey * DH;
  float* Km = Pt + kBKey * kPad;
  float* Ksc = Km + kBKey;

  const int tid = threadIdx.x;
  const int rg = tid >> 4;
  const int cg = tid & 15;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y / nsl, sl = blockIdx.y % nsl;
  const int b = blockIdx.z;
  const long long base = (long long)b * s_b + (long long)h * s_h;
  const long long cbase = (long long)b * c_b + (long long)h * c_h;
  const unsigned char* mrow = mask + (long long)b * N;

  float qs[4] = {1.f, 1.f, 1.f, 1.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + rg * 4 + i;
    if (n < N) qs[i] = qsc[cbase + n * c_n];
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
    int si[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) si[i][j] = 0;
    for (int sj = 0; sj < nsl; ++sj) {
      __syncthreads();  // the previous readers of Qt, Kt, Vs, Km, Ksc, Pt
      const long long c0 = (long long)sj * DH;
      for (int idx = tid; idx < kBQ * DH; idx += kThreads) {
        const int r = idx / DH, c = idx % DH;
        const int n = q0 + r;
        Qt[c * kPad + r] = n < N ? (float)q8[base + n * s_n + c0 + c] : 0.f;
      }
      for (int idx = tid; idx < kBKey * DH; idx += kThreads) {
        const int r = idx / DH, c = idx % DH;
        const int n = k0 + r;
        const bool ok = n < N;
        Kt[c * kPad + r] = ok ? (float)k8[base + n * s_n + c0 + c] : 0.f;
        if (sj == nsl - 1)
          Vs[r * DH + c] = ok ? v[base + n * s_n + sl * DH + c] : 0.f;
      }
      if (sj == 0 && tid < kBKey) {
        const int n = k0 + tid;
        Km[tid] = (n >= N || mrow[n] != 0) ? 1.f : 0.f;
        Ksc[tid] = n < N ? ksc[cbase + n * c_n] : 0.f;
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
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) si[i][j] += __float2int_rn(s[i][j]);
    }

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // (dot * (qs * ks)) * scale
        const float sv = __fmul_rn(
            __fmul_rn(__int2float_rn(si[i][j]),
                      __fmul_rn(qs[i], Ksc[cg + 16 * j])),
            scale);
        s[i][j] = Km[cg + 16 * j] != 0.f ? -INFINITY : sv;
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
        Pt[(cg + 16 * j) * kPad + rg * 4 + i] = e;
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

  const long long obase =
      (long long)b * o_s_b + (long long)h * o_s_h + sl * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + rg * 4 + i;
    if (n >= N) continue;
    const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
#pragma unroll
    for (int d = 0; d < DPT; ++d)
      o[obase + n * o_s_n + cg + 16 * d] = acc[i][d] * inv;
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
  int nsl;  // the sliced kernels: 128-column slices of a head
};

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (the FlashAttention-2 register layout, built from
// mma_tiles.cuh's tiles and fragments as the bf16 training forward is). A
// CTA of W warps takes 16 W query rows, each warp 16 of them, and walks the
// live 64-key tiles of its element: S = Q.K^T as m16n8k16 products (Q
// fragments loaded once, K tile row-major in shared memory), the softmax on
// S's accumulator registers (a row's 64 keys sit in one thread and its 3
// neighbours), then P.V with P re-packed from S's accumulators straight
// into A fragments (rounded to bf16 there) and V's fragments read row-major
// with a transposing ldmatrix. Rows are padded by 16 bytes, so every
// fragment load of a warp hits 32 distinct banks.
//
// What the design does about what bounds it:
// - K/V tiles, their mask bytes and (QK8) key scales stream through two
//   shared-memory buffers by cp.async: tile i + 1 is in flight while tile i
//   computes, one __syncthreads a tile. Views whose rows the 16-byte copies
//   cannot take (an odd row stride, a misaligned base: vec / vec8 false)
//   stage the same buffers by plain loads; a mask row off a 16-byte
//   boundary (mvec false), or the ragged last tile, by bytes.
// - Only the live tiles: warp 0 lists the 64-key tiles of the element that
//   hold an unpadded key (live_tiles) and both passes walk that list. A
//   wholly padded tile is exact to skip: its e are 0 and, in the fold,
//   corr = exp2(0) = 1, so m, l and o keep their bits. An element with no
//   unpadded key walks none and writes o = 0 in both modes.
// - 128 query rows a CTA (8 warps) where a grid of them fills both CTA
//   slots of every SM, so each K/V tile read from L2 feeds twice the rows
//   of a 64-row CTA; 64 rows (4 warps) on smaller grids, which balance
//   better over the SMs, and at head_dim 128, as the caller picks
//   (ops/attention.mma_cta_rows). __launch_bounds__(..., 2) asks for two
//   CTAs an SM: at most 128 registers a thread at 8 warps.
// - exp as ex2.approx of s * (scale * log2 e) against a max kept in the
//   units of s: one FFMA and one MUFU op a score. (QK8 rounds s itself to
//   f32 as the TPU kernel does, so there the factor is log2 e.)
//
// NORM_FIRST rounds P where the single-pass and block TPU kernels round it
// (attention.py:61-65, block_kernel.py:71-77): after normalising, p =
// exp(s - m) * (1/l) against the row's global max m and sum l. A first pass
// over the live tiles computes S alone (only K streams) and folds each
// row's max and sum; a second recomputes S, normalises, rounds and runs
// P.V: 1.5x the products of one pass. (l is summed tile by tile with the
// online rescaling, so it equals the TPU kernel's sum up to f32 summation
// order.) Without NORM_FIRST this is the folded TPU kernel's one-pass
// online softmax (attention.py:98-115) with its _DEAD guards: the
// unnormalised exp(s - running max) is rounded against the max of the
// tiles walked so far, and the output is divided by l at the end.
template <int DH, int W, bool QK8>
constexpr int mma_smem_fixed() {
  constexpr int LQ = DH + vs::kLdsPad, LQ8 = DH + 16, T = vs::kKeyTile;
  return (QK8 ? (16 * W + 2 * T) * LQ8      // Q8s, K8s[2] (int8)
              : (16 * W + 2 * T) * LQ * 2)  // Qs, Ks[2]
         + 2 * T * LQ * 2                   // Vs[2]
         + (QK8 ? 2 * T * 4 : 0)            // the keys' scales [2]
         + 2 * T;                           // the keys' mask bytes [2]
}

// OutT: bf16, or f32 for the int8 block's attn. QK8: q and k are int8 codes
// with per-row scales qsc / ksc (element strides c_b, c_h, c_n); vec says
// the bf16 rows allow 16-byte copies, vec8 the int8 rows, mvec the mask
// rows.
template <int DH, int W, bool NORM_FIRST, typename OutT, bool QK8>
__global__ void __launch_bounds__(32 * W, 2)
masked_attention_mma_kernel(const Args a, bool vec, bool vec8, bool mvec) {
  using bf = __nv_bfloat16;
  constexpr int T = vs::kKeyTile;
  constexpr int LQ = DH + vs::kLdsPad;  // row length of Qs, Ks and Vs
  constexpr int LQ8 = DH + 16;          // row length of Q8s and K8s (bytes)
  constexpr int KS = DH / 16;           // k16 steps of Q.K^T
  constexpr int KS8 = (DH + 31) / 32;   // k32 steps of the int8 Q.K^T
  constexpr int ND = DH / 8;            // n8 tiles of the output
  constexpr int THREADS = 32 * W, ROWS = 16 * W;
  constexpr int KTILE = QK8 ? T * LQ8 : T * LQ * 2;  // bytes of a K tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf* Qs = reinterpret_cast<bf*>(smem_raw);
  int8_t* Q8s = reinterpret_cast<int8_t*>(smem_raw);
  unsigned char* Kraw = smem_raw + (QK8 ? ROWS * LQ8 : ROWS * LQ * 2);
  bf* Vs = reinterpret_cast<bf*>(Kraw + 2 * KTILE);         // [2][T][LQ]
  float* Ksc = reinterpret_cast<float*>(Vs + 2 * T * LQ);   // [2][T]
  unsigned char* Ms =
      reinterpret_cast<unsigned char*>(Ksc + (QK8 ? 2 * T : 0));  // [2][T]
  int* tiles = reinterpret_cast<int*>(Ms + 2 * T);
  const int N = a.N;
  int* count = tiles + (N + T - 1) / T;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * ROWS;
  const int r = warp * 16 + g;  // the warp's rows r and r + 8 of the tile
  const long long base = (long long)blockIdx.z * a.s_b +
                         (long long)blockIdx.y * a.s_h;
  const long long cbase = (long long)blockIdx.z * a.c_b +
                          (long long)blockIdx.y * a.c_h;
  const unsigned char* mrow = a.mask + (long long)blockIdx.z * N;
  const bf* kh = static_cast<const bf*>(a.k) + base;
  const int8_t* k8h = static_cast<const int8_t*>(a.k) + base;
  const bf* vh = static_cast<const bf*>(a.v) + base;
  // exp(x) = exp2(x * f) on s in its own units: the raw dot (scaled by f)
  // or, QK8, the score rounded as the TPU kernel rounds it
  const float f = QK8 ? vs::kLog2e : a.scale * vs::kLog2e;

  if constexpr (QK8)
    vs::stage_rows<DH, THREADS, int8_t>(
        Q8s, static_cast<const int8_t*>(a.q) + base, a.s_n, q0, ROWS, N,
        vec8);
  else
    vs::stage_rows<DH, THREADS>(Qs, static_cast<const bf*>(a.q) + base,
                                a.s_n, q0, ROWS, N, vec);
  vs::cp_async_commit();
  vs::live_tiles(mrow, N, tiles, count, false, mvec);
  float qs_row[2] = {1.f, 1.f};  // QK8: the scales of rows r and r + 8
  if constexpr (QK8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = q0 + r + 8 * h;
      if (n < N) qs_row[h] = a.qsc[cbase + (long long)n * a.c_n];
    }
  }
  vs::cp_async_wait<0>();
  __syncthreads();
  const int nlive = *count;

  uint32_t qa[QK8 ? 1 : KS][4];
  uint32_t qa8[QK8 ? KS8 : 1][4];
  if constexpr (QK8) {
#pragma unroll
    for (int ks = 0; ks < KS8; ++ks) {
      const int c = ks * 32 + 4 * t;
      qa8[ks][0] = vs::ld_u32(&Q8s[r * LQ8 + c]);
      qa8[ks][1] = vs::ld_u32(&Q8s[(r + 8) * LQ8 + c]);
      qa8[ks][2] = c + 16 < DH ? vs::ld_u32(&Q8s[r * LQ8 + c + 16]) : 0u;
      qa8[ks][3] =
          c + 16 < DH ? vs::ld_u32(&Q8s[(r + 8) * LQ8 + c + 16]) : 0u;
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) vs::load_a<LQ>(qa[ks], Qs, r, ks, t);
  }

  // the i-th live tile (its V rows if with_v) into buffer i & 1, committed
  auto load_tile = [&](int i, bool with_v) {
    const int k0 = tiles[i] * T, buf = i & 1;
    if constexpr (QK8)
      vs::stage_rows<DH, THREADS, int8_t>(
          reinterpret_cast<int8_t*>(Kraw + buf * KTILE), k8h, a.s_n, k0, T,
          N, vec8);
    else
      vs::stage_rows<DH, THREADS>(reinterpret_cast<bf*>(Kraw + buf * KTILE),
                                  kh, a.s_n, k0, T, N, vec);
    if (with_v)
      vs::stage_rows<DH, THREADS>(Vs + buf * T * LQ, vh, a.s_n, k0, T, N,
                                  vec);
    unsigned char* mt = Ms + buf * T;
    if (mvec && k0 + T <= N) {
      if (tid < T / 16) vs::cp_async16(mt + 16 * tid, mrow + k0 + 16 * tid);
    } else if (tid < T) {
      mt[tid] = k0 + tid < N ? mrow[k0 + tid] : 1;  // past N: padded
    }
    if (QK8 && tid < T) {
      if (k0 + tid < N)
        vs::cp_async4(Ksc + buf * T + tid,
                      a.ksc + cbase + (long long)(k0 + tid) * a.c_n);
      else
        Ksc[buf * T + tid] = 0.f;
    }
    vs::cp_async_commit();
  };
  // body(buf) on each live tile in turn, tile i + 1 in flight while tile i
  // computes; the __syncthreads that makes tile i visible also frees the
  // buffer of tile i - 1 for tile i + 1
  auto walk = [&](bool with_v, auto&& body) {
    if (nlive == 0) return;
    load_tile(0, with_v);
    for (int i = 0; i < nlive; ++i) {
      vs::cp_async_wait<0>();
      __syncthreads();
      if (i + 1 < nlive) load_tile(i + 1, with_v);
      body(i & 1);
    }
  };
  // S = Q.K^T of the tile in buffer buf in the units of f (the raw dot, or
  // QK8's rounded score), -inf at padded keys; element (ni, e) is row
  // g + 8*(e >> 1) of the warp, key ni*8 + 2t + (e & 1)
  auto scores = [&](int buf, float (&s)[8][4]) {
    const unsigned char* Mt = Ms + buf * T;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      if constexpr (QK8) {
        const int8_t* krow =
            reinterpret_cast<const int8_t*>(Kraw + buf * KTILE) +
            (ni * 8 + g) * LQ8;
        const float* Kst = Ksc + buf * T;
        int d8[4] = {0, 0, 0, 0};
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
          s[ni][e] = Mt[key] != 0
                         ? -INFINITY
                         : __fmul_rn(__fmul_rn(__int2float_rn(d8[e]),
                                               __fmul_rn(qs_row[e >> 1],
                                                         Kst[key])),
                                     a.scale);
        }
      } else {
        const bf* krow = reinterpret_cast<const bf*>(Kraw + buf * KTILE) +
                         (ni * 8 + g) * LQ;
#pragma unroll
        for (int e = 0; e < 4; ++e) s[ni][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          vs::mma_rows(s[ni], qa[ks], krow, ks, t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (Mt[ni * 8 + 2 * t + (e & 1)] != 0) s[ni][e] = -INFINITY;
      }
    }
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  // fold row half h of the tile into (m, l) with the folded kernel's _DEAD
  // guards; leaves e = exp(s - new max) in s and returns the factor that
  // rescales what was summed before
  auto fold = [&](float (&s)[8][4], int h) -> float {
    float mx = -INFINITY;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
      mx = fmaxf(mx, fmaxf(s[ni][2 * h], s[ni][2 * h + 1]));
    const float m_new = fmaxf(m[h], vs::group_max<4>(mx));
    const bool dead = m_new < kDead;
    const float m_safe = dead ? 0.f : m_new;
    const float ml = m_safe * f;
    const float corr = m[h] < kDead ? 0.f : vs::ex2((m[h] - m_safe) * f);
    float rs = 0.f;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float e =
            dead ? 0.f : vs::ex2(fmaf(s[ni][2 * h + c], f, -ml));
        s[ni][2 * h + c] = e;
        rs += e;
      }
    l[h] = l[h] * corr + vs::group_sum<4>(rs);
    m[h] = m_new;
    return corr;
  };
  // the weights in s, rounded to bf16 A-fragments, times the V tile
  auto accumulate = [&](int buf, const float (&w)[8][4]) {
    const bf* Vt = Vs + buf * T * LQ;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t pa[4];
      vs::pack_a<8>(pa, w, kc);
      vs::mma_cols<DH>(acc, pa, Vt + kc * 16 * LQ, lane);
    }
  };

  if constexpr (NORM_FIRST) {
    walk(false, [&](int buf) {
      float s[8][4];
      scores(buf, s);
      fold(s, 0);
      fold(s, 1);
    });
    __syncthreads();  // the last tile's readers are done before pass 2
    // the final max (0 for a row with no unpadded key) times f, and 1/l
    float ml[2], inv_l[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ml[h] = (m[h] < kDead ? 0.f : m[h]) * f;
      inv_l[h] = l[h] == 0.f ? 0.f : 1.f / l[h];
    }
    walk(true, [&](int buf) {
      float s[8][4];
      scores(buf, s);
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[ni][e] =
              vs::ex2(fmaf(s[ni][e], f, -ml[e >> 1])) * inv_l[e >> 1];
      accumulate(buf, s);
    });
  } else {
    walk(true, [&](int buf) {
      float s[8][4];
      scores(buf, s);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float corr = fold(s, h);
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          acc[nd][2 * h] *= corr;
          acc[nd][2 * h + 1] *= corr;
        }
      }
      accumulate(buf, s);
    });
  }

  const long long obase = (long long)blockIdx.z * a.o_s_b +
                          (long long)blockIdx.y * a.o_s_h;
  OutT* o = static_cast<OutT*>(a.o);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = q0 + r + 8 * h;
    if (n >= N) continue;
    const float inv = NORM_FIRST ? 1.f : (l[h] == 0.f ? 0.f : 1.f / l[h]);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      OutT* dst = &o[obase + n * a.o_s_n + nd * 8 + 2 * t];
      if constexpr (sizeof(OutT) == 4)
        *reinterpret_cast<float2*>(dst) =
            make_float2(acc[nd][2 * h] * inv, acc[nd][2 * h + 1] * inv);
      else
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(
            acc[nd][2 * h] * inv, acc[nd][2 * h + 1] * inv);
    }
  }
}

// The bf16 kernel over a head of nsl * 128 columns (attention_core.cuh's
// head_dim slices), 4 warps (64 query rows), grid.y over (head, slice): per
// live key tile, S is summed over the slices on the tensor cores, one
// 128-column slice of the Q rows and of the K tile staged at a time into
// buffer 0 of the unsliced kernel's tiles (cp.async, then a wait: nothing
// double-buffered) and Q's fragments loaded from it per slice, each score's
// k16 steps in increasing order over the whole head; with QK8 the int8
// products sum in s32 over the slices and are scaled once with the whole
// head's row scales. The softmax, both NORM_FIRST orders and P.V on the
// CTA's own slice of V are the unsliced kernel's (mma_smem_fixed<128, 4,
// QK8>: 87,168 bytes bf16, 63,104 with QK8, plus the live-tile list).
template <bool NORM_FIRST, typename OutT, bool QK8>
__global__ void __launch_bounds__(128, 2)
masked_attention_mma_sliced_kernel(const Args a, bool vec, bool vec8,
                                   bool mvec) {
  using bf = __nv_bfloat16;
  constexpr int DH = vs::attn::kSliceDh, W = 4, T = vs::kKeyTile;
  constexpr int LQ = DH + vs::kLdsPad, LQ8 = DH + 16;
  constexpr int KS = DH / 16, KS8 = DH / 32, ND = DH / 8;
  constexpr int THREADS = 32 * W, ROWS = 16 * W;
  constexpr int KTILE = QK8 ? T * LQ8 : T * LQ * 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf* Qs = reinterpret_cast<bf*>(smem_raw);
  int8_t* Q8s = reinterpret_cast<int8_t*>(smem_raw);
  unsigned char* Kraw = smem_raw + (QK8 ? ROWS * LQ8 : ROWS * LQ * 2);
  bf* Vs = reinterpret_cast<bf*>(Kraw + 2 * KTILE);
  float* Ksc = reinterpret_cast<float*>(Vs + 2 * T * LQ);
  unsigned char* Ms =
      reinterpret_cast<unsigned char*>(Ksc + (QK8 ? 2 * T : 0));
  int* tiles = reinterpret_cast<int*>(Ms + 2 * T);
  const int N = a.N, nsl = a.nsl;
  int* count = tiles + (N + T - 1) / T;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * ROWS;
  const int r = warp * 16 + g;
  const int h = blockIdx.y / nsl, sl = blockIdx.y % nsl;
  const long long base =
      (long long)blockIdx.z * a.s_b + (long long)h * a.s_h;
  const long long cbase =
      (long long)blockIdx.z * a.c_b + (long long)h * a.c_h;
  const unsigned char* mrow = a.mask + (long long)blockIdx.z * N;
  const bf* qh = static_cast<const bf*>(a.q) + base;
  const int8_t* q8h = static_cast<const int8_t*>(a.q) + base;
  const bf* kh = static_cast<const bf*>(a.k) + base;
  const int8_t* k8h = static_cast<const int8_t*>(a.k) + base;
  const bf* vh = static_cast<const bf*>(a.v) + base + sl * DH;
  const float f = QK8 ? vs::kLog2e : a.scale * vs::kLog2e;

  vs::live_tiles(mrow, N, tiles, count, false, mvec);
  float qs_row[2] = {1.f, 1.f};
  if constexpr (QK8) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int n = q0 + r + 8 * hh;
      if (n < N) qs_row[hh] = a.qsc[cbase + (long long)n * a.c_n];
    }
  }
  __syncthreads();  // the tile list
  const int nlive = *count;

  // S of live tile i in the units of f (the raw dot, or QK8's rounded
  // score) summed over the slices, -inf at padded keys; element (ni, e) is
  // row g + 8*(e >> 1) of the warp, key ni*8 + 2t + (e & 1). with_v also
  // stages the tile's rows of the CTA's own slice of V into Vs.
  auto scores = [&](int i, bool with_v, float (&s)[8][4]) {
    const int k0 = tiles[i] * T;
    int d8[QK8 ? 8 : 1][4];
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[ni][e] = 0.f;
        if constexpr (QK8) d8[ni][e] = 0;
      }
    for (int j = 0; j < nsl; ++j) {
      __syncthreads();  // the last readers of every tile are done
      if constexpr (QK8) {
        vs::stage_rows<DH, THREADS, int8_t>(Q8s, q8h + j * DH, a.s_n, q0,
                                            ROWS, N, vec8);
        vs::stage_rows<DH, THREADS, int8_t>(reinterpret_cast<int8_t*>(Kraw),
                                            k8h + j * DH, a.s_n, k0, T, N,
                                            vec8);
      } else {
        vs::stage_rows<DH, THREADS>(Qs, qh + j * DH, a.s_n, q0, ROWS, N,
                                    vec);
        vs::stage_rows<DH, THREADS>(reinterpret_cast<bf*>(Kraw),
                                    kh + j * DH, a.s_n, k0, T, N, vec);
      }
      if (j == 0) {
        if (mvec && k0 + T <= N) {
          if (tid < T / 16) vs::cp_async16(Ms + 16 * tid, mrow + k0 + 16 * tid);
        } else if (tid < T) {
          Ms[tid] = k0 + tid < N ? mrow[k0 + tid] : 1;  // past N: padded
        }
        if (QK8 && tid < T) {
          if (k0 + tid < N)
            vs::cp_async4(Ksc + tid,
                          a.ksc + cbase + (long long)(k0 + tid) * a.c_n);
          else
            Ksc[tid] = 0.f;
        }
      }
      if (with_v && j == nsl - 1)
        vs::stage_rows<DH, THREADS>(Vs, vh, a.s_n, k0, T, N, vec);
      vs::cp_async_commit();
      vs::cp_async_wait<0>();
      __syncthreads();
      if constexpr (QK8) {
#pragma unroll
        for (int ks = 0; ks < KS8; ++ks) {
          const int c = ks * 32 + 4 * t;
          const uint32_t a0 = vs::ld_u32(&Q8s[r * LQ8 + c]);
          const uint32_t a1 = vs::ld_u32(&Q8s[(r + 8) * LQ8 + c]);
          const uint32_t a2 = vs::ld_u32(&Q8s[r * LQ8 + c + 16]);
          const uint32_t a3 = vs::ld_u32(&Q8s[(r + 8) * LQ8 + c + 16]);
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) {
            const int8_t* krow =
                reinterpret_cast<const int8_t*>(Kraw) + (ni * 8 + g) * LQ8;
            vs::mma_s8_16832(d8[ni], a0, a1, a2, a3, vs::ld_u32(krow + c),
                             vs::ld_u32(krow + c + 16));
          }
        }
      } else {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t qa[4];
          vs::load_a<LQ>(qa, Qs, r, ks, t);
#pragma unroll
          for (int ni = 0; ni < 8; ++ni)
            vs::mma_rows(s[ni], qa,
                         reinterpret_cast<const bf*>(Kraw) + (ni * 8 + g) * LQ,
                         ks, t);
        }
      }
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = ni * 8 + 2 * t + (e & 1);
        if constexpr (QK8)
          // (i8dot * (qs * ks)) * scale, block_kernel_int8.py:105-108
          s[ni][e] = Ms[key] != 0
                         ? -INFINITY
                         : __fmul_rn(__fmul_rn(__int2float_rn(d8[ni][e]),
                                               __fmul_rn(qs_row[e >> 1],
                                                         Ksc[key])),
                                     a.scale);
        else if (Ms[key] != 0)
          s[ni][e] = -INFINITY;
      }
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  // the unsliced kernel's fold of row half hh with the _DEAD guards
  auto fold = [&](float (&s)[8][4], int hh) -> float {
    float mx = -INFINITY;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
      mx = fmaxf(mx, fmaxf(s[ni][2 * hh], s[ni][2 * hh + 1]));
    const float m_new = fmaxf(m[hh], vs::group_max<4>(mx));
    const bool dead = m_new < kDead;
    const float m_safe = dead ? 0.f : m_new;
    const float ml = m_safe * f;
    const float corr = m[hh] < kDead ? 0.f : vs::ex2((m[hh] - m_safe) * f);
    float rs = 0.f;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float e =
            dead ? 0.f : vs::ex2(fmaf(s[ni][2 * hh + c], f, -ml));
        s[ni][2 * hh + c] = e;
        rs += e;
      }
    l[hh] = l[hh] * corr + vs::group_sum<4>(rs);
    m[hh] = m_new;
    return corr;
  };
  auto accumulate = [&](const float (&w)[8][4]) {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t pa[4];
      vs::pack_a<8>(pa, w, kc);
      vs::mma_cols<DH>(acc, pa, Vs + kc * 16 * LQ, lane);
    }
  };

  if constexpr (NORM_FIRST) {
    for (int i = 0; i < nlive; ++i) {
      float s[8][4];
      scores(i, false, s);
      fold(s, 0);
      fold(s, 1);
    }
    float ml[2], inv_l[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      ml[hh] = (m[hh] < kDead ? 0.f : m[hh]) * f;
      inv_l[hh] = l[hh] == 0.f ? 0.f : 1.f / l[hh];
    }
    for (int i = 0; i < nlive; ++i) {
      float s[8][4];
      scores(i, true, s);
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[ni][e] =
              vs::ex2(fmaf(s[ni][e], f, -ml[e >> 1])) * inv_l[e >> 1];
      accumulate(s);
    }
  } else {
    for (int i = 0; i < nlive; ++i) {
      float s[8][4];
      scores(i, true, s);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float corr = fold(s, hh);
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          acc[nd][2 * hh] *= corr;
          acc[nd][2 * hh + 1] *= corr;
        }
      }
      accumulate(s);
    }
  }

  const long long obase = (long long)blockIdx.z * a.o_s_b +
                          (long long)h * a.o_s_h + sl * DH;
  OutT* o = static_cast<OutT*>(a.o);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int n = q0 + r + 8 * hh;
    if (n >= N) continue;
    const float inv = NORM_FIRST ? 1.f : (l[hh] == 0.f ? 0.f : 1.f / l[hh]);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      OutT* dst = &o[obase + n * a.o_s_n + nd * 8 + 2 * t];
      if constexpr (sizeof(OutT) == 4)
        *reinterpret_cast<float2*>(dst) =
            make_float2(acc[nd][2 * hh] * inv, acc[nd][2 * hh + 1] * inv);
      else
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(
            acc[nd][2 * hh] * inv, acc[nd][2 * hh + 1] * inv);
    }
  }
}

template <int DH, int W, bool NORM_FIRST, typename OutT, bool QK8>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  // the fixed tiles, then the list of live key tiles and its count
  const int bytes = mma_smem_fixed<DH, W, QK8>() +
                    ((a.N + vs::kKeyTile - 1) / vs::kKeyTile + 1) * 4;
  auto kernel = masked_attention_mma_kernel<DH, W, NORM_FIRST, OutT, QK8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  // 16-byte copies need 16-byte aligned rows
  const bool strided8 = a.s_b % 8 == 0 && a.s_h % 8 == 0 && a.s_n % 8 == 0;
  const bool strided16 =
      a.s_b % 16 == 0 && a.s_h % 16 == 0 && a.s_n % 16 == 0;
  const bool vec = strided8 && vs::aligned16(a.v) &&
                   (QK8 || (vs::aligned16(a.q) && vs::aligned16(a.k)));
  const bool vec8 =
      QK8 && strided16 && vs::aligned16(a.q) && vs::aligned16(a.k);
  const bool mvec = a.N % 16 == 0 && vs::aligned16(a.mask);
  const dim3 grid((a.N + 16 * W - 1) / (16 * W), a.H, a.B);
  kernel<<<grid, 32 * W, bytes, stream>>>(a, vec, vec8, mvec);
  return cudaGetLastError();
}

template <bool NORM_FIRST, typename OutT, bool QK8>
cudaError_t launch_mma_sliced(const Args& a, cudaStream_t stream) {
  constexpr int DH = vs::attn::kSliceDh, W = 4;
  if ((long long)a.H * a.nsl > 65535) return cudaErrorInvalidValue;
  const int bytes = mma_smem_fixed<DH, W, QK8>() +
                    ((a.N + vs::kKeyTile - 1) / vs::kKeyTile + 1) * 4;
  auto kernel = masked_attention_mma_sliced_kernel<NORM_FIRST, OutT, QK8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const bool strided8 = a.s_b % 8 == 0 && a.s_h % 8 == 0 && a.s_n % 8 == 0;
  const bool strided16 =
      a.s_b % 16 == 0 && a.s_h % 16 == 0 && a.s_n % 16 == 0;
  const bool vec = strided8 && vs::aligned16(a.v) &&
                   (QK8 || (vs::aligned16(a.q) && vs::aligned16(a.k)));
  const bool vec8 =
      QK8 && strided16 && vs::aligned16(a.q) && vs::aligned16(a.k);
  const bool mvec = a.N % 16 == 0 && vs::aligned16(a.mask);
  const dim3 grid((a.N + 16 * W - 1) / (16 * W), a.H * a.nsl, a.B);
  kernel<<<grid, 32 * W, bytes, stream>>>(a, vec, vec8, mvec);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_q8(const Args& a, cudaStream_t stream) {
  constexpr int bytes = smem_floats<DH>() * (int)sizeof(float);
  auto kernel = masked_attention_q8_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + kBQ - 1) / kBQ, a.H, a.B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const int8_t*>(a.q), static_cast<const int8_t*>(a.k),
      static_cast<const float*>(a.v), a.mask, a.qsc, a.ksc,
      static_cast<float*>(a.o), a.N, a.s_b, a.s_h, a.s_n, a.o_s_b, a.o_s_h,
      a.o_s_n, a.c_b, a.c_h, a.c_n, a.scale);
  return cudaGetLastError();
}

cudaError_t launch_q8_sliced(const Args& a, int nsl, cudaStream_t stream) {
  constexpr int bytes = smem_floats<vs::attn::kSliceDh>() * (int)sizeof(float);
  if (nsl <= 0 || (long long)a.H * nsl > 65535) return cudaErrorInvalidValue;
  auto kernel = masked_attention_q8_sliced_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + kBQ - 1) / kBQ, a.H * nsl, a.B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const int8_t*>(a.q), static_cast<const int8_t*>(a.k),
      static_cast<const float*>(a.v), a.mask, a.qsc, a.ksc,
      static_cast<float*>(a.o), a.N, nsl, a.s_b, a.s_h, a.s_n, a.o_s_b,
      a.o_s_h, a.o_s_n, a.c_b, a.c_h, a.c_n, a.scale);
  return cudaGetLastError();
}

// head_dim 64 is the flagship's, 16 that of the d 64 test configurations,
// 96 that of d 384 with 4 heads and d 768 with 8, 128 that of d 512 with 4
// heads (ops/_cuda.HEAD_DIMS); at 128 the QK8 kernel takes 116 KB of
// shared memory and the mma kernel 85 KB and the live-tile list; a multiple
// of 128 past it runs the sliced kernels (the same tiles at 128: 116 KB and
// 85 KB, 62 KB with QK8)
cudaError_t launch_q8_dh(const Args& a, int Dh, cudaStream_t stream) {
  switch (Dh) {
    case 16:
      return launch_q8<16>(a, stream);
    case 32:
      return launch_q8<32>(a, stream);
    case 64:
      return launch_q8<64>(a, stream);
    case 96:
      return launch_q8<96>(a, stream);
    case 128:
      return launch_q8<128>(a, stream);
    default:
      return launch_q8_sliced(a, vs::attn::head_slices(Dh), stream);
  }
}

// f32 without QK8 (TPU kernels 3/4 and the attention of the serving blocks
// 1/2): attention_core.cuh's FMA forward, the f32 training attention's, at
// any N over the same strided views, with no dropout (thr 0 hashes
// nothing, kscale 1 is exact) and no lse, online on both routes (in f32
// the single pass and the fold differ by summation order only; an element
// with no unpadded key gives o = 0, as the serving kernels always have),
// in CTAs of 16 TY: `rows` 128 (8 a thread, head_dim <= 64) where a grid
// of them fills both CTA slots of every SM, else 64 (4 a thread: twice the
// warps on a small grid), as the caller picks (ops/attention.mma_cta_rows,
// the bf16 kernel's rule). A row's bits do not depend on the shape: its key
// tiles, the split of its columns over its 8 threads and their shuffle
// reductions are the same in both, so a request scores the same alone and
// in a batch.
template <int DH>
cudaError_t launch_fma_dh(const vs::attn::Args& a, int B, int rows,
                          cudaStream_t stream) {
  if (!vs::attn::fma_layout_ok(a, false)) return cudaErrorMisalignedAddress;
  if constexpr (DH <= 64)
    if (rows == 128)
      return vs::attn::launch_fma_fwd<DH, 16, 8, true>(a, B, stream);
  return rows == 64 ? vs::attn::launch_fma_fwd<DH, 16, 4, true>(a, B, stream)
                    : cudaErrorInvalidValue;
}

cudaError_t launch_fma(const Args& m, int Dh, int rows, cudaStream_t stream) {
  if (!vs::attn::serve_shape_ok(m.B, m.H, m.N, Dh))
    return cudaErrorInvalidValue;
  vs::attn::Args a{};
  a.q = m.q;
  a.k = m.k;
  a.v = m.v;
  a.out = m.o;
  a.mask = m.mask;
  a.isb = m.s_b;
  a.ish = m.s_h;
  a.isn = m.s_n;
  a.osb = m.o_s_b;
  a.osh = m.o_s_h;
  a.osn = m.o_s_n;
  a.N = m.N;
  a.H = m.H;
  a.scale = m.scale;
  a.kscale = 1.f;
  a.online = 1;
  switch (Dh) {
    case 16: return launch_fma_dh<16>(a, m.B, rows, stream);
    case 32: return launch_fma_dh<32>(a, m.B, rows, stream);
    case 64: return launch_fma_dh<64>(a, m.B, rows, stream);
    case 96: return launch_fma_dh<96>(a, m.B, rows, stream);
    case 128: return launch_fma_dh<128>(a, m.B, rows, stream);
    default:
      // past 128: attention_core.cuh's sliced forward, 64-row CTAs
      if (rows != 64) return cudaErrorInvalidValue;
      a.nsl = vs::attn::head_slices(Dh);
      return vs::attn::launch_fwd_sliced<true>(a, m.B, stream);
  }
}

// rows: the CTA's query rows, 16 per warp (ops/attention.mma_cta_rows):
// 128 (8 warps) or 64 (4 warps) at head_dim <= 64, 64 at 96 and 128
template <bool NORM_FIRST, typename OutT, bool QK8>
cudaError_t launch_mma_dh(const Args& a, int Dh, int rows,
                          cudaStream_t stream) {
  // the output is written as pairs
  if ((a.o_s_b | a.o_s_h | a.o_s_n) & 1 ||
      reinterpret_cast<uintptr_t>(a.o) % (2 * sizeof(OutT)))
    return cudaErrorMisalignedAddress;
  if (rows != 64 && !(rows == 128 && Dh <= 64)) return cudaErrorInvalidValue;
  const bool w8 = rows == 128;
  switch (Dh) {
    case 16:
      return w8 ? launch_mma<16, 8, NORM_FIRST, OutT, QK8>(a, stream)
                : launch_mma<16, 4, NORM_FIRST, OutT, QK8>(a, stream);
    case 32:
      return w8 ? launch_mma<32, 8, NORM_FIRST, OutT, QK8>(a, stream)
                : launch_mma<32, 4, NORM_FIRST, OutT, QK8>(a, stream);
    case 64:
      return w8 ? launch_mma<64, 8, NORM_FIRST, OutT, QK8>(a, stream)
                : launch_mma<64, 4, NORM_FIRST, OutT, QK8>(a, stream);
    case 96:
      return launch_mma<96, 4, NORM_FIRST, OutT, QK8>(a, stream);
    case 128:
      return launch_mma<128, 4, NORM_FIRST, OutT, QK8>(a, stream);
    default: {
      if (rows != 64) return cudaErrorInvalidValue;
      Args b = a;
      b.nsl = vs::attn::head_slices(Dh);
      return b.nsl > 0 ? launch_mma_sliced<NORM_FIRST, OutT, QK8>(b, stream)
                       : cudaErrorInvalidValue;
    }
  }
}

}  // namespace

// q, k, v: (B, H, N, Dh) views with element strides s_b, s_h, s_n in dtype,
// or, with qsc / ksc given, q and k int8 codes at the same strides and
// qsc / ksc their per-row f32 scales at strides c_b, c_h, c_n (qk_int8). o in
// out_dtype: dtype, or f32 for bf16 inputs with norm_first (the int8 block).
// cta_rows: the query rows of a CTA (the f32 QK8 kernel's are 64).
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
                                   int cta_rows, void* stream) {
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
    err = qk8 ? launch_q8_dh(a, Dh, s) : launch_fma(a, Dh, cta_rows, s);
  } else if (dtype == vs::kBF16 && out_dtype == vs::kBF16 && !qk8) {
    err = norm_first
              ? launch_mma_dh<true, __nv_bfloat16, false>(a, Dh, cta_rows, s)
              : launch_mma_dh<false, __nv_bfloat16, false>(a, Dh, cta_rows,
                                                           s);
  } else if (dtype == vs::kBF16 && out_dtype == vs::kF32 && norm_first) {
    err = qk8 ? launch_mma_dh<true, float, true>(a, Dh, cta_rows, s)
              : launch_mma_dh<true, float, false>(a, Dh, cta_rows, s);
  }
  return (int)err;
}
