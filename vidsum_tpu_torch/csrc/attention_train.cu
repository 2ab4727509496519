// attention_train: masked attention with hash dropout on the softmax weights,
// forward and backward, for sm_90a: the flash-attention training route.
//
// Replaces the TPU kernels vidsum_tpu/ops/attention_train.py::_fwd_kernel and
// ::_bwd_kernel (a single pass over all keys of a 128-query tile) and
// ::_fwd_kernel_folded and ::_bwd_kernel_folded (an online softmax over
// kb-key blocks, for long N). Inputs q, k, v (and the cotangent dO and the
// forward output o) are contiguous (B, H, N, DH) tensors in float or bf16,
// DH 16, 32, 64 or 128, the key mask (B, N) bytes (nonzero = padded), lse
// and D (B, H, N) f32. Two entry points (nothing here allocates):
//   vs_at_fwd  normalise-first for _fwd_kernel (pass 1 the row max and sum,
//              pass 2 p = e / l, dropped, rounded to the input type, then
//              P.V), online for _fwd_kernel_folded (the denominator sums the
//              raw e while the dropped, unnormalised e is rounded and
//              accumulated, with the _DEAD guards); writes o and
//              lse = max + log(sum). In f32 nothing is rounded between the
//              two orders' passes, and both routes fold online in one pass.
//   vs_at_bwd  a dQ kernel then a dK/dV kernel. D = rowsum(dp * p) over the
//              full row for _bwd_kernel (a first pass over the keys),
//              rowsum(dO * o) with the lse guard for _bwd_kernel_folded; in
//              f32 the single pass takes rowsum(dO * o) too when given o (the
//              same quantity, without the first pass).
// Two kernel families serve them, chosen by dtype with no fallback between
// them:
//   - bf16, on both routes: attention_train_mma.cuh, every product on the
//     tensor cores (mma.sync m16n8k16, f32 accumulate), cp.async
//     double-buffered tiles, wholly padded key tiles skipped; the folded
//     route is its kernels' online / folded mode (one fused forward pass, D
//     from the o rows). Its note gives its bound and design.
//   - f32, on both routes: attention_core.cuh's FMA family, which the
//     training block (block_train.cu) launches too: exact f32 FMA (a TF32
//     product would not compute what the TPU's f32 kernels compute) in
//     8 x 8 register tiles read as float4 from row-major tiles that arrive
//     by cp.async, live key tiles only, one forward pass. Its note gives its
//     bound (at (2, 4, 8192, 64) with valid (8100, 5000) 1.64 ms forward,
//     3.28 ms backward at the card's 67 TFLOP/s f32 peak) and design.
// The dropout bits are attention_train.py::_keep_mask_block, a pure function
// of (seed, element, head, absolute query row, absolute key column), so the
// tiling is free and both routes and families draw identical bits.
#include "attention_train_mma.cuh"

namespace {

// (B, H, N, Dh) contiguous tensors: q, k, v, o, dO and the grads alike
vs::attn::Args bhnd_args(int H, int N, int Dh, float scale, unsigned seed,
                         unsigned thr, float kscale) {
  vs::attn::Args a{};
  a.isb = a.osb = (long long)H * N * Dh;
  a.ish = a.osh = (long long)N * Dh;
  a.isn = a.osn = Dh;
  a.N = N;
  a.H = H;
  a.scale = scale;
  a.seed = seed;
  a.thr = thr;
  a.kscale = kscale;
  a.hash = vs::attn::kHashAttention;
  return a;
}

bool dtype_ok(int dtype) { return dtype == vs::kF32 || dtype == vs::kBF16; }

}  // namespace

// dtype: 0 float, 1 bf16 (ops/_cuda.DTYPE_CODES); online: 1 for the folded
// route's one-pass forward, 0 for the single-pass route's normalise-first one
extern "C" int vs_at_fwd(const void* q, const void* k, const void* v,
                         const unsigned char* mask, void* o, float* lse,
                         int B, int H, int N, int Dh, float scale,
                         unsigned seed, unsigned thr, float kscale, int dtype,
                         int online, void* stream) {
  if (!vs::attn::shape_ok(B, H, N, Dh) || !dtype_ok(dtype))
    return (int)cudaErrorInvalidValue;
  vs::attn::Args a = bhnd_args(H, N, Dh, scale, seed, thr, kscale);
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = mask;
  a.out = o;
  a.lse = lse;
  a.online = online;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == vs::kBF16
                   ? vs::attn_mma::launch_fwd_dh(a, B, Dh, s)
                   : vs::attn::launch_fwd_dh(a, B, Dh, s));
}

// folded: 1 for the folded route's backward (D = rowsum(dO * o), o required,
// the lse guard), 0 for the single-pass one (D = rowsum(dp * p); in f32
// rowsum(dO * o) where o is given); D is (B, H, N) f32 scratch
extern "C" int vs_at_bwd(const void* q, const void* k, const void* v,
                         const void* dO, const void* o, const float* lse,
                         const unsigned char* mask, float* D, void* dq,
                         void* dk, void* dv, int B, int H, int N, int Dh,
                         float scale, unsigned seed, unsigned thr,
                         float kscale, int dtype, int folded, void* stream) {
  if (!vs::attn::shape_ok(B, H, N, Dh) || !dtype_ok(dtype) ||
      (folded && o == nullptr))
    return (int)cudaErrorInvalidValue;
  vs::attn::Args a = bhnd_args(H, N, Dh, scale, seed, thr, kscale);
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dO = dO;
  a.mask = mask;
  a.lse = const_cast<float*>(lse);  // read only by the backward
  a.D = D;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.d_from_o = folded || (dtype == vs::kF32 && o != nullptr);
  a.guard = folded;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == vs::kBF16
                   ? vs::attn_mma::launch_bwd_dh(a, B, Dh, s)
                   : vs::attn::launch_bwd_dh(a, B, Dh, s));
}
