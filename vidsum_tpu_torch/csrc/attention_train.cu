// attention_train: masked attention with hash dropout on the softmax weights,
// forward and backward, for sm_90a: the flash-attention training route.
//
// Replaces the TPU kernels vidsum_tpu/ops/attention_train.py::_fwd_kernel and
// ::_bwd_kernel (a single pass over all keys of a 128-query tile) and
// ::_fwd_kernel_folded and ::_bwd_kernel_folded (an online softmax over
// kb-key blocks, for long N). Inputs q, k, v (and the cotangent dO and the
// forward output o) are contiguous (B, H, N, DH) tensors in float or bf16,
// the key mask (B, N) bytes (nonzero = padded), lse and D (B, H, N) f32.
//
// The kernels are attention_core.cuh's family, which the training block
// (block_train.cu) launches too; ops/attention_train.py launches them here
// through two entry points (nothing here allocates):
//   vs_at_fwd  fwd_kernel, normalise-first for _fwd_kernel (pass 1 the row
//              max and sum, pass 2 p = e / l, dropped, rounded to the input
//              type, then P.V), online for _fwd_kernel_folded (the
//              denominator sums the raw e while the dropped, unnormalised e
//              is rounded and accumulated, with the _DEAD guards); writes o
//              and lse = max + log(sum).
//   vs_at_bwd  dq_kernel then dkdv_kernel. D = rowsum(dp * p) over the full
//              row for _bwd_kernel (a first pass over the keys), rowsum(dO *
//              o) with the lse guard for _bwd_kernel_folded.
// The dropout bits are attention_train.py::_keep_mask_block, a pure function
// of (seed, element, head, absolute query row, absolute key column), so the
// tiling is free and both routes draw identical bits. bf16 values are
// widened exactly and rounded where the TPU kernels round them; dp = dO . V^T
// and dV = Pd^T . dO stay f32 x f32 in both types, as on the TPU.
//
// Bound on the card: the forward's products are 4*d*N*sum(valid keys) and the
// backward's 8*d*N*sum(valid) (without the recompute), d = H*DH; against
// them the kernels read and write a few (B, H, N, DH) tensors, so they are
// bound by operations: at (B, H, N, DH) = (4, 4, 8192, 64), 0.27 TFLOP
// forward, ~4 ms at the card's 67 TFLOP/s f32 peak outside the tensor cores
// (bf16 inputs: ~0.3 ms at 989 TFLOP/s, the backward's dp and dV counted at
// the f32 peak). Design against it: nothing of size N x N reaches device
// memory; each CTA keeps a 64 x 64 score tile on chip with 4 x 4 register
// blocks over transposed, padded shared-memory tiles (conflict-free reads).
// The normalise-first forward pays one Q.K^T pass more, the single-pass dQ
// kernel two products more (its D pass), the backward one recompute of the
// scores in each kernel. bf16 runs the same FMA path as f32, so it is far
// from its tensor-core bound; no load overlaps compute yet.
#include "attention_core.cuh"

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
  return (int)(dtype == vs::kF32
                   ? vs::attn::launch_fwd_dh<float>(a, B, Dh, s)
                   : vs::attn::launch_fwd_dh<__nv_bfloat16>(a, B, Dh, s));
}

// folded: 1 for the folded route's backward (D = rowsum(dO * o), o required,
// the lse guard), 0 for the single-pass one (D = rowsum(dp * p)); D is
// (B, H, N) f32 scratch
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
  a.d_from_o = folded;
  a.guard = folded;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == vs::kF32
                   ? vs::attn::launch_bwd_dh<float>(a, B, Dh, s)
                   : vs::attn::launch_bwd_dh<__nv_bfloat16>(a, B, Dh, s));
}
