// Post-LN transformer-block kernels for Hopper (sm_90a): the residual blocks
// of the XLM-RoBERTa text tower (BERT-style: the LayerNorm closes the block)
// as short chains of hand-written kernels.
//
// Replaces the Pallas TPU kernels of wise_tpu/ops/postln_block.py:
//   wt_postln_attn_block <- fused_postln_attn_block (_postln_attn_kernel)
//   wt_postln_mlp_block  <- fused_postln_mlp_block, variant "single"
//                           (_postln_mlp_kernel)
//   wt_postln_fc         <- variant "split", first half  (_postln_fc_kernel)
//   wt_postln_proj       <- variant "split", second half (_postln_proj_kernel)
//
// The TPU kernels hold a layer's weights in VMEM and run a group of examples
// per grid step. Here a block is a chain of launches on one stream, built
// from the pieces the pre-LN blocks use (common.cuh, attention.cuh):
//
//   attention block   qkv GEMM on x itself (no LayerNorm before it) + bias ->
//                     attention_kernel with the per-example additive key
//                     mask km -> out-proj GEMM whose epilogue writes
//                     x + acc + bias as f32 -> LayerNorm (f32 in, bf16 out)
//   MLP block         fc GEMM + bias + exact-erf GELU -> proj GEMM with the
//                     same f32 residual epilogue -> LayerNorm
//
// What differs from the pre-LN chains: the first GEMM reads the bf16 stream
// directly; the residual x is bf16 while the sum that the LayerNorm
// normalises is f32 (gemm_kernel<float, kBiasResidual, bf16>), so the sum
// rounds once, after the LayerNorm, as in the TPU kernels; and the attention
// adds km[b, j] (0 keep, -inf drop) to every logit of key j of example b.
// "single" and "split" are one code path with two entries: wt_postln_mlp_block
// is postln_fc then residual_layernorm on scratch of its own, wt_postln_fc and
// wt_postln_proj are the same two calls with h in the caller's memory (as
// wt_mlp_block and wt_mlp_fc + wt_mlp_proj are).
//
// What bounds them on the H100: at the tower's width (D = 1024, F = 4096) the
// GEMMs hold over 95% of the operations and are compute-bound at an ingest
// batch (256 x 64 rows). At a served query batch (8 x 64 rows) the bound by
// operations and the bound by the weights' bytes (8 MB an attention block,
// 16 MB an MLP) lie within a factor of two of each other, and both far under
// the chain's time: 512 rows make 4 x 8 tiles of 128 x 128 for 132 SMs, so
// the out-projection takes 64 x 64 tiles there (common.cuh), and launches
// decide. The f32 sum costs one extra write and read of (M, D) f32
// against fusing the LayerNorm into the epilogue, which needs a whole row
// (1024 columns) in one block: later work.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after each launch.

#include "attention.cuh"

namespace {

// out = LN(x + (a W + bias)) as bf16: x (M, D) bf16, a (M, K) bf16, W (K, D);
// the sum lands in res (M, D) f32 and is normalised from there.
cudaError_t residual_layernorm(const bf16* a, int K, const bf16* w,
                               const bf16* bias, const bf16* x,
                               const float* ln_s, const float* ln_b, bf16* out,
                               float* res, int M, int D, cudaStream_t st) {
  cudaError_t err = gemm<float, kBiasResidual, bf16>(
      a, K, w, D, bias, res, D, x, D, kNoMap, M, D, K, kNone, st);
  if (err != cudaSuccess) return err;
  return launch_layernorm<float>(res, ln_s, ln_b, out, M, D, st);
}

// h = act(x wfc + bfc) as (M, F) bf16: h rounds once, after the activation
cudaError_t postln_fc(const bf16* x, const bf16* wfc, const bf16* bfc, bf16* h,
                      int M, int D, int F, int act, cudaStream_t st) {
  return gemm<bf16, kBiasAct>(x, D, wfc, F, bfc, h, F, nullptr, 0, kNoMap, M,
                              F, D, act, st);
}

}  // namespace


extern "C" {

// LN(x + out_proj(MHA(x, km))): x (B, SP, D) bf16 -> out, same shape, bf16.
// km (B, SP) f32 is added to the logits of each example's keys. Scratch:
// qkv (B*SP, 3D) bf16, att (B*SP, D) bf16, res (B*SP, D) f32.
int wt_postln_attn_block(const bf16* x, const float* km, const float* ln_s,
                         const float* ln_b, const bf16* wqkv,
                         const bf16* bqkv, const bf16* wo, const bf16* bo,
                         bf16* out, bf16* qkv, bf16* att, float* res, int B,
                         int SP, int D, int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * SP;
  const int hd = head_dim(SP, D, H);
  if (!hd) return (int)cudaErrorInvalidValue;
  WT_CHECK((gemm<bf16, kBias>(x, D, wqkv, 3 * D, bqkv, qkv, 3 * D, nullptr, 0,
                              kNoMap, M, 3 * D, D, kNone, st)));
  WT_CHECK(attention_packed(hd, qkv, km, att, D, B, SP, H, SP, 0, st));
  WT_CHECK(residual_layernorm(att, D, wo, bo, x, ln_s, ln_b, out, res, M, D,
                              st));
  return 0;
}

// LN(x + proj(act(fc(x)))): scratch h (M, F) bf16, res (M, D) f32.
int wt_postln_mlp_block(const bf16* x, const float* ln_s, const float* ln_b,
                        const bf16* wfc, const bf16* bfc, const bf16* wproj,
                        const bf16* bproj, bf16* out, bf16* h, float* res,
                        int M, int D, int F, int act, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  WT_CHECK(postln_fc(x, wfc, bfc, h, M, D, F, act, st));
  WT_CHECK(residual_layernorm(h, F, wproj, bproj, x, ln_s, ln_b, out, res, M,
                              D, st));
  return 0;
}

// The first half of the split MLP: h = act(fc(x)) as (M, F) bf16 in the
// caller's memory.
int wt_postln_fc(const bf16* x, const bf16* wfc, const bf16* bfc, bf16* h,
                 int M, int D, int F, int act, void* stream) {
  return (int)postln_fc(x, wfc, bfc, h, M, D, F, act,
                        static_cast<cudaStream_t>(stream));
}

// The second half: out = LN(x + (proj(h) + b)) as bf16. Scratch res (M, D)
// f32.
int wt_postln_proj(const bf16* h, const bf16* wproj, const bf16* bproj,
                   const bf16* x, const float* ln_s, const float* ln_b,
                   bf16* out, float* res, int M, int D, int F, void* stream) {
  return (int)residual_layernorm(h, F, wproj, bproj, x, ln_s, ln_b, out, res,
                                 M, D, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
