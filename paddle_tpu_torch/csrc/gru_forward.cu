// GRU forward time loop for Hopper (sm_90a), with or without the backward's
// residual outputs.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py::_gru_pallas_raw (the
// _gru_kernel body, batch_split=0; residuals=False for inference,
// residuals=True for training), which the encoder reaches through
// ops/rnn_fused.py::_gru_core_fwd.
//
// Computes, for t = 0 .. T-1 over a time-major batch (gate order [r, u, c],
// r applied to h BEFORE the candidate product, as ops/rnn.py::gru_step):
//     zr     = xp[t, :, :2H] + round(h) @ W[:, :2H]
//     r, u   = sigmoid(zr[:, :H]), sigmoid(zr[:, H:])
//     zc     = xp[t, :, 2H:] + round(r * h) @ W[:, 2H:]
//     h_new  = u * h + (1 - u) * tanh(zc)
//     h      = mask[t] > 0 ? h_new : h          (masked steps hold the carry)
//     h_seq[t] = h * mask[t]                    (and emit zero)
// round() is the cast of a matmul operand to the compute type (CT: float or
// bfloat16); products accumulate in float32 and the carry stays float32.
// With residuals (training), each step also stores, in the residual type RT
// (ops/rnn_fused.py::residual_dtype), where _gru_kernel stores them:
//     z[t]      = [zr, zc]   the pre-activations           [B, 3H]
//     h_prev[t] = h          the carry entering the step   [B, H]
//
// What bounds it on this card: the recurrence is sequential over T and each
// step has a row-wide dependency -- (r*h) @ W_c needs the whole r row.  At
// the serving shape (B <= 64, H = 512, T = 32) one step is 0.1 GFLOP and
// reads W (1.5 MB in bf16, resident in the 50 MB L2 after the first step),
// so the loop is bound by the latency of 2T dependent kernel launches, far
// above both the byte and the FLOP bound of the whole call.
//
// Design: two small kernels per step, launched from a host loop over T
// (one library call per direction), shared with the bidirectional K11
// (bigru_forward.cu) in gru_common.cuh:
//   gru_gates_kernel   the [B, 2H] gate product + sigmoid -> r*h, u
//   gru_cand_kernel    the [B, H] candidate product + tanh + update + mask
// The launch boundary is the grid-wide barrier the row dependency needs; a
// cooperative persistent kernel with two grid syncs per step is the faster
// alternative for a later change.  Each block computes a 32 x 32 output tile
// with a shared-memory tiled product over k in a FIXED order, so a row's
// arithmetic never depends on B: a merged prefill and a solo one give the
// same rows bit for bit.  The residual stores add 8 bytes (bf16) per
// carry element a step to a loop that is bound by launch latency, not bytes.

#include "gru_common.cuh"

// xp [T, B, 3H] f32, mask [T, B] f32, w [H, 3H] in the compute type,
// h_seq [T, B, H] f32 out, h [B, H] f32 in: h0, out: h_final,
// rh / u [B, H] f32 scratch; z [T, B, 3H] and hprev [T, B, H] residual
// outputs in bfloat16 (res_bf16 != 0) or float32, both null for
// inference.  Returns a cudaError_t.
extern "C" int gru_forward_f32(const void* xp, const void* mask,
                               const void* w, void* h_seq, void* h, void* rh,
                               void* u, void* z, void* hprev, int res_bf16,
                               int T, int B, int H, void* stream) {
  return gru::forward_dispatch<float>(xp, mask, w, h_seq, h, rh, u, z, hprev,
                                      res_bf16, T, B, H, 0, stream);
}

extern "C" int gru_forward_bf16(const void* xp, const void* mask,
                                const void* w, void* h_seq, void* h, void* rh,
                                void* u, void* z, void* hprev, int res_bf16,
                                int T, int B, int H, void* stream) {
  return gru::forward_dispatch<__nv_bfloat16>(xp, mask, w, h_seq, h, rh, u,
                                              z, hprev, res_bf16, T, B, H, 0,
                                              stream);
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
