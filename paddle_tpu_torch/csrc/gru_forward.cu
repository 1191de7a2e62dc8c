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
// step has two dependent row-wide products -- (r*h) @ W_c needs the whole r
// row, and the next step's gate product the whole h row.  At the serving
// shape (B <= 64, H = 512, T = 32) the call's bytes bound it at ~0.006 ms
// and its products (0.1 GFLOP a step) at less; at the training shape (B =
// 384, residuals) its bytes at ~0.046 ms.  What costs is the 2T grid-wide
// dependencies.
//
// Two paths, picked by the wrapper from (compute type, B, H, SM count)
// alone (ops/kernels/gru.py::_gru_fwd_path), both in gru_common.cuh and
// shared with the bidirectional K11 (bigru_forward.cu):
//   "persistent"  gru_fwd_persistent_kernel (bf16 compute): the whole loop
//                 in ONE cooperative launch, bf16 W resident in shared
//                 memory split by 16-unit groups across the SMs (32 unit
//                 groups x 4 row groups = 128 blocks at H = 512), two grid
//                 barriers a step, mma.sync products, each product's
//                 epilogue fusing the step's elementwise math and stores
//   "steps"       gru_gates_kernel + gru_cand_kernel, two launches a step
//                 from a host loop (f32 compute, or shapes the plan cannot
//                 take): the [B, 2H] gate product + sigmoid -> r*h, u;
//                 the [B, H] candidate product + tanh + update + mask
// Each sums every output over k in an order fixed by H, so a row's result
// does not depend on B: a merged prefill and a solo one give the same rows
// bit for bit.

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

// The persistent kernel (see _gru_fwd_path / _gru_fwd_plan), bf16 compute
// only: the arguments of gru_forward_bf16 with hb and rhb [B, H] bf16
// scratch in place of rh and u, then bar [1] u32 zeroed, and the plan's
// UG = H / 16 unit groups and RG row groups (UG * RG blocks).  H % 32 == 0.
extern "C" int gru_forward_persistent(const void* xp, const void* mask,
                                      const void* w, void* h_seq, void* h,
                                      void* hb, void* rhb, void* z,
                                      void* hprev, void* bar, int res_bf16,
                                      int T, int B, int H, int UG, int RG,
                                      void* stream) {
  return gru::forward_persistent_dispatch(xp, mask, w, h_seq, h, hb, rhb, z,
                                          hprev, bar, res_bf16, T, B, H, 0,
                                          UG, RG, stream);
}

// registers a thread, local (spilled) bytes a thread and shared bytes a
// block of kernel `which` (0: persistent at width H with R rows of carry a
// block; 1, 2: the steps path's two kernels), bf16 compute and residuals
extern "C" int gru_forward_info(int which, int H, int R, int* regs,
                                int* local_bytes, int* smem_bytes) {
  return gru::forward_info(which, H, R, regs, local_bytes, smem_bytes);
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
