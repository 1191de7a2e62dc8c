// Bidirectional GRU forward time loop for Hopper (sm_90a): both directions
// of a bidirectional layer in ONE loop over T, with or without the
// backward's residual outputs.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py::_gru_pallas_raw with
// batch_split=B (the _gru_kernel body, its split product at :277-285),
// which the encoder reaches through ops/rnn_fused.py::bigru_sequence_fused
// when FLAGS.use_pallas_bigru is on.
//
// Computes the GRU step of gru_common.cuh over a stacked time-major batch
// of 2B rows: rows [0, B) are the forward direction and use W[:H]; rows
// [B, 2B) hold the backward direction's inputs flipped in time by the
// caller and use W[H:] of the stacked weight w2 [2H, 3H].  Outputs keep the
// stacking: h_seq [T, 2B, H], h_fin [2B, H] and (training) the residuals
// z [T, 2B, 3H] and h_prev [T, 2B, H] in the residual type.
//
// What bounds it on this card: as K3 (gru_forward.cu), the 2T dependent
// grid-wide steps of a sequential recurrence.  The two directions of a
// bidirectional layer are independent, so running them in one loop halves
// the dependent steps of the layer (2T instead of 4T).
//
// Design: K3's two paths of gru_common.cuh with the row split, picked by
// K3's function (ops/kernels/gru.py::_gru_fwd_path with two directions):
// "persistent" (bf16 compute), one cooperative launch whose blocks each
// serve one direction (2 x 32 unit groups x 2 row groups at H = 512, each
// direction's rows in 16-row tiles); "steps", the host loop, whose grid's
// row blocks are cut per direction (ceil(B / 32) on W, then ceil(B / 32)
// on W + H * 3H).  No tile straddles the split for any B, so a row meets
// exactly the arithmetic of a one-direction K3 call on the same path, in
// the same order, and K11's rows are bit-identical to two K3 calls.

#include "gru_common.cuh"

// xp [T, 2B, 3H] f32, mask [T, 2B] f32, w2 [2H, 3H] in the compute type,
// h_seq [T, 2B, H] f32 out, h [2B, H] f32 in: h0, out: h_final,
// rh / u [2B, H] f32 scratch; z [T, 2B, 3H] and hprev [T, 2B, H] residual
// outputs in bfloat16 (res_bf16 != 0) or float32, both null for
// inference; B2 = 2B rows, split = B.  Returns a cudaError_t.
extern "C" int bigru_forward_f32(const void* xp, const void* mask,
                                 const void* w2, void* h_seq, void* h,
                                 void* rh, void* u, void* z, void* hprev,
                                 int res_bf16, int T, int B2, int H,
                                 int split, void* stream) {
  if (split <= 0) return (int)cudaErrorInvalidValue;
  return gru::forward_dispatch<float>(xp, mask, w2, h_seq, h, rh, u, z,
                                      hprev, res_bf16, T, B2, H, split,
                                      stream);
}

extern "C" int bigru_forward_bf16(const void* xp, const void* mask,
                                  const void* w2, void* h_seq, void* h,
                                  void* rh, void* u, void* z, void* hprev,
                                  int res_bf16, int T, int B2, int H,
                                  int split, void* stream) {
  if (split <= 0) return (int)cudaErrorInvalidValue;
  return gru::forward_dispatch<__nv_bfloat16>(xp, mask, w2, h_seq, h, rh, u,
                                              z, hprev, res_bf16, T, B2, H,
                                              split, stream);
}

// The persistent kernel (see _gru_fwd_path / _gru_fwd_plan with two
// directions), bf16 compute only: the arguments of bigru_forward_bf16 with
// hb and rhb [2B, H] bf16 scratch in place of rh and u, then bar [1] u32
// zeroed, and the plan's UG = H / 16 unit groups and RG row groups (2 * UG
// * RG blocks).  H % 32 == 0.
extern "C" int bigru_forward_persistent(const void* xp, const void* mask,
                                        const void* w2, void* h_seq, void* h,
                                        void* hb, void* rhb, void* z,
                                        void* hprev, void* bar, int res_bf16,
                                        int T, int B2, int H, int split,
                                        int UG, int RG, void* stream) {
  if (split <= 0) return (int)cudaErrorInvalidValue;
  return gru::forward_persistent_dispatch(xp, mask, w2, h_seq, h, hb, rhb, z,
                                          hprev, bar, res_bf16, T, B2, H,
                                          split, UG, RG, stream);
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
