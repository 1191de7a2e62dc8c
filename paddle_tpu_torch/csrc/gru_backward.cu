// GRU backward time loop (the reverse recurrence) for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas_kernels.py::_gru_bwd_pallas_raw (the
// _gru_bwd_kernel body, batch_split=0), which the encoder's backward
// reaches through ops/rnn_fused.py::_gru_seq_bwd.
//
// Computes, for t = T-1 .. 0 over a time-major batch, from the forward's
// residuals z[t] = [zr, zc] and h_prev[t] (stored in RT: float or bfloat16,
// widened to float32 here), the carry cotangent d_c (seeded by d_hfin):
//     r, u = sigmoid(zr[:, :H]), sigmoid(zr[:, H:]);  cand = tanh(zc)
//     m      = mask[t] > 0 ? 1 : 0
//     d_hnew = m * (d_out[t] + d_c)
//     d_u    = d_hnew * (h_prev - cand)
//     d_zc   = d_hnew * (1 - u) * (1 - cand * cand)
//     d_rh   = d_zc @ W[:, 2H:]^T                      (f32 product)
//     d_zr   = [d_rh * h_prev * r * (1 - r),  d_u * u * (1 - u)]
//     d_hp   = d_hnew * u + d_rh * r + d_zr @ W[:, :2H]^T   (f32 product)
//     d_c    = (1 - m) * d_c + d_hp
//     d_z[t] = [d_zr, d_zc]
// and returns d_h0 = d_c after step 0.  The products take the transposed
// float32 weight w_t [3H, H] (= W^T), as the reference does (f32 operands,
// the backward's deliberate accumulation policy: ops/numerics.py::bwd_mm).
//
// What bounds it on this card: as in the forward, the loop is sequential
// over T and each step has two dependent row-wide products (d_rh needs the
// whole d_zc row; the second product needs the whole d_zr row).  At the
// training shape (B = 384, H = 512, T = 32) a step is 0.6 GFLOP of f32
// products and reads w_t (3 MB, resident in the 50 MB L2 after the first
// step); the whole call's bound is ~0.3 ms of f32 FMA time, and it runs as
// 2T dependent launches, so launch latency and per-block k-loops bound it.
//
// Design: two small kernels per step from a host loop (the launch boundary
// is the grid-wide barrier each product needs), shared with the
// bidirectional K11 (bigru_backward.cu) in gru_common.cuh:
//   gru_bwd_cand_kernel  d_rh = d_zc @ W_c^T, with d_zc formed elementwise
//                        while its tile is loaded (it is never stored
//                        before the product); the epilogue writes all
//                        three gate blocks of d_z[t] and the partial
//                        d_hnew * u + d_rh * r
//   gru_bwd_gate_kernel  d_zr @ W_g^T from the d_z[t] just written, then
//                        the carry update d_c = (1 - m) d_c + d_hp
// Each block owns a 32 x 32 output tile and sums over k in a fixed order,
// so a row's result does not depend on B.

#include "gru_common.cuh"

// dout [T, B, H] f32, mask [T, B] f32, z [T, B, 3H] and hprev [T, B, H] in
// the residual type (res_bf16 != 0: bfloat16, else float32), w_t [3H, H]
// f32 (the transposed recurrent weight), dz [T, B, 3H] f32 out,
// dc [B, H] f32 in: d_hfin, out: d_h0, part [B, H] f32 scratch.
// Returns a cudaError_t.
extern "C" int gru_backward(const void* dout, const void* mask, const void* z,
                            const void* hprev, const void* w_t, void* dz,
                            void* dc, void* part, int res_bf16, int T, int B,
                            int H, void* stream) {
  return gru::backward_dispatch(dout, mask, z, hprev, w_t, dz, dc, part,
                                res_bf16, T, B, H, 0, stream);
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
