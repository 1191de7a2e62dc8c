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
// What bounds it on this card: the loop is sequential over T and each step
// has two dependent row-wide products (d_rh needs the whole d_zc row; the
// second product needs the whole d_zr row).  At the training shape (B =
// 384, H = 512, T = 32) a step is 0.6 GFLOP of f32 products; the whole
// call's bound is ~0.29 ms of f32 FMA time (67 TFLOP/s, no tensor cores:
// the backward keeps f32 operands).  The grid-wide dependency twice a step
// is what costs.
//
// Two kernels, picked by the wrapper from (B, H, SM count) alone
// (ops/kernels/gru.py::_gru_bwd_path), both in gru_common.cuh and shared
// with the bidirectional K11 (bigru_backward.cu):
//   "persistent"  gru_bwd_persistent_kernel: the whole reverse loop in ONE
//                 cooperative launch, w_t resident in shared memory split
//                 by 32-column groups across the SMs (16 x 8 = 128 blocks
//                 at H = 512, B = 384), two grid barriers a step, each
//                 product's epilogue fusing the step's elementwise math
//   "steps"       gru_bwd_cand_kernel + gru_bwd_gate_kernel, two launches
//                 a step from a host loop (shapes the plan cannot take):
//                 the first forms d_zc elementwise while its tile loads and
//                 writes all three gate blocks of d_z[t] and the partial
//                 d_hnew * u + d_rh * r; the second adds d_zr @ W_g^T and
//                 updates the carry
// Each sums every output over k in an order fixed by H, so a row's result
// does not depend on B.

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

// The persistent kernel (see _gru_bwd_path / _gru_bwd_plan): the same
// arguments as gru_backward, then dzc [B, H] f32 scratch, bar [1] u32
// zeroed, and the plan's CG = ceil(H / 32) column groups and RG row groups
// (CG * RG blocks).  H % 4 == 0.
extern "C" int gru_backward_persistent(const void* dout, const void* mask,
                                       const void* z, const void* hprev,
                                       const void* w_t, void* dz, void* dc,
                                       void* part, void* dzc, void* bar,
                                       int res_bf16, int T, int B, int H,
                                       int CG, int RG, void* stream) {
  return gru::backward_persistent_dispatch(dout, mask, z, hprev, w_t, dz, dc,
                                           dzc, part, bar, res_bf16, T, B, H,
                                           0, CG, RG, stream);
}

// registers a thread, local (spilled) bytes a thread and shared bytes a
// block of kernel `which` (0: persistent at width H; 1, 2: the steps
// path's two kernels), f32 residuals
extern "C" int gru_backward_info(int which, int H, int* regs,
                                 int* local_bytes, int* smem_bytes) {
  return gru::backward_info(which, H, regs, local_bytes, smem_bytes);
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
