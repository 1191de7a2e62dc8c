// Bidirectional GRU backward time loop (the reverse recurrence of both
// directions in one loop) for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas_kernels.py::_gru_bwd_pallas_raw with
// batch_split=B (the _gru_bwd_kernel body, its split product at :568-575),
// which ops/rnn_fused.py::bigru_sequence_fused's backward reaches.
//
// Computes the reverse GRU step of gru_common.cuh over the stacked batch
// of 2B rows that bigru_forward.cu wrote: from the residuals z [T, 2B, 3H]
// and h_prev [T, 2B, H], the cotangents d_out [T, 2B, H] and d_hfin
// [2B, H], it returns d_z [T, 2B, 3H] (= d_xp) and d_h0 [2B, H].  Rows
// [0, B) use direction 0's transposed weight, rows [B, 2B) direction 1's.
// The weight is read as the reference lays it out: both directions'
// transposed weights stacked on columns, w_t [3H, 2H] f32 (direction 0 in
// columns [0, H), direction 1 in [H, 2H)), each read with row stride 2H.
//
// What bounds it on this card: as K4 (gru_backward.cu), two row-wide f32
// products a step over twice the rows (0.58 ms of f32 FMA time at 2 x 384
// rows, H = 512), each needing the whole row of the step before.
//
// Design: K4's two kernels of gru_common.cuh, picked by the same function
// of (rows a direction, H, SM count) (ops/kernels/gru.py::_gru_bwd_path):
// "persistent", ONE cooperative launch whose blocks each serve one
// direction (2 x 16 column groups x 4 row groups = 128 blocks at 2 x 384
// rows, H = 512), each holding its direction's w_t slice; or "steps", the
// host loop with per-direction row blocks.  Either way each row meets the
// arithmetic of a K4 call, in the same order (the plan's column groups,
// row tiles and k order depend on H alone), so K11's reverse is
// bit-identical to two K4 calls on the same path.

#include "gru_common.cuh"

// dout [T, 2B, H] f32, mask [T, 2B] f32, z [T, 2B, 3H] and hprev
// [T, 2B, H] in the residual type (res_bf16 != 0: bfloat16, else float32),
// w_t [3H, 2H] f32 (the column-stacked transposed weights), dz
// [T, 2B, 3H] f32 out, dc [2B, H] f32 in: d_hfin, out: d_h0, part [2B, H]
// f32 scratch; B2 = 2B rows, split = B.  Returns a cudaError_t.
extern "C" int bigru_backward(const void* dout, const void* mask,
                              const void* z, const void* hprev,
                              const void* w_t, void* dz, void* dc, void* part,
                              int res_bf16, int T, int B2, int H, int split,
                              void* stream) {
  if (split <= 0) return (int)cudaErrorInvalidValue;
  return gru::backward_dispatch(dout, mask, z, hprev, w_t, dz, dc, part,
                                res_bf16, T, B2, H, split, stream);
}

// The persistent kernel: the same arguments as bigru_backward, then dzc
// [2B, H] f32 scratch, bar [1] u32 zeroed, and the plan's CG = ceil(H / 32)
// column groups and RG row groups a direction (2 * CG * RG blocks).
extern "C" int bigru_backward_persistent(const void* dout, const void* mask,
                                         const void* z, const void* hprev,
                                         const void* w_t, void* dz, void* dc,
                                         void* part, void* dzc, void* bar,
                                         int res_bf16, int T, int B2, int H,
                                         int split, int CG, int RG,
                                         void* stream) {
  if (split <= 0) return (int)cudaErrorInvalidValue;
  return gru::backward_persistent_dispatch(dout, mask, z, hprev, w_t, dz, dc,
                                           dzc, part, bar, res_bf16, T, B2,
                                           H, split, CG, RG, stream);
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
