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
// What bounds it on this card: as K4 (gru_backward.cu), 2T dependent
// launches with two row-wide f32 products a step.  One loop for both
// directions halves the layer's dependent launches (2T instead of 4T),
// each with twice the row blocks.
//
// Design: the K4 host loop and step kernels of gru_common.cuh with the row
// split of bigru_forward.cu (per-direction row blocks, none straddling the
// split), so a row's arithmetic and its order are those of a K4 call:
// K11's reverse is bit-identical to two K4 calls.

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

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
