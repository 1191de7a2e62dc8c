"""The split plans and path pickers of the persistent GRU forward kernel
(K3 and K3r, and K11's forward with two directions), the persistent GRU
reverse kernel (K4, and K11's reverse) and the persistent attention
decoder forward (K5): pure functions of the shapes and the SM count, so
they are held here on the CPU; the kernels themselves are held on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import pytest
import torch

from paddle_tpu_torch.ops.kernels.attention_decoder import (
    MAX_S, _attn_dec_fwd_path, _attn_dec_fwd_plan, _attn_dec_fwd_slices,
    _attn_dec_fwd_smem)
from paddle_tpu_torch.ops.kernels.gru import (_gru_bwd_path, _gru_bwd_plan,
                                              _gru_bwd_slices, _gru_fwd_path,
                                              _gru_fwd_plan, _gru_fwd_slices,
                                              _gru_fwd_smem)

SMS = 132          # an H100 SXM
SMEM = 232448      # shared bytes a block may take on it


@pytest.mark.parametrize("B,H,ndir", [(384, 512, 1), (384, 512, 2),
                                      (64, 512, 1), (64, 512, 2), (1, 512, 1),
                                      (37, 96, 1), (5, 32, 2), (33, 128, 2),
                                      (1024, 1024, 2), (1024, 256, 1)])
def test_gru_fwd_split_covers_w_and_the_rows_once(B, H, ndir):
    """Within each (direction, row group), the unit groups cut [0, H) into
    disjoint 16-unit ranges, each block holding the r, u and c columns of
    its units over the full depth H, so every column of a direction's W
    [H, 3H] is held once; every row of a direction lies in exactly one row
    group; the plan does not depend on B, and a block's rows of carry fit
    its shared memory at any B up to the limit."""
    plan = _gru_fwd_plan(B, H, SMS, ndir)
    assert plan == _gru_fwd_plan(1, H, SMS, ndir)
    assert plan["blocks"] == ndir * plan["ug"] * plan["rg"] <= SMS
    assert plan["ug"] == H // 16 and plan["nu"] == 16
    assert _gru_fwd_smem(H, B, plan["rg"]) <= plan["smem"] <= SMEM
    slices = _gru_fwd_slices(plan, H, B, ndir)
    per_dir = plan["ug"] * plan["rg"]
    for d in range(ndir):
        rows = []
        for g in range(plan["rg"]):
            group = [s for i, s in enumerate(slices)
                     if s[0] == d and i % per_dir // plan["ug"] == g]
            assert len(group) == plan["ug"]
            cols = sorted(c for _, cs, _ in group for c in cs)
            assert cols == list(range(3 * H))
            assert all(s[2] == group[0][2] for s in group)
            rows += group[0][2]
        assert sorted(rows) == list(range(B))


def test_gru_fwd_plan_at_the_flagship_shapes():
    """The default training step's K3r (B = 384), the fused_bigru step's
    K11r (2 x 384 rows), a serve prefill's K3 and K11 (64 and 2 x 64 rows)
    and a solo decode's (1 row) take the persistent kernel under bf16 on
    the same blocks: 32 unit groups of 16 units (49,152 bytes of bf16 W a
    block) x 4 row groups = 128 blocks, or x 2 a direction for K11."""
    one = {"nu": 16, "ug": 32, "rg": 4, "blocks": 128, "smem": 81920}
    two = {"nu": 16, "ug": 32, "rg": 2, "blocks": 128, "smem": 114688}
    for B in (384, 64, 1):
        assert _gru_fwd_plan(B, 512, SMS) == one
        assert _gru_fwd_plan(B, 512, SMS, 2) == two
        for ndir in (1, 2):
            assert _gru_fwd_path(torch.bfloat16, B, 512, SMS,
                                 ndir) == "persistent"
            assert _gru_fwd_path(torch.float32, B, 512, SMS, ndir) == "steps"
    # shared bytes a block takes at these batches: W's fragments and 128
    # bytes a row of carry (6 tiles at B = 384, 12 a block for K11)
    assert _gru_fwd_smem(512, 384, 4) == 49152 + 128 * 96
    assert _gru_fwd_smem(512, 384, 2) == 49152 + 128 * 192
    assert _gru_fwd_smem(512, 1, 4) == 49152 + 128 * 16


@pytest.mark.parametrize("dt,B,H,sms,ndir,want", [
    (torch.bfloat16, 384, 512, SMS, 1, "persistent"),
    (torch.bfloat16, 384, 512, SMS, 2, "persistent"),
    (torch.bfloat16, 1024, 512, SMS, 2, "persistent"),
    (torch.bfloat16, 1024, 1024, SMS, 2, "persistent"),   # rg = 1
    (torch.float32, 384, 512, SMS, 1, "steps"),           # the f32 policy
    (torch.float32, 1, 32, SMS, 2, "steps"),
    (torch.bfloat16, 1025, 512, SMS, 1, "steps"),         # past the rows
    (torch.bfloat16, 0, 512, SMS, 1, "steps"),
    (torch.bfloat16, 5, 40, SMS, 1, "steps"),             # H % 32
    (torch.bfloat16, 5, 16, SMS, 2, "steps"),
    (torch.bfloat16, 384, 1088, SMS, 1, "steps"),         # shared bytes
    (torch.bfloat16, 384, 1056, SMS, 2, "persistent"),    # at the limit
    (torch.bfloat16, 384, 1088, SMS, 2, "steps"),         # SMs < 2 ug
    (torch.bfloat16, 384, 512, 31, 1, "steps"),           # SMs < ug
    (torch.bfloat16, 384, 512, 32, 1, "persistent")])
def test_gru_fwd_path_is_a_function_of_dtype_shape_and_sm_count(dt, B, H,
                                                                sms, ndir,
                                                                want):
    assert _gru_fwd_path(dt, B, H, sms, ndir) == want


@pytest.mark.parametrize("B,H,ndir", [(384, 512, 1), (384, 512, 2),
                                      (37, 512, 1), (5, 40, 1), (3, 16, 2),
                                      (33, 96, 2), (1024, 256, 1)])
def test_gru_bwd_split_covers_w_t_and_the_rows_once(B, H, ndir):
    """Within each (direction, row group), the column groups cut [0, H)
    into disjoint 32-wide ranges, each block holding its columns over the
    full depth 3H, so every (k, column) of a direction's w_t is held once;
    every row of a direction lies in exactly one row group; the plan does
    not depend on B."""
    plan = _gru_bwd_plan(B, H, SMS, ndir)
    assert plan == _gru_bwd_plan(1, H, SMS, ndir)
    assert plan["blocks"] == ndir * plan["cg"] * plan["rg"] <= SMS
    assert plan["cg"] == -(-H // 32) and plan["cw"] == 32
    assert plan["smem"] <= SMEM
    slices = _gru_bwd_slices(plan, H, B, ndir)
    for d in range(ndir):
        rows = []
        for g in range(plan["rg"]):
            held = torch.zeros(3 * H, H, dtype=torch.int32)
            group = [s for i, s in enumerate(slices)
                     if s[0] == d and i % (plan["cg"] * plan["rg"])
                     // plan["cg"] == g]
            assert len(group) == plan["cg"]
            for _, ks, cs, mine in group:
                assert len(cs) <= 32 and ks == range(3 * H)
                held[ks.start:ks.stop, cs.start:cs.stop] += 1
                assert mine == group[0][3]
            assert bool((held == 1).all())
            rows += group[0][3]
        assert sorted(rows) == list(range(B))


def test_gru_bwd_plan_at_the_flagship_shapes():
    """The default training step's K4 (B = 384, H = 512) and the
    fused_bigru step's K11 reverse (2 x 384 rows) take the persistent
    kernel: 16 column groups of 32 columns (196,608 bytes of f32 w_t a
    block) x 8 or 4 row groups = 128 blocks."""
    assert _gru_bwd_plan(384, 512, SMS) == {
        "cw": 32, "cg": 16, "rg": 8, "blocks": 128, "smem": 229376}
    assert _gru_bwd_plan(384, 512, SMS, 2) == {
        "cw": 32, "cg": 16, "rg": 4, "blocks": 128, "smem": 229376}
    assert _gru_bwd_path(384, 512, SMS) == "persistent"
    assert _gru_bwd_path(384, 512, SMS, 2) == "persistent"


@pytest.mark.parametrize("B,H,sms,ndir,want", [
    (384, 512, SMS, 1, "persistent"), (384, 512, SMS, 2, "persistent"),
    (1, 4, 1, 1, "persistent"), (1024, 512, SMS, 2, "persistent"),
    (1025, 512, SMS, 1, "steps"),      # past the row limit
    (0, 512, SMS, 1, "steps"),
    (384, 516, SMS, 1, "steps"),       # the w_t slice no longer fits
    (384, 42, SMS, 1, "steps"),        # rows not in 16-byte pieces
    (384, 512, 31, 2, "steps"),        # fewer SMs than column groups
    (384, 512, 16, 1, "persistent")])
def test_gru_bwd_path_is_a_function_of_shape_and_sm_count(B, H, sms, ndir,
                                                          want):
    assert _gru_bwd_path(B, H, sms, ndir) == want


@pytest.mark.parametrize("B,S,D,A,H2", [(384, 32, 512, 512, 1024),
                                        (37, 17, 128, 128, 256),
                                        (3, 7, 32, 32, 64),
                                        (40, 5, 64, 128, 96),
                                        (512, 32, 512, 512, 1024)])
def test_attn_dec_fwd_split_covers_the_weights_and_rows_once(B, S, D, A,
                                                             H2):
    """Within each row group the column groups cut the D units (each with
    its r, u and c columns of wh and wx_c) and the A query columns of
    att_w into disjoint whole n8 tiles, so every weight column is held
    once; every batch row lies in one row group, its tile owned by one
    warp; the plan does not depend on B."""
    plan = _attn_dec_fwd_plan(B, S, D, A, H2, SMS)
    assert plan == _attn_dec_fwd_plan(1, S, D, A, H2, SMS)
    assert plan["blocks"] == plan["cg"] * plan["rg"] <= SMS
    assert plan["nu"] in (8, 16) and plan["qc"] in (8, 16)
    assert plan["smem"] == _attn_dec_fwd_smem(S, D, A, H2, plan["nu"],
                                              plan["qc"]) <= SMEM
    slices = _attn_dec_fwd_slices(plan, B, D)
    rows = []
    for g in range(plan["rg"]):
        group = slices[g * plan["cg"]:(g + 1) * plan["cg"]]
        units = sorted(u for s in group for u in s[0])
        qcols = sorted(c for s in group for c in s[1])
        assert units == list(range(D)) and qcols == list(range(A))
        assert all(s[2] == group[0][2] for s in group)
        assert len(group[0][2]) <= 8 * 16
        rows += group[0][2]
    assert sorted(rows) == list(range(B))


def test_attn_dec_fwd_plan_at_the_flagship_shape():
    """The training decoder (B = 384, S = 32, D = A = 512, 2H = 1024) takes
    the persistent kernel under bf16: 32 column groups of 16 units and 16
    query columns (163,840 bytes of bf16 weights a block) x 4 row groups,
    each warp one 16-row tile; under f32 it keeps the steps kernels."""
    assert _attn_dec_fwd_plan(384, 32, 512, 512, 1024, SMS) == {
        "cg": 32, "rg": 4, "nu": 16, "qc": 16, "blocks": 128,
        "smem": 174592}
    assert _attn_dec_fwd_path(torch.bfloat16, 384, 32, 512, 512, 1024,
                              SMS) == "persistent"
    assert _attn_dec_fwd_path(torch.float32, 384, 32, 512, 512, 1024,
                              SMS) == "steps"


@pytest.mark.parametrize("dt,B,S,D,A,H2,sms,want", [
    (torch.bfloat16, 384, 32, 512, 512, 1024, SMS, "persistent"),
    (torch.bfloat16, 512, 32, 512, 512, 1024, SMS, "persistent"),
    (torch.bfloat16, 513, 32, 512, 512, 1024, SMS, "steps"),   # > 128 rg
    # at S = MAX_S the scores take 64 KB: 8 units a block, 2 row groups
    (torch.bfloat16, 256, MAX_S, 512, 512, 1024, SMS, "persistent"),
    (torch.bfloat16, 384, MAX_S, 512, 512, 1024, SMS, "steps"),
    (torch.bfloat16, 256, MAX_S + 1, 512, 512, 1024, SMS, "steps"),
    (torch.bfloat16, 33, 17, 96, 80, 160, SMS, "steps"),  # A / cg not 8, 16
    (torch.bfloat16, 8, 5, 8, 7, 10, SMS, "steps"),       # D % 32
    (torch.bfloat16, 8, 5, 512, 512, 1000, SMS, "steps"),  # 2H % 32
    (torch.bfloat16, 8, 5, 1024, 1024, 2048, SMS, "persistent"),  # nu 8
    (torch.bfloat16, 8, 5, 2048, 2048, 4096, SMS, "steps"),  # cg > SMs
    (torch.bfloat16, 384, 32, 512, 512, 1024, 31, "steps"),  # SMs < cg
    (torch.float32, 37, 17, 128, 128, 256, SMS, "steps")])
def test_attn_dec_fwd_path_is_a_function_of_shape_and_sm_count(
        dt, B, S, D, A, H2, sms, want):
    assert _attn_dec_fwd_path(dt, B, S, D, A, H2, sms) == want
