"""Launch plans of the training block's wgmma kernels (kernels/mit_block.py):
``train_forward_plan`` (mit_block_train_forward), ``mlp_backward_plan``
(mit_block_train_mlp_backward, whose dh and dh2ln products read w2 and w1
K-major) and ``attn_backward_plan`` (mit_block_train_attn_backward: its dctx
and dxln products read wo and wq K-major, dctx's row scale on the resident
panel, and the attention grid) at every shape a MiT-b3 step at 224 px gives
them, for batches 1, 7, 8 and the trainer's 88, checked on the CPU with the
serving plans' checks: the grids cover the rows, column tiles and query
tiles once, the shared memory fits one CTA, a K wider than the resident
panel streams through the ring, and the limits raise."""

import pytest
import torch

from surgical_tpu_torch.kernels import mit_block as mb
from test_torch_serve_plan import B3, SIDES, _check_attention, _check_gemm, _check_mlp, _kv_side

torch.set_num_threads(1)  # one intra-op thread per test process: xdist workers share the CPUs

BATCHES = (1, 7, 8, 88)
STAGES = tuple(zip(B3, SIDES[224]))


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("stage", range(4))
def test_train_forward_plans_cover_b3(B, stage):
    (C, heads, sr), side = STAGES[stage]
    N, Nkv, hidden = side * side, _kv_side(side, sr) ** 2, 4 * C
    plan = mb.train_forward_plan(B, side, side, C, heads, Nkv, hidden)
    assert len(plan) == 4 * 6 + 3
    _check_gemm(plan[0:6], B * N, C, C)  # q from the given xln: no prologue
    _check_attention(plan[6:9], B, N, heads)
    _check_mlp(plan[9:27], B, side, side, C, hidden)


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("stage", range(4))
def test_mlp_backward_plans_cover_b3(B, stage):
    (C, _, _), side = STAGES[stage]
    M, hidden = B * side * side, 4 * C
    plan = mb.mlp_backward_plan(B, side, side, C, hidden)
    assert len(plan) == 3 * 6
    _check_gemm(plan[0:6], M, hidden, C)    # a1 = h2ln w1 + b1
    _check_gemm(plan[6:12], M, hidden, C)   # dh = dmlp w2^T
    _check_gemm(plan[12:18], M, C, hidden)  # dh2ln = da1 w1^T: K = hidden
    assert plan[13] == (hidden <= mb.PANEL_MAX_K)


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("stage", range(4))
def test_attn_backward_plans_cover_b3(B, stage):
    (C, heads, sr), side = STAGES[stage]
    N, Nkv = side * side, _kv_side(side, sr) ** 2
    plan = mb.attn_backward_plan(B, N, C, heads, Nkv)
    assert len(plan) == 3 * 6 + 6 and plan[21:24] == (0, 0, 0)  # 49 keys: no dq kernel
    _check_gemm(plan[6:12], B * N, C, C, ln=True)   # dctx: row scale on the resident panel
    assert plan[7] == 1  # K = C <= PANEL_MAX_K: the panel the row scale rewrites
    for rec in (plan[0:6], plan[12:18]):  # q = xln wq + bq, dxln = dq wq^T
        if C < mb.ABW_STREAM_MIN_K:
            _check_gemm(rec, B * N, C, C)
        else:  # A streamed, one 64-column tile per CTA
            bn, resident, tpc, gx, gy, smem = rec
            assert (bn, resident, tpc) == (64, 0, 1) and gy == -(-C // 64)
            assert (gx - 1) * mb.GEMM_BM < B * N <= gx * mb.GEMM_BM
            assert smem == mb.gemm_smem_bytes(C, 64, False) <= mb.SMEM_LIMIT // 2 - 1024
    # every (image, head, 64-row tile) in exactly one CTA; splits within bounds
    tpc, gx, gy = plan[18:21]
    _check_attention((tpc, gx, gy), B, N, heads)
    assert 1 <= gx <= mb.ABW_MAX_SPLITS
    covered = sorted(t for cx in range(gx) for t in range(cx * tpc, min((cx + 1) * tpc,
                                                                     -(-N // mb.ATTN_ROWS))))
    assert covered == list(range(-(-N // mb.ATTN_ROWS)))


def test_attn_backward_splits_only_long_images():
    """At the training batch the images of stages 3 and 4 fill the card
    whole, so one CTA holds all rows of its (image, head) and writes dk, dv
    itself (4 launches); stages 1-2 split their rows and reduce (5)."""
    splits = [mb.attn_backward_plan(88, side * side, C, heads, 49)[19]
              for (C, heads, _), side in STAGES]
    assert splits[2:] == [1, 1] and all(s > 1 for s in splits[:2])


@pytest.mark.parametrize("hidden", (256, 512, 1024, 1280, 2048))
def test_kmajor_products_stream_wide_k(hidden):
    """dh2ln's K = hidden up to b3's 2048: above the panel width A streams
    through the ring, in the same shared memory at every K."""
    C, M = hidden // 4, 88 * 49
    bn, resident, _, _, _, smem = mb.mlp_backward_plan(88, 7, 7, C, hidden)[12:18]
    assert resident == (hidden <= mb.PANEL_MAX_K)
    if not resident:
        assert smem == mb.gemm_smem_bytes(4096, bn, False) <= mb.SMEM_LIMIT
    _check_gemm(mb.gemm_plan(M, C, hidden), M, C, hidden)


@pytest.mark.parametrize("call", [
    lambda: mb.mlp_backward_plan(8, 7, 7, 512, 2044),          # hidden not a multiple of 8
    lambda: mb.mlp_backward_plan(8, 7, 7, 516, 2048),          # C not a multiple of 8
    lambda: mb.mlp_backward_plan(0, 7, 7, 512, 2048),          # no rows
    lambda: mb.train_forward_plan(8, 7, 7, 576, 9, 49, 2304),  # LN2 panel wider than 512
    lambda: mb.train_forward_plan(8, 14, 14, 320, 5, 0, 1280),  # no key
    lambda: mb.attn_backward_plan(8, 196, 320, 20, 49),         # head dim 16
    lambda: mb.attn_backward_plan(8, 196, 320, 4, 49),          # head dim not 32 or 64
    lambda: mb.attn_backward_plan(0, 196, 320, 5, 49),          # no images
    lambda: mb.attn_backward_plan(8, 49, 576, 9, 49),           # panel wider than 512
])
def test_train_plan_limits_raise(call):
    with pytest.raises(ValueError):
        call()
