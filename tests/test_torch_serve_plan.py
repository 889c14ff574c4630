"""Launch plans of the serving MiT kernels (kernels/mit_block.py): every
shape the extraction path gives mit_block_forward and mit_stage_forward
(MiT-b3 at 224 and 250 px, the CLI's batch sizes and ragged last batches),
checked on the CPU: the grids cover the rows, columns and query tiles
exactly once, the shared memory fits one CTA, and the limits raise."""

import pytest

from surgical_tpu_torch.kernels import mit_block as mb

# b3: (C, heads, sr) per stage; grid sides at 224 and 250 px
B3 = ((64, 1, 8), (128, 2, 4), (320, 5, 2), (512, 8, 1))
SIDES = {224: (56, 28, 14, 7), 250: (63, 32, 16, 8)}
BATCHES = (1, 7, 8, 200)
PROMPT = 128  # b3 stage 4's prompt base and lightweight-MLP widths


def _kv_side(side, sr):
    return (side - sr) // sr + 1  # the stride-sr SR conv


def _check_gemm(rec, M, N, K, ln=False):
    bn, resident, tpc, gx, gy, smem = rec
    assert bn in (64, 128) and (bn == 64) == (N <= 64)
    assert (gx - 1) * mb.GEMM_BM < M <= gx * mb.GEMM_BM  # every row block once
    ntiles = -(-N // bn)
    assert tpc >= 1 and (gy - 1) * tpc < ntiles <= gy * tpc  # every column tile once
    assert resident == (K <= mb.PANEL_MAX_K) and (resident or not ln)
    assert smem == mb.gemm_smem_bytes(K, bn, bool(resident)) <= mb.SMEM_LIMIT


def _check_mlp(rec, B, H, W, C, hidden):
    M = B * H * W
    _check_gemm(rec[0:6], M, C, C)
    _check_gemm(rec[6:12], M, hidden, C, ln=True)
    _check_gemm(rec[12:18], M, C, hidden)


def _check_attention(rec, B, N, heads):
    tpc, gx, gy = rec
    qtiles = -(-N // mb.ATTN_ROWS)
    assert gy == B * heads and tpc >= 1 and (gx - 1) * tpc < qtiles <= gx * tpc


@pytest.mark.parametrize("px", sorted(SIDES))
@pytest.mark.parametrize("B", BATCHES)
def test_block_plans_cover_b3(px, B):
    for (C, heads, sr), side in list(zip(B3, SIDES[px]))[:3]:
        N, Nkv, hidden = side * side, _kv_side(side, sr) ** 2, 4 * C
        assert Nkv <= mb.MAX_KV
        plan = mb.block_plan(B, side, side, C, heads, Nkv, hidden)
        assert len(plan) == 4 * 6 + 3
        _check_gemm(plan[0:6], B * N, C, C, ln=True)
        _check_attention(plan[6:9], B, N, heads)
        _check_mlp(plan[9:27], B, side, side, C, hidden)


@pytest.mark.parametrize("px", sorted(SIDES))
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("prompt", (True, False))
def test_stage_plans_cover_b3(px, B, prompt):
    (C, heads, sr), side = B3[3], SIDES[px][3]
    N = side * side  # 49 or 64 keys: sr = 1
    Cb = C4 = PROMPT if prompt else 0
    plan = mb.stage_plan(B, side, side, C, heads, sr, 4 * C, Cb, C4)
    assert len(plan) == 8 * 6 + 3
    M = B * N
    if prompt:
        _check_gemm(plan[0:6], M, C4, Cb)
        _check_gemm(plan[6:12], M, C, C4)
    else:
        assert plan[0:12] == (0,) * 12
    assert plan[12:18] == (0,) * 6  # no SR product at sr = 1
    _check_gemm(plan[18:24], M, 2 * C, C)
    _check_gemm(plan[24:30], M, C, C)
    _check_attention(plan[30:33], B, N, heads)
    _check_mlp(plan[33:51], B, side, side, C, 4 * C)


def test_stage_plan_with_spatial_reduction():
    B, side, C, heads, sr = 7, 28, 128, 2, 4
    plan = mb.stage_plan(B, side, side, C, heads, sr, 4 * C)
    Mkv = B * (side // sr) ** 2
    _check_gemm(plan[12:18], Mkv, C, sr * sr * C)  # K = 2048 streams its A tiles
    assert plan[13] == 0
    _check_gemm(plan[18:24], Mkv, 2 * C, C)


def test_small_panels_leave_room_for_more_ctas():
    # K = 64: panel and ring take ~50 KB, so several CTAs share an SM
    assert mb.gemm_plan(200 * 3136, 64, 64, ln=True)[5] < mb.SMEM_LIMIT // 4
    # the widest LN panel still fits one CTA beside its ring
    assert mb.gemm_plan(200 * 49, 2048, 512, ln=True)[5] <= mb.SMEM_LIMIT


def test_small_grids_split_column_tiles():
    # stage 4 at B = 8: 4 row blocks, so the 16 fc1 tiles spread over CTAs
    bn, _, tpc, gx, gy, _ = mb.gemm_plan(8 * 49, 2048, 512, ln=True)
    assert (bn, gx) == (128, 4) and gx * gy >= 2 * 4 and tpc * gy >= 16
    # stage 1 at B = 200: 4900 row blocks, one CTA per row block
    assert mb.gemm_plan(200 * 3136, 64, 64, ln=True)[2:5] == (1, 4900, 1)


@pytest.mark.parametrize("call", [
    lambda: mb.gemm_plan(1000, 512, 520, ln=True),    # LN panel wider than PANEL_MAX_K
    lambda: mb.gemm_plan(1000, 100, 64),              # N not a multiple of 8
    lambda: mb.gemm_plan(1000, 64, 60),               # K not a multiple of 8
    lambda: mb.gemm_plan(0, 64, 64),                  # no rows
    lambda: mb.attention_plan(8, 196, 5, 65),          # more keys than MAX_KV
    lambda: mb.attention_plan(8192, 49, 8, 49),       # more (image, head) pairs than a grid row
])
def test_plan_limits_raise(call):
    with pytest.raises(ValueError):
        call()
