"""The frozen work counts and the reference's FLOP count."""

import torch
import torch.nn.functional as F

from harness import program, trace
from reference import work
from traffic import extract, stream, train
from harness import files


def test_block_work_by_hand():
    B, N, C, Nkv, hidden = 2, 16, 8, 4, 32
    # q, out: 2 GEMMs of 2*C*C; fc1, fc2: 2 of 2*C*hidden; QK^T, PV: 2 of 2*Nkv*C;
    # dwconv: 9 taps * 2 per hidden
    flops = B * N * (2 * 2 * C * C + 2 * 2 * C * hidden + 2 * 2 * Nkv * C + 2 * 9 * hidden)
    weights = 2 * C * C + 2 * C * hidden + 9 * hidden + 2 * hidden + 7 * C
    nbytes = 2 * (B * N * C + B * N * C + 2 * B * Nkv * C + weights)
    assert work.block_work(B, N, C, Nkv, hidden) == (nbytes, flops)


def test_stage_work_by_hand():
    B, N, C, hidden, depth, Cb, C4 = 2, 4, 8, 32, 3, 4, 4
    per_block = B * N * (2 * Cb * C4 + 2 * C4 * C + 2 * 2 * C * C)
    _, blk = work.block_work(B, N, C, N, hidden)
    assert work.stage_work(B, N, C, hidden, depth, Cb, C4)[1] == depth * (per_block + blk)
    w = depth * (2 * C * C + 2 * C * hidden + 11 * hidden + 7 * C + 2 * C * C + 2 * C
                 + Cb * C4 + C4) + C4 * C + C
    nbytes = 2 * (2 * B * N * C + B * N * Cb + w)
    assert work.stage_work(B, N, C, hidden, depth, Cb, C4)[0] == nbytes


def test_scan_work_by_hand():
    Bt, T, D, N = 1, 100, 128, 64
    nbytes, op_s = work.scan_work(Bt, T, D, N)
    assert nbytes == 4 * (3 * T * D + 2 * T * N + D * N + D)
    elems = T * D * N
    assert op_s == max(5 * elems / 67e12, elems / (132 * 16 * 1.98e9))
    assert work.bound_s(nbytes, op_s) == max(nbytes / 3.35e12, op_s)


def test_count_flops_by_hand():
    x, w = torch.empty(5, 3, device="meta"), torch.empty(4, 3, device="meta")
    assert work.count_flops(F.linear, x, w) == 2 * 5 * 3 * 4


def _meta_backbone(name):
    c = files.config(name)
    with torch.device("meta"):
        m = files.resolve(c["backbone"]["constructor"])(
            program.make_config(c["backbone"]), program.make_config(c["backbone"], "head",
                                                                    "head_class"),
            device="meta")
    return c, m.state_dict()


def test_flop_count_is_stable():
    """The b0 frame's count repeats exactly and sits where the block shapes
    put it; the training step counts more than twice the forward (the
    trunk's activations are differentiated, not its weights)."""
    c, sd = _meta_backbone("mit-b0-evp-mamba")
    a = extract.backbone_flops(c, sd, 224)
    assert a == extract.backbone_flops(c, sd, 224)
    assert 2.5e9 < a < 3.5e9
    t = train.train_flops(c, sd, 224)
    assert t == train.train_flops(c, sd, 224) and 2 * a < t < 3 * a


def test_temporal_flops_is_per_frame():
    c = files.config("mit-b0-evp-mamba")
    shapes = {}
    for part in ("temporal", "refiner"):
        with torch.device("meta"):
            m = files.resolve(c[part]["constructor"])(program.make_config(c[part]), device="meta")
        shapes[part] = m.state_dict()
    per_64 = stream.temporal_flops(c, shapes["temporal"], shapes["refiner"], T=64)
    assert per_64 == stream.temporal_flops(c, shapes["temporal"], shapes["refiner"], T=128)


def test_kernel_entry_bounds():
    """The spans' least time of a block and a stage call from its
    arguments, as the frozen counts give it."""
    x = torch.empty(2, 16, 8)
    k = torch.empty(2, 4, 8)
    w = {"w1": torch.empty(8, 32)}
    assert trace._block_bound(x, k, k, w, heads=1, H=4, W=4) == work.bound_s(
        work.block_work(2, 16, 8, 4, 32)[0], work.block_work(2, 16, 8, 4, 32)[1] / 989e12)
    sw = {"wq": torch.empty(3, 8, 8), "w1": torch.empty(3, 8, 32), "lww": torch.empty(3, 4, 4)}
    nb, fl = work.stage_work(2, 16, 8, 32, 3, 4, 4)
    assert trace._stage_bound(x, torch.empty(2, 16, 4), sw, heads=1, H=4, W=4, sr=1) == \
        work.bound_s(nb, fl / 989e12)
