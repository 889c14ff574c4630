"""The frozen reference against the program's own plain paths, at tiny
widths on the CPU: the flax graph in fp32 (eval and train mode), the
serving graph's semantics, the training augmentation, MS-TCN, the Mamba
stack, the refiner and the streaming composition. This test may import
the program; the reference itself does not."""

import numpy as np
import pytest
import torch

import tiny
from harness import program, weights
from reference import mit, temporal
from traffic import train as train_traffic

SEED = 2**31 + 3


def _backbone(name):
    c = tiny.tiny_config(name)
    model, sd = program.backbone(c, SEED, torch.device("cpu"))
    return c, model, sd


def _frames(B, S, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, 256, (B, S, S, 3), generator=g, dtype=torch.uint8),
            torch.randint(0, 256, (B, S, S, 1), generator=g, dtype=torch.uint8),
            (torch.randn(B, S, S, 2, generator=g) * 2).half())


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("name", ["mit-b3-evp-mstcn", "mit-b0-evp-mamba"])
def test_backbone_eval_matches_flax_graph_fp32(name):
    c, model, sd = _backbone(name)
    img, seg, flow = mit.dequant(*_frames(3, 64))
    with torch.no_grad():
        want = model.graph_forward(img, seg, flow, return_features=False)
        got = mit.forward(sd, c["backbone"]["config"], c["backbone"]["head"], img, seg, flow,
                          mlp_gelu="erf", return_features=False)
        feats = model.graph_forward(img, seg, flow, return_features=True)
        got_f = mit.forward(sd, c["backbone"]["config"], c["backbone"]["head"], img, seg, flow,
                            mlp_gelu="erf")
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-5
    assert _rel(got_f, feats) < 1e-5


def test_backbone_train_mode_matches_flax_graph_fp32():
    c, model, sd = _backbone("mit-b3-evp-mstcn")
    cfg, head = c["backbone"]["config"], c["backbone"]["head"]
    B = 4
    img, seg, flow = mit.dequant(*_frames(B, 64, 1))
    g = torch.Generator().manual_seed(5)
    rates = np.linspace(0, cfg["drop_path_rate"], sum(cfg["depths"]))
    dp = [tuple((torch.rand(B, generator=g) < 1 - r).float() / (1 - r) for _ in range(2))
          for r in rates]
    masks = {"droppath": dp, "dropout": torch.rand(B, head["embedding_dim"], generator=g) >= 0.1}
    (y, ya), stats = model.graph_forward(img, seg, flow, train=True, masks=masks)
    (ry, rya), rstats = mit.forward(sd, cfg, head, img, seg, flow, mlp_gelu="erf", train=True,
                                    masks=masks, return_features=False)
    assert _rel(ry, y) < 1e-5 and _rel(rya, ya) < 1e-5
    for key, (mean, var) in stats.items():
        assert _rel(rstats[key + ".running_mean"], mean) < 1e-5
        assert _rel(rstats[key + ".running_var"], var) < 1e-5


def test_backbone_serving_graph_semantics():
    """The serving graph (bf16, the kernels' plain versions on the CPU)
    against the reference with the serving semantics: tanh MLP GELU, and
    stage 4's tanh prompt GELU at a batch that is a multiple of 8."""
    from surgical_tpu_torch.train.extract import make_raw_feature_fn

    c, model, sd = _backbone("mit-b3-evp-mstcn")
    cfg, head = c["backbone"]["config"], c["backbone"]["head"]
    for B, stage4 in ((8, "tanh"), (3, "erf")):
        wire = _frames(B, 64, B)
        got = make_raw_feature_fn(model)(*wire).float()
        with torch.no_grad():
            want = mit.forward(sd, cfg, head, *mit.dequant(*wire), mlp_gelu="tanh",
                               stage4_prompt_gelu=stage4)
        assert _rel(got, want) < 2e-2


def test_augment_matches_train_stack():
    from surgical_tpu_torch.data.transforms import AugConfig, AugParams, train_preprocess_batch

    B, R, C = 6, 72, 64
    img_u8, seg_u8, flow = _frames(B, R, 2)
    g = torch.Generator().manual_seed(9)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(B, generator=g)
    params = (torch.randint(0, R - C + 1, (B, 2), generator=g), torch.rand(B, generator=g) < 0.5,
              torch.randint(-5, 6, (B,), generator=g).float(), u(0.9, 1.1), u(0.9, 1.1),
              u(0.9, 1.1), u(-0.05, 0.05))
    want = train_preprocess_batch(img_u8.float() / 255.0, (seg_u8.float() / 255.0).expand(
        B, R, R, 3), flow.float(), cfg=AugConfig(resize=R, crop=C), params=AugParams(*params))
    got = mit.augment(img_u8, seg_u8, flow, params, C, 5)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) < 1e-5


def test_backbone_loss_matches():
    from surgical_tpu_torch.train.losses import backbone_loss

    g = torch.Generator().manual_seed(1)
    y, ya = torch.randn(5, 7, generator=g), torch.randn(5, 7, generator=g) * 3
    lab, ant = torch.randint(0, 7, (5,), generator=g), torch.rand(5, 7, generator=g) * 5
    assert torch.allclose(mit.backbone_loss(y, ya, lab, ant), backbone_loss(y, ya, lab, ant)[0])


def test_trainable_rule_matches_program():
    from surgical_tpu_torch.train.backbone import is_trainable

    _, model, sd = _backbone("mit-b3-evp-mstcn")
    for k, p in model.named_parameters():
        assert train_traffic.trainable(k) == is_trainable(k), k


def _temporal(name):
    c = tiny.tiny_config(name)
    dev = torch.device("cpu")
    tm, sd_t = program.temporal(c, SEED, dev)
    rm, sd_r = program.refiner(c, SEED, dev)
    feats = torch.randn(37, c["refiner"]["config"]["f_dim"],
                        generator=torch.Generator().manual_seed(4)).abs() * 0.5
    return c, tm, sd_t, rm, sd_r, feats


def test_mstcn_matches():
    c, tm, sd_t, _, _, feats = _temporal("mit-b3-evp-mstcn")
    with torch.no_grad():
        got = temporal.mstcn(sd_t, c["temporal"]["config"], feats)
        assert _rel(got, tm(feats[None])[:, 0]) < 1e-5


def test_mamba_matches():
    c, tm, sd_t, _, _, feats = _temporal("mit-b0-evp-mamba")
    with torch.no_grad():
        got = temporal.mamba(sd_t, c["temporal"]["config"], feats[None])
        assert _rel(got, tm(feats[None])[0]) < 1e-5


@pytest.mark.parametrize("name", ["mit-b3-evp-mstcn", "mit-b0-evp-mamba"])
def test_pipeline_matches_offline_and_streaming(name):
    from surgical_tpu_torch.serving.online import (OnlineMamba, OnlineMSTCN, OnlineRefiner,
                                                   run_pipeline)
    from surgical_tpu_torch.train.refiner import predict_video

    c, tm, sd_t, rm, sd_r, feats = _temporal(name)
    with torch.no_grad():
        want = temporal.pipeline(c["temporal"]["kind"], sd_t, c["temporal"]["config"], sd_r,
                                 c["refiner"]["config"], feats)
        assert _rel(predict_video(tm, rm, feats), want) < 1e-5
        online = OnlineMamba(tm) if c["temporal"]["kind"] == "mamba" else OnlineMSTCN(tm)
        assert _rel(run_pipeline(online, OnlineRefiner(rm), feats), want) < 1e-5


def test_weights_repeat_and_differ_by_seed():
    shapes = {"a.weight": ((4, 3), torch.float32), "a.bias": ((4,), torch.float32),
              "bn.num_batches_tracked": ((), torch.int64),
              "blocks.0.A_log": ((2, 3), torch.float32),
              "blocks.0.dt_proj.bias": ((2,), torch.float32)}
    a = weights.draw_state(shapes, 2**32 + 7, "t", "cpu")
    b = weights.draw_state(shapes, 2**32 + 7, "t", "cpu")
    c = weights.draw_state(shapes, 2**32 + 8, "t", "cpu")
    assert all(torch.equal(a[k], b[k]) for k in shapes)
    assert not torch.equal(a["a.weight"], c["a.weight"])
    assert torch.allclose(a["blocks.0.A_log"][0], torch.log(torch.tensor([1.0, 2.0, 3.0])))
    dt = torch.nn.functional.softplus(a["blocks.0.dt_proj.bias"])
    assert bool(((dt >= 1e-3 - 1e-6) & (dt <= 0.1 + 1e-6)).all())


def test_training_steps_match_in_fp32(monkeypatch):
    """The trainer's first steps computed in fp32 equal the reference's to
    round-off on every compared number: the bf16 run's gaps are precision,
    not a difference of semantics."""
    from surgical_tpu_torch.train.backbone import BackboneTrainer

    init = BackboneTrainer.__init__

    def fp32(self, *a, **k):
        init(self, *a, **dict(k, compute_dtype=torch.float32))
    monkeypatch.setattr(BackboneTrainer, "__init__", fp32)
    r = tiny.run("b3-mstcn.train")
    assert all(v < 2e-5 for _, v, _ in r["checks"]), r["checks"]
