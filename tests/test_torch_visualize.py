"""The port's visualization (``surgical_tpu_torch/eval/visualize.py``) and
``cli evaluate --vis`` against the JAX package's, on the CPU.

Stated bounds: the three plots and both CLIs' ribbon PNGs decode to equal
pixels (the same matplotlib code on the same inputs); ``capture_attention``
at the tiny config of tests/test_torch_mit_graph.py equals JAX's
``capture_attention`` key for key within atol 1e-5 (fp32, the attention
probabilities of every block). ``evaluate`` without ``--vis`` does not
import matplotlib.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from surgical_tpu import cli as jax_cli
from surgical_tpu.eval import visualize as jvis
from surgical_tpu.eval.predictions import video_txt_name, write_phase_txt
from surgical_tpu.models import mit_evp as jme
from surgical_tpu_torch import cli
from surgical_tpu_torch.eval import visualize as pvis
from test_torch_mit_graph import HEAD, inputs, jax_variables, port_model, tiny

torch.set_num_threads(1)  # one intra-op thread per test process: xdist workers share the CPUs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pixels(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


def _same_png(a, b):
    pa, pb = _pixels(a), _pixels(b)
    assert pa.shape == pb.shape, (a, b)
    np.testing.assert_array_equal(pa, pb, err_msg=f"{a} vs {b}")


def test_plots_equal_jax_pixels(tmp_path):
    rng = np.random.default_rng(0)
    gt, pred = np.sort(rng.integers(0, 7, 300)), np.sort(rng.integers(0, 7, 300))
    ant_gt, ant_pred = rng.uniform(0, 1, (120, 7)), rng.uniform(0, 1, (120, 7))
    image = rng.uniform(0, 1, (56, 56, 3))
    attn = rng.uniform(0, 1, (2, 3, 49, 49)).astype(np.float32)
    for pkg in ("jax", "port"):
        vis = jvis if pkg == "jax" else pvis
        d = tmp_path / pkg
        d.mkdir()
        vis.plot_ribbon(gt, pred, "video41", str(d / "ribbon.png"))
        vis.plot_anticipation(str(d / "ant.png"), ant_gt, ant_pred)
        vis.plot_anticipation(str(d / "ant_gt.png"), ant_gt)
        vis.attention_overlay(image, attn, (7, 7), str(d / "attn.png"))
        vis.attention_overlay(image, attn[0], (7, 7), str(d / "attn_h1.png"), head=1)
    for name in ("ribbon.png", "ant.png", "ant_gt.png", "attn.png", "attn_h1.png"):
        _same_png(tmp_path / "jax" / name, tmp_path / "port" / name)
    assert not np.array_equal(_pixels(tmp_path / "port" / "attn.png"),
                              _pixels(tmp_path / "port" / "attn_h1.png"))


def test_evaluate_vis_equals_jax(tmp_path, capsys):
    """Both CLIs on the same txts: the same PNG set, equal pixels; the
    ground truth and the prediction cut to the shorter length."""
    rng = np.random.default_rng(1)
    gt_dir, pred_dir = tmp_path / "gt", tmp_path / "pred"
    for vid, (n_gt, n_pred) in zip((41, 42), ((90, 90), (120, 100))):
        write_phase_txt(str(gt_dir / video_txt_name(vid)), np.sort(rng.integers(0, 7, n_gt)))
        write_phase_txt(str(pred_dir / video_txt_name(vid)), np.sort(rng.integers(0, 7, n_pred)))
    args = ["evaluate", "--gt", str(gt_dir), "--pred", str(pred_dir), "--first", "41",
            "--last", "42", "--vis"]
    assert jax_cli.main(args + [str(tmp_path / "jax_vis")]) == 0
    want_out = capsys.readouterr().out
    assert cli.main(args + [str(tmp_path / "port_vis" / "nested")]) == 0
    assert capsys.readouterr().out == want_out
    names = sorted(os.listdir(tmp_path / "jax_vis"))
    assert names == ["video41_vis.png", "video42_vis.png"]
    assert sorted(os.listdir(tmp_path / "port_vis" / "nested")) == names
    for n in names:
        _same_png(tmp_path / "jax_vis" / n, tmp_path / "port_vis" / "nested" / n)
    helps = []
    for main in (jax_cli.main, cli.main):
        with pytest.raises(SystemExit):
            main(["evaluate", "--help"])
        helps.append(capsys.readouterr().out)
    assert "directory for GT/pred ribbon PNGs" in helps[1]
    assert helps[0].split("--vis")[1].split("\n")[0] == helps[1].split("--vis")[1].split("\n")[0]


def test_evaluate_without_vis_imports_no_matplotlib(tmp_path):
    gt_dir = tmp_path / "gt"
    write_phase_txt(str(gt_dir / video_txt_name(41)), np.zeros(30, np.int64))
    code = ("import sys; from surgical_tpu_torch import cli; "
            f"rc = cli.main(['evaluate', '--gt', {str(gt_dir)!r}, '--pred', {str(gt_dir)!r}, "
            "'--first', '41', '--last', '41']); "
            "assert rc == 0, rc; assert 'matplotlib' not in sys.modules; print('ok')")
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr


class _Jitted:
    """A flax module whose ``apply`` (with ``mutable=["intermediates"]``,
    the one call ``capture_attention`` makes) runs under ``jax.jit``: an
    eager apply dispatches op by op and takes several times as long here."""

    def __init__(self, module):
        self._apply = jax.jit(lambda v, i, s, f: module.apply(v, i, s, f,
                                                              mutable=["intermediates"]))

    def apply(self, variables, images, segmaps, flow, mutable):
        assert mutable == ["intermediates"]
        return self._apply(variables, images, segmaps, flow)


def test_capture_attention_matches_jax():
    cfg = tiny(with_flow=True)
    variables = jax_variables(cfg, HEAD, 3)
    img, seg, flow = inputs(cfg, 3)
    want_out, want = jvis.capture_attention(_Jitted(jme.MiTEVP(cfg, HEAD, capture_attn=True)),
                                            variables, img, seg, flow)
    model = port_model(cfg, HEAD, variables)
    got_out, got = pvis.capture_attention(model, img, seg, flow)
    assert sorted(got) == sorted(want)
    assert sorted(got) == sorted(f"block{s}_{d}/attn/attn" for s in range(1, 5)
                                 for d in range(cfg.depths[s - 1]))
    for name, w in want.items():
        assert got[name].dtype == np.float32 and got[name].shape == w.shape
        np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-5, err_msg=name)
    for g, w in zip(got_out, want_out):
        assert isinstance(g, torch.Tensor) and g.device == torch.device("cpu")
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    # tensors in, and no flow: the same names
    _, again = pvis.capture_attention(model, torch.from_numpy(img), torch.from_numpy(seg))
    assert sorted(again) == sorted(want)
