"""The port's flow precompute (``surgical_tpu_torch/flow/precompute.py``, a
copy of the JAX package's numpy module) against the JAX package's driver on
the same flow_fn, and ``cli precompute-flow`` on the CPU: RAFT over a
synthetic 2-video Cholec80-layout corpus from an upstream-layout ``.pth``
(each file equal to a direct call of the driver's flow_fn on its pair), the
rerun that skips every pair, and the port's checkpoint store as the weights'
source. RAFT itself is held to the JAX model in tests/test_torch_raft.py.
Every comparison here is exact. Plus chip_smoke.py's RAFT phase at a tiny
size on the CPU.
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

import surgical_tpu.flow.precompute as jpre
import surgical_tpu_torch.flow.precompute as tpre
from surgical_tpu_torch import cli
from surgical_tpu_torch.core.checkpoint import CheckpointStore
from surgical_tpu_torch.data.datasets import load_image
from surgical_tpu_torch.models.convert import load_torch_pth
from surgical_tpu_torch.models.raft import RAFT, make_flow_fn

torch.set_num_threads(1)  # one intra-op thread per test process: xdist workers share the CPUs

FRAMES = (0, 25, 50, 75)


def _frames(rng, shape=(15, 17, 3)):
    return {n: rng.uniform(0, 255, shape).astype(np.float32) for n in FRAMES}


def _fake_flow(fail_at=None):
    """A deterministic flow_fn: a function of both frames, raising on the
    pair whose first frame's top-left value is ``fail_at``."""
    calls = []

    def flow_fn(f1, f2):
        assert f1.shape[0] % 8 == 0 and f1.shape[1] % 8 == 0  # padded
        if fail_at is not None and f1[0, 0, 0] == fail_at:
            raise RuntimeError("injected failure")
        calls.append(float(f1[0, 0, 0]))
        return np.stack([f1[..., 0] - f2[..., 1], f1[..., 2] * 0.5], axis=-1)

    return flow_fn, calls


def _log_lines(path):
    """The log without its timestamps and traceback bodies' paths."""
    with open(path) as f:
        text = re.sub(r"^\[[^\]]*\] ", "", f.read(), flags=re.M)
    return [ln for ln in text.splitlines() if not ln.startswith(("  File", "    "))]


def test_constants_and_helpers_match_jax(rng, tmp_path):
    assert tpre.FRAME_INTERVAL == jpre.FRAME_INTERVAL == 25
    img = rng.standard_normal((15, 17, 3)).astype(np.float32)
    for multiple in (8, 4):
        got, hw = tpre.pad_to_multiple_hw(img, multiple)
        want, whw = jpre.pad_to_multiple_hw(img, multiple)
        np.testing.assert_array_equal(got, want)
        assert hw == whw == (15, 17)
    np.save(tmp_path / "f.npy", img[..., :2])
    for path in (tmp_path / "f.npy", tmp_path / "missing.npy"):
        np.testing.assert_array_equal(tpre.load_flow_or_zero(str(path), (15, 17)),
                                      jpre.load_flow_or_zero(str(path), (15, 17)))


@pytest.mark.parametrize("median_filter", [False, True])
def test_driver_matches_jax(rng, tmp_path, median_filter):
    """Crop to the frame, the last frame without a file, error-continue with
    the traceback in the log, and the resume that skips what exists: the
    same files, stats and log lines from both drivers."""
    frames = _frames(rng)
    bad = float(frames[25][0, 0, 0])
    runs = {}
    for name, mod in (("port", tpre), ("jax", jpre)):
        root = tmp_path / name
        fn, calls = _fake_flow(fail_at=bad)
        drv = mod.FlowPrecomputeDriver(fn, str(root / "flow"), log_path=str(root / "log.txt"),
                                       median_filter=median_filter)
        drv.run_video(7, sorted(frames), frames.__getitem__)
        first = dict(drv.stats)
        fn2, calls2 = _fake_flow()
        again = mod.FlowPrecomputeDriver(fn2, str(root / "flow"), log_path=str(root / "log.txt"))
        again.run_video(7, sorted(frames), frames.__getitem__)
        files = {f: np.load(root / "flow" / "7" / f) for f in sorted(os.listdir(root / "flow" / "7"))}
        runs[name] = (first, dict(again.stats), calls, calls2, files, _log_lines(root / "log.txt"))
    port, jax_run = runs["port"], runs["jax"]
    assert port[0] == jax_run[0] == {"done": 2, "skipped": 0, "failed": 1}
    assert port[1] == jax_run[1] == {"done": 1, "skipped": 2, "failed": 0}
    assert port[2] == jax_run[2] and port[3] == jax_run[3] == [bad]
    assert list(port[4]) == list(jax_run[4]) == ["0.npy", "25.npy", "50.npy"]  # 75 is last
    for f, a in port[4].items():
        assert a.shape == (15, 17, 2) and a.dtype == np.float32
        np.testing.assert_array_equal(a, jax_run[4][f])
    assert port[5] == jax_run[5]
    assert any("video 7 frame 25 FAILED" in ln for ln in port[5])
    assert any("RuntimeError: injected failure" in ln for ln in port[5])


def _corpus(root, videos=(1, 2), frames=3, size=60, seed=0):
    rng = np.random.default_rng(seed)
    for v in videos:
        d = os.path.join(root, "cutMargin", str(v))
        os.makedirs(d, exist_ok=True)
        base = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        for i in range(frames):
            Image.fromarray(np.roll(base, 2 * i, axis=1)).save(os.path.join(d, f"{25 * i}.jpg"))


def _flows(root):
    out = {}
    for v in sorted(os.listdir(os.path.join(root, "raft_flow_npy"))):
        d = os.path.join(root, "raft_flow_npy", v)
        for f in sorted(os.listdir(d)):
            out[f"{v}/{f}"] = np.load(os.path.join(d, f))
    return out


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("raft") / "raft-things.pth")
    model = RAFT(iters=2, seed=3, device="cpu")
    # the DataParallel prefix of the upstream checkpoint, which the loader strips
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()}, path)
    return path


def test_cli_precompute_flow(tmp_path, pth, capsys):
    root = str(tmp_path / "cholec80")
    _corpus(root)
    args = ["precompute-flow", "--root", root, "--iters", "2", "--device", "cpu"]
    assert cli.main([*args, "--torch-checkpoint", pth]) == 0
    flows = _flows(root)
    assert list(flows) == ["1/0.npy", "1/25.npy", "2/0.npy", "2/25.npy"]  # 50 is last
    for f in flows.values():
        assert f.shape == (60, 60, 2) and f.dtype == np.float32 and np.isfinite(f).all()
    assert "video 2: {'done': 4, 'skipped': 0, 'failed': 0}" in capsys.readouterr().out

    # each file is the flow_fn of its pair, padded to 64 and cropped back
    model = RAFT(iters=2, device="cpu")
    model.load_state_dict(load_torch_pth(pth), strict=True)
    driver = tpre.FlowPrecomputeDriver(make_flow_fn(model), str(tmp_path / "unused"))
    for k, f in flows.items():
        v, n = k[:-4].split("/")
        load = lambda m: load_image(os.path.join(root, "cutMargin", v, f"{m}.jpg")).astype(
            np.float32)
        np.testing.assert_array_equal(f, driver.compute_pair(load(int(n)), load(int(n) + 25)))

    # the rerun skips every pair and writes nothing
    mtimes = {k: os.path.getmtime(os.path.join(root, "raft_flow_npy", k)) for k in flows}
    assert cli.main([*args, "--torch-checkpoint", pth]) == 0
    assert "video 2: {'done': 0, 'skipped': 4, 'failed': 0}" in capsys.readouterr().out
    assert {k: os.path.getmtime(os.path.join(root, "raft_flow_npy", k)) for k in flows} == mtimes
    with open(os.path.join(root, "flow_precompute_log.txt")) as f:
        assert sum(": {'done'" in ln for ln in f) == 4  # one line per video per run

    # the port's checkpoint store as the weights' source: the same files
    store = str(tmp_path / "store")
    CheckpointStore(store).save(1, RAFT(iters=2, seed=3, device="cpu").state_dict())
    sroot = str(tmp_path / "store_root")
    shutil.copytree(os.path.join(root, "cutMargin"), os.path.join(sroot, "cutMargin"))
    assert cli.main([*args[:2], sroot, *args[3:], "--checkpoint", store]) == 0
    for k, f in _flows(sroot).items():
        np.testing.assert_array_equal(f, flows[k])


def test_chip_smoke_raft_phase_on_cpu(tmp_path):
    """chip_smoke.py's RAFT phase, sized down (60-px frames, 2 iterations,
    3 frames per video) with the CPU as the card: the same checks, the CLI's
    resume and error-continue among them."""
    import chip_smoke

    res = chip_smoke.phase_raft(str(tmp_path), device="cpu", size=60, iters=2, video_frames=3)
    assert res["padded"] == [64, 64] and res["rel_l2"] == 0.0
    assert set(res["seconds"]) == {"first", "rerun", "corrupt"}
