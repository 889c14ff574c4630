"""The port's flow precompute (``surgical_tpu_torch/flow/precompute.py``, a
copy of the JAX package's numpy module) against the JAX package's driver on
the same flow_fn, and ``cli precompute-flow`` on the CPU: RAFT over a
synthetic 2-video Cholec80-layout corpus from an upstream-layout ``.pth``
(each file equal to a direct call of the driver's flow_fn on its batch), the
rerun that skips every pair, and the port's checkpoint store as the weights'
source. RAFT itself is held to the JAX model in tests/test_torch_raft.py.
The batched driver over 10 pairs in batches of 4: files within the fp32
bound of one-pair calls, the resume, a corrupt JPEG failing only the pairs
that read it, a failed write leaving no ``.tmp.npy``, and ``--batch-size``
through ``cli.main``. Comparisons of the same computation are exact; those
across batch compositions hold 1e-5 of the largest flow. Plus
chip_smoke.py's RAFT phase at a tiny size on the CPU.
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

    # each file is the flow_fn of its video's batch (the default --batch-size
    # takes both pending pairs of a video in one call), the uint8 frames
    # padded to 64 on the device and cropped back; and within the fp32 bound
    # of its pair alone (CPU reading 1.3e-7 px on flows up to 0.17 px)
    model = RAFT(iters=2, device="cpu")
    model.load_state_dict(load_torch_pth(pth), strict=True)
    flow_fn = make_flow_fn(model)
    driver = tpre.FlowPrecomputeDriver(flow_fn, str(tmp_path / "unused"))
    for v in ("1", "2"):
        load = lambda m: load_image(os.path.join(root, "cutMargin", v, f"{m}.jpg"))
        batch = flow_fn(np.stack([load(0), load(25)]), np.stack([load(25), load(50)]))
        for n, want in zip((0, 25), batch):
            np.testing.assert_array_equal(flows[f"{v}/{n}.npy"], want)
            one = driver.compute_pair(load(n).astype(np.float32), load(n + 25).astype(np.float32))
            np.testing.assert_allclose(flows[f"{v}/{n}.npy"], one, rtol=0,
                                       atol=1e-5 * np.abs(one).max())

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


# The batched driver: RAFT's flow function over 10 pairs (11 frames at
# stride 25) of one video in batches of 4.

N_FRAMES, BATCH = 11, 4


def _batch_counter(flow_fn):
    """flow_fn, counting the pairs of each call; still batched."""
    sizes = []

    def counted(a, b):
        sizes.append(len(a))
        return flow_fn(a, b)

    counted.batched = True
    return counted, sizes


@pytest.fixture(scope="module")
def raft_fn():
    return make_flow_fn(RAFT(iters=2, seed=4, device="cpu"))


@pytest.fixture
def video(tmp_path):
    """One video of N_FRAMES 60-px JPEGs; its directory and a loader."""
    root = str(tmp_path / "cholec80")
    _corpus(root, videos=(1,), frames=N_FRAMES, seed=5)
    vdir = os.path.join(root, "cutMargin", "1")
    return vdir, lambda n: load_image(os.path.join(vdir, f"{n}.jpg"))


def _run(fn, out, load, **kw):
    driver = tpre.FlowPrecomputeDriver(fn, str(out), log_path=str(out / "log.txt"), **kw)
    driver.run_video(1, [25 * i for i in range(N_FRAMES)], load)
    return driver.stats, {int(f[:-4]): np.load(out / "1" / f)
                          for f in os.listdir(out / "1") if f.endswith(".npy")}


def _no_tmp(out):
    return not [f for _, _, fs in os.walk(out) for f in fs if f.endswith(".tmp.npy")]


def test_batched_driver_equals_one_pair_path_and_resumes(raft_fn, video, tmp_path):
    """Batches of 4, 4, 2; every file within the fp32 bound of the same
    pair through a one-pair call (CPU reading 4.3e-7 of the largest flow);
    the rerun skips all 10 pairs and calls nothing."""
    _, load = video
    fn, sizes = _batch_counter(raft_fn)
    stats, files = _run(fn, tmp_path / "flow", load, batch_size=BATCH)
    assert stats == {"done": 10, "skipped": 0, "failed": 0} and sizes == [4, 4, 2]
    assert sorted(files) == [25 * i for i in range(10)]
    for n, f in files.items():
        one = raft_fn(load(n), load(n + 25))
        assert f.shape == (60, 60, 2) and f.dtype == np.float32
        np.testing.assert_allclose(f, one, rtol=0, atol=1e-5 * np.abs(one).max())
    again, more = _batch_counter(raft_fn)
    stats2, _ = _run(again, tmp_path / "flow", load, batch_size=BATCH)
    assert stats2 == {"done": 0, "skipped": 10, "failed": 0} and more == []
    assert _no_tmp(tmp_path / "flow")


def test_corrupt_frame_fails_only_the_pairs_that_read_it(raft_fn, video, tmp_path):
    """A corrupt JPEG in the middle of the second batch (frame 125) fails
    exactly the two pairs that read it (100 and 125), each with its
    traceback in the log; the 8 others are written, equal to their files
    in a clean run's within the fp32 bound, as their batches differ (CPU
    reading 0)."""
    vdir, load = video
    _, clean = _run(raft_fn, tmp_path / "clean", load, batch_size=BATCH)
    with open(os.path.join(vdir, "125.jpg"), "wb") as f:
        f.write(b"not a jpeg")
    fn, sizes = _batch_counter(raft_fn)
    stats, files = _run(fn, tmp_path / "flow", load, batch_size=BATCH)
    assert stats == {"done": 8, "skipped": 0, "failed": 2} and sizes == [4, 4]
    assert sorted(files) == [0, 25, 50, 75, 150, 175, 200, 225]
    for n, f in files.items():
        np.testing.assert_allclose(f, clean[n], rtol=0, atol=1e-5 * np.abs(clean[n]).max())
    log = _log_lines(tmp_path / "flow" / "log.txt")
    assert [ln for ln in log if "FAILED" in ln] == ["video 1 frame 100 FAILED:",
                                                   "video 1 frame 125 FAILED:"]
    assert log.count("Traceback (most recent call last):") == 2
    assert sum("UnidentifiedImageError" in ln for ln in log) == 2
    assert _no_tmp(tmp_path / "flow")


def test_failed_write_leaves_no_tmp(raft_fn, video, tmp_path, monkeypatch):
    """A write that fails after its ``.tmp.npy`` exists fails that pair
    alone and removes the temporary file; the batch's other pairs publish."""
    _, load = video
    save = np.save

    def failing(path, arr):
        save(path, arr)
        if os.path.basename(path) == "50.npy.tmp.npy":
            raise OSError("disk full")

    monkeypatch.setattr(tpre.np, "save", failing)
    stats, files = _run(raft_fn, tmp_path / "flow", load, batch_size=BATCH)
    assert stats == {"done": 9, "skipped": 0, "failed": 1} and 50 not in files
    assert _no_tmp(tmp_path / "flow")
    assert "OSError: disk full" in _log_lines(tmp_path / "flow" / "log.txt")


def test_cli_precompute_flow_batch_size(tmp_path, pth):
    """``precompute-flow --batch-size 3`` through ``cli.main``: 7 pairs of one
    video in batches of 3, 3, 1, each file equal bit for bit to the driver's
    with the same batches on the same weights."""
    root = str(tmp_path / "cholec80")
    _corpus(root, videos=(1,), frames=8)
    assert cli.main(["precompute-flow", "--root", root, "--iters", "2", "--device", "cpu",
                     "--torch-checkpoint", pth, "--batch-size", "3"]) == 0
    got = _flows(root)
    model = RAFT(iters=2, device="cpu")
    model.load_state_dict(load_torch_pth(pth), strict=True)
    fn, sizes = _batch_counter(make_flow_fn(model))
    vdir = os.path.join(root, "cutMargin", "1")
    driver = tpre.FlowPrecomputeDriver(fn, str(tmp_path / "direct"), batch_size=3)
    driver.run_video(1, [25 * i for i in range(8)],
                     lambda n: load_image(os.path.join(vdir, f"{n}.jpg")))
    assert sizes == [3, 3, 1] and len(got) == 7
    for n in range(7):
        np.testing.assert_array_equal(got[f"1/{25 * n}.npy"],
                                      np.load(tmp_path / "direct" / "1" / f"{25 * n}.npy"))
