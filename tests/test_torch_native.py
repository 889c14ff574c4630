"""The port's native frame decoder (``surgical_tpu_torch/native``) and
``ClipDataset``'s native route against the JAX package's, on the CPU.

Stated bounds: every comparison is bit for bit. The decoder is the same
C++ source (a byte copy, held here to the original) built by the same
command, so its frames equal JAX's native frames; the port's
``ClipDataset`` and ``cache-frames`` at their defaults equal JAX's
``ClipDataset`` / ``FrameCache.build`` at theirs (``use_native=True``). Where
JAX's native route zero-fills a missing or corrupt JPEG, the port decodes
that slot again with PIL, which raises. Skipped where ``g++`` or libjpeg's
header is missing, as tests/test_native_loader.py is.
"""

import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from surgical_tpu import native as jnative
from surgical_tpu.cli import _write_synthetic_corpus
from surgical_tpu.data.datasets import ClipDataset as JaxClipDataset
from surgical_tpu.data.datasets import FrameCache as JaxFrameCache
from surgical_tpu_torch import cli
from surgical_tpu_torch import native
from surgical_tpu_torch.data import datasets as pds

torch.set_num_threads(1)  # one intra-op thread per test process: xdist workers share the CPUs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLCHAIN = shutil.which("g++") is not None and any(
    os.path.exists(os.path.join(d, "jpeglib.h"))
    for d in ("/usr/include", "/usr/local/include", "/usr/include/x86_64-linux-gnu"))
needs_toolchain = pytest.mark.skipif(not TOOLCHAIN, reason="g++ or libjpeg's jpeglib.h missing")


def _jpegs(d, sizes, seed=0, grey_seg=False):
    """JPEG frames of the given (h, w) sizes under d/cutMargin/1/, with JPEG
    segmaps (grey when ``grey_seg``) under the segmap substitution."""
    rng = np.random.default_rng(seed)
    paths = []
    for i, (h, w) in enumerate(sizes):
        p = os.path.join(d, "cutMargin", "1", f"{i}.jpg")
        os.makedirs(os.path.dirname(p), exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(p, quality=90)
        s = p.replace("cutMargin", "ss_Bimasks_pos_ep10")
        os.makedirs(os.path.dirname(s), exist_ok=True)
        seg = rng.integers(0, 256, (h, w) if grey_seg else (h, w, 3), dtype=np.uint8)
        Image.fromarray(seg).save(s, quality=90)
        paths.append(p)
    return paths


def test_loader_source_is_a_byte_copy():
    with open(os.path.join(REPO, "surgical_tpu", "native", "loader.cpp"), "rb") as f:
        original = f.read()
    assert native.SOURCE.read_bytes() == original


@needs_toolchain
def test_library_builds_under_build_native():
    assert native.available() and native.failure() is None
    so = native.library_path()
    assert so.parent == native.BUILD_DIR and so.is_file()
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")
    assert native.BUILD_DIR.parent.parent == native.SOURCE.parents[2]  # the repository root
    assert not list(native.SOURCE.parent.glob("*.so"))
    assert native.get_lib().sv_version() == jnative.get_lib().sv_version()


@needs_toolchain
@pytest.mark.parametrize("channels", (3, 1))
@pytest.mark.parametrize("out_size", (48, 250))
def test_batch_equals_jax_native(tmp_path, channels, out_size):
    """Down- and upscaled, RGB and grey: equal to JAX's native batch."""
    paths = _jpegs(str(tmp_path), [(90, 110), (64, 64), (250, 250), (37, 300)])
    got, fails = native.decode_resize_batch(paths, out_size, channels)
    want, jfails = jnative.decode_resize_batch(paths, out_size, channels)
    assert fails == jfails == 0 and got.shape == (4, out_size, out_size, channels)
    np.testing.assert_array_equal(got, want)
    buf = np.zeros_like(got)
    out, _ = native.decode_resize_batch(paths, out_size, channels, out=buf, n_threads=2)
    assert out is buf
    np.testing.assert_array_equal(buf, want)
    with pytest.raises(ValueError, match="C-contiguous uint8"):
        native.decode_resize_batch(paths, out_size, channels, out=buf[:, ::-1])
    with pytest.raises(ValueError, match="channels must be 1 or 3"):
        native.decode_resize_batch(paths, out_size, 2)


@needs_toolchain
@pytest.mark.parametrize("grey_seg", (False, True))
def test_clip_dataset_frames_equal_jax_default(tmp_path, grey_seg):
    """Images and JPEG segmaps through the native route, flow from .npy,
    against JAX's ClipDataset at its default (use_native=True); and a PNG
    segmap sends the segmaps through PIL in both packages."""
    paths = _jpegs(str(tmp_path), [(60, 80), (300, 280), (250, 250)], grey_seg=grey_seg)
    f = paths[0].replace("cutMargin", "raft_flow_npy").replace(".jpg", ".npy")
    os.makedirs(os.path.dirname(f), exist_ok=True)
    np.save(f, np.random.default_rng(1).standard_normal((40, 50, 2)).astype(np.float32))
    labels = np.random.default_rng(2).uniform(0, 1, (3, 15)).astype(np.float32)
    for resize in (64, 250):
        got = pds.ClipDataset(paths, labels, resize=resize).frames([2, 0, 1])
        want = JaxClipDataset(paths, labels, resize=resize).frames([2, 0, 1])
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g, w)
        assert got[0].shape == (3, resize, resize, 3) and got[1].shape == (3, resize, resize, 1)
        # the native route differs from PIL's resize (JAX's own test allows a
        # mean difference of up to 6 grey levels): the route is the one taken
        pil = pds.ClipDataset(paths, labels, resize=resize, use_native=False).frames([2, 0, 1])
        assert not np.array_equal(pil[0], got[0])
    png = paths[1].replace("cutMargin", "ss_Bimasks_pos_ep10").replace(".jpg", ".png")
    Image.fromarray(np.full((30, 30), 77, np.uint8)).save(png)
    got = pds.ClipDataset(paths, labels, resize=64, with_flow=False).frames([0, 1])
    want = JaxClipDataset(paths, labels, resize=64, with_flow=False).frames([0, 1])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[1][1] == 77).all()


@needs_toolchain
def test_cache_frames_equals_jax_frame_cache_at_defaults(tmp_path):
    root, work = str(tmp_path / "cholec80"), str(tmp_path / "work")
    _write_synthetic_corpus(root, num_videos=4, frames=8)
    assert cli.main(["prepare-data", "--root", root, "--out", work, "--num-videos", "4",
                     "--scheme", "smoke"]) == 0
    assert cli.main(["cache-frames", "--work", work, "--splits", "val,test",
                     "--batch-size", "4"]) == 0
    for split in ("val", "test"):
        idx = os.path.join(work, "index")
        with open(os.path.join(idx, f"{split}_paths.json")) as f:
            paths = json.load(f)
        labels = np.load(os.path.join(idx, f"{split}_labels.npy"))
        want = JaxFrameCache.build(JaxClipDataset(paths, labels), str(tmp_path / "jax" / split),
                                   batch_size=4)
        got_dir = os.path.join(work, "frame_cache", split)
        for name in ("img.npy", "seg.npy", "flow.npy", "labels.npy"):
            np.testing.assert_array_equal(np.load(os.path.join(got_dir, name)),
                                          np.load(os.path.join(want.directory, name)),
                                          err_msg=name)
        with open(os.path.join(got_dir, "manifest.json")) as f:
            assert json.load(f) == want.meta


@needs_toolchain
@pytest.mark.parametrize("fault", ("missing", "corrupt"))
def test_missing_or_corrupt_jpeg_raises(tmp_path, fault, caplog):
    """JAX's native route zero-fills the slot (its _native_batch drops the
    failure count); the port decodes it again with PIL, which logs and
    raises, as the PIL route does."""
    paths = _jpegs(str(tmp_path), [(40, 40)] * 3)
    if fault == "missing":
        os.remove(paths[1])
    else:
        with open(paths[1], "wb") as f:
            f.write(b"\xff\xd8 not a jpeg")
    labels = np.zeros((3, 15), np.float32)
    jimgs = JaxClipDataset(paths, labels, resize=32, with_flow=False).frames([0, 1, 2])[0]
    assert not jimgs[1].any() and jimgs[0].any()
    with caplog.at_level(logging.ERROR), pytest.raises((FileNotFoundError, OSError)):
        pds.ClipDataset(paths, labels, resize=32, with_flow=False).frames([0, 1, 2])
    assert "failed to load" in caplog.text and paths[1] in caplog.text
    with pytest.raises((FileNotFoundError, OSError)):
        pds.ClipDataset(paths, labels, resize=32, with_flow=False, use_native=False).frames([1])


@needs_toolchain
def test_black_frame_is_not_a_failure(tmp_path, caplog):
    """An all-zero frame beside a failed one keeps its native decode; only
    the failed slot goes to PIL (here a PNG under a .jpg name, which libjpeg
    refuses and PIL reads), and a warning names it."""
    paths = _jpegs(str(tmp_path), [(40, 40)] * 3)
    Image.fromarray(np.zeros((40, 40, 3), np.uint8)).save(paths[0], quality=90)
    Image.fromarray(np.full((40, 40, 3), 200, np.uint8)).save(paths[1], format="PNG")
    labels = np.zeros((3, 15), np.float32)
    with caplog.at_level(logging.WARNING):
        imgs = pds.ClipDataset(paths, labels, resize=32, with_flow=False).frames([0, 1, 2])[0]
    mixed = [r.getMessage() for r in caplog.records if "mixes the two routes" in r.getMessage()]
    assert len(mixed) == 1 and paths[1] in mixed[0]
    want, fails = native.decode_resize_batch(paths, 32)
    assert fails == 1 and not want[1].any()
    np.testing.assert_array_equal(imgs[[0, 2]], want[[0, 2]])
    np.testing.assert_array_equal(imgs[1], pds.load_image(paths[1], "RGB", 32))


def test_unbuilt_library_falls_back_to_pil_with_one_warning(tmp_path, monkeypatch, caplog):
    """A failed build: available() is False, failure() keeps the compiler's
    output, and ClipDataset decodes with PIL, logging the reason once."""
    bad = tmp_path / "loader.cpp"
    bad.write_text("#include <no_such_header.h>\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failure", None)
    monkeypatch.setattr(pds, "_pil_fallback_logged", False)
    assert not native.available()
    assert "no_such_header" in native.failure()
    with pytest.raises(RuntimeError, match="unavailable"):
        native.decode_resize_batch([], 8)
    assert not list((tmp_path / "build").glob("*.so"))
    paths = _jpegs(str(tmp_path), [(40, 40)] * 2)
    labels = np.zeros((2, 15), np.float32)
    with caplog.at_level(logging.WARNING):
        got = pds.ClipDataset(paths, labels, resize=32, with_flow=False).frames([0, 1])
        pds.ClipDataset(paths, labels, resize=32, with_flow=False).frames([1, 0])
    want = JaxClipDataset(paths, labels, resize=32, with_flow=False,
                          use_native=False).frames([0, 1])
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    warned = [r for r in caplog.records if "decoding with PIL" in r.getMessage()]
    assert len(warned) == 1 and "no_such_header" in warned[0].getMessage()
