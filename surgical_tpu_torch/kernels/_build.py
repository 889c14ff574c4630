"""Build and load the hand-written CUDA kernels of ``surgical_tpu_torch/csrc``.

At first use, every ``csrc/*.cu`` is compiled for ``sm_90a`` (Hopper) by
its own ``nvcc``, all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``. The
library lands in ``build/kernels/`` at the repository root (listed in
``.gitignore``) under a name keyed by a hash of the sources and flags, so
an edited source rebuilds and an unchanged one loads from disk.

There is no fallback: a missing ``nvcc`` or a failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# C entry points: name -> (number of pointer arguments, number of int
# arguments); every entry ends with the stream and returns cudaGetLastError()
_ENTRY_POINTS = {
    "mit_block_forward": (23, 7),
    "mit_block_packed2_forward": (23, 5),
    "mit_stage_forward": (35, 10),
    "mit_block_train_forward": (24, 7),
    "mit_block_train_mlp_backward": (10, 5),
    "mit_block_train_attn_backward": (16, 5),
    "selective_scan_forward": (7, 4),
}

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the Hopper kernels are built from source at first use")
    return found


def build() -> Path:
    """Compile the kernels if this source hash has no library yet."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    so = BUILD_DIR / f"libsurgical_kernels_{h.hexdigest()[:16]}.so"
    if so.is_file():
        return so
    nvcc = _nvcc()
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    # one nvcc per source, all at once, then one link
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = tmp.with_name(f"{tmp.name}.{src.stem}.o")
        cmd = [nvcc, *compile_flags, "-c", "-o", str(obj), str(src)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
        objs.append(obj)
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}:\n{out}")
    link = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            failed.append(f"{' '.join(link)}:\n{proc.stdout}{proc.stderr}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (n_ptr, n_int) in _ENTRY_POINTS.items():
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by an entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} after launch")
