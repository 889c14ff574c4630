"""The run refuses what it must: modules of JAX or the JAX package, a
machine without a card, a checkout without the program."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from harness import core, files


@pytest.mark.parametrize("names, found", [
    (["jax", "numpy"], ["jax"]),
    (["jax.numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["surgical_tpu"], ["surgical_tpu"]),
    (["surgical_tpu.models.mit_evp"], ["surgical_tpu"]),
    (["surgical_tpu_torch", "surgical_tpu_torch.models.mit_evp"], []),
    (["jax_cosmos", "jaxtyping", "flaxen", "torch"], []),
])
def test_guard_compares_whole_top_level_names(names, found):
    assert core.banned_modules(names) == found


def test_reference_imports_nothing_of_the_program():
    """The reference's imports name neither JAX nor either package."""
    for path in sorted((files.BENCH_DIR / "reference").glob("*.py")):
        imports = [line.split() for line in path.read_text().splitlines()
                   if line.startswith(("import ", "from "))]
        assert imports
        for words in imports:
            top = words[1].split(".")[0]
            assert top in ("__future__", "math", "numpy", "torch"), (path.name, words)


def _run(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "b0-mamba.video",
                           "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _printed_result(out: str) -> bool:
    for line in out.splitlines():
        try:
            if "correct" in json.loads(line):
                return True
        except (ValueError, TypeError):
            continue
    return False


def test_no_card_no_result():
    """Without a CUDA card the run fails and does not fall back to the CPU."""
    proc = _run(files.ROOT)
    assert proc.returncode != 0
    assert not _printed_result(proc.stdout)
    assert "CUDA" in proc.stderr


def test_benchmark_alone_gives_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files: no
    program, no result."""
    shutil.copy(files.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(files.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert not _printed_result(proc.stdout)
