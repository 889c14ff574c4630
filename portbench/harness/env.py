"""The process environment of a run, set before torch is imported."""

import os


def pin(root: str) -> None:
    """Kernel and compiler caches in fixed directories of the checkout, so
    that only a checkout's first run builds; one host thread for the CPU
    side of the program, so that the host's other work takes no core from
    the loop that issues to the card."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(root, "build", sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
