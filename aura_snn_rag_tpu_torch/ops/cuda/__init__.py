"""Hand-written CUDA kernels (sources in `csrc/`, built at first use) with
their ctypes wrappers and plain PyTorch versions."""

from aura_snn_rag_tpu_torch.ops.cuda._build import (  # noqa: F401
    build_all, launch_counts, reset_launch_counts)
