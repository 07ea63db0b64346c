"""Device resolution for the port's entry points, and the card's peak
rate that their MFU figures divide by."""

from __future__ import annotations

from typing import Union

import torch

# the card's dense bf16 tensor-core peak (NVIDIA H100 SXM datasheet), the
# denominator of every MFU the port reports
H100_SXM_BF16_PEAK_FLOPS = 989e12


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for and no card is present; there
    is no silent fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    return dev
