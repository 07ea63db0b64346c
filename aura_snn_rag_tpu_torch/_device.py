"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch


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
