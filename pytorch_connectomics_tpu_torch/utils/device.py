"""Device selection: the port runs on ``cuda`` unless the caller asks for
the CPU, and a missing GPU is an error, never a silent CPU run."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None``/``"cuda"`` -> the current CUDA device (raises when there is
    none); anything else is taken as given (``"cpu"``, ``"cuda:1"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' (CLI: --device cpu) to run on the CPU")
    return dev
