"""Device resolution for the port's entry points.

Every entry point (CLI, ``Encoder``, ``VectorStore``, ``IndexManager``)
runs on ``cuda`` unless the caller asks for ``cpu``. A ``cuda`` request
on a host without a card raises: the port never continues on the CPU
behind the caller's back.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``"cuda"`` (default) or ``"cpu"`` as a ``torch.device``; raises
    RuntimeError for ``cuda`` without a card, ValueError for any other
    device type."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
