"""Device selection shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point puts its tensors on.

    ``None`` means the GPU: the port is written for the card, and a run
    that quietly fell back to the CPU would report CPU numbers under a
    GPU's name.  So with no GPU present, ``None`` raises; the CPU is
    used only when the caller asks for it (``device="cpu"``, as the
    tests do).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        # the index tensors report, so devices compare equal
        device = torch.device("cuda", torch.cuda.current_device())
    return device
