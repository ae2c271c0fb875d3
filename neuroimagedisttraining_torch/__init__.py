"""PyTorch/CUDA port of the federated neuroimaging trainer.

Mirrors ``neuroimagedisttraining_tpu`` module for module: each module here
has one counterpart of the same name there, which stays the reference. This
package imports ``torch``, numpy and the standard library only.

Entry points run on the GPU (``torch.device("cuda")``) unless the caller
passes ``device="cpu"``; without CUDA they raise instead of falling back.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; the default is CUDA, which must be
    present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
