"""Helpers shared by the port's entry points."""
from __future__ import annotations


def device_from(name: str):
    """The torch device ``name`` that an entry point's ``--device`` names;
    SystemExit for ``cuda`` without a card (there is no fallback to another
    device)."""
    import torch
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run the plain versions)")
    return device
