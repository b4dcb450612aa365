"""PyTorch/CUDA port of the PlanetServe serving stack for one NVIDIA H100.

Mirrors ``repro`` module by module (``configs``, ``params``, ``models``,
``kernels``, ``serving``) and imports nothing of it: JAX stays the
reference, this package computes with torch and with hand-written CUDA
kernels for Hopper (``kernels/*/csrc``).  Entry points run on the card by
default and raise on a machine without one; tests pass ``device="cpu"``.
"""
import torch


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device on a
    machine without a card (entry points never drop to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch sees no CUDA card; "
            "pass device='cpu' explicitly to run the plain versions")
    return dev
