"""PyTorch/CUDA port of the COCO-EF system (Hopper kernels, one-card slice).

`repro` (JAX) stays the reference; this package imports `torch` and numpy
only, never `jax` and nothing from `repro`.  Entry points run on `cuda`
unless the caller passes `device="cpu"`; asking for `cuda` without a card
raises instead of running on the CPU.
"""
import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; `cuda` without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is "
                           "available; pass device='cpu' to run the plain "
                           "PyTorch versions")
    return dev
