"""dram_tpu_torch: PyTorch/CUDA port of dram_tpu for one NVIDIA H100.

Module names mirror dram_tpu/. The package imports torch, numpy and the
standard library only; it imports nothing of jax or of dram_tpu.
"""

import torch


def require_cuda(device):
    """`device` as a torch.device; raise when it names CUDA and no CUDA
    device is present. Entry points default to "cuda" and never fall back
    to the CPU: callers ask for the CPU explicitly."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"dram_tpu_torch: device {device} requested but no CUDA device "
            "is available (pass device='cpu' to run the plain versions)")
    return device
