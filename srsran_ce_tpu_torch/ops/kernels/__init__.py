"""The port's hand-written Hopper kernels (CUDA C++ under `csrc/`, built by
`_build`), each beside its plain PyTorch version.

A wrapper takes its plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32_matmul():
    """Run the enclosed `torch.matmul`s in IEEE f32: TF32 off.

    The plain versions are the yardstick the kernels are held to on the card;
    a TF32 product (about three decimal digits) would make that comparison
    meaningless, so they pin `torch.backends.cuda.matmul.allow_tf32 = False`
    (PyTorch's default, restored to whatever the caller had on exit)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def check_cuda_f32(**tensors) -> torch.device:
    """Validate the tensors a kernel takes: one CUDA device, float32, contiguous.
    Returns the device."""
    device = None
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel takes CUDA tensors")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return device


def check_shape(name: str, t: torch.Tensor, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
