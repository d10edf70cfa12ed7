"""Checks every kernel wrapper makes before it passes pointers to a
CUDA kernel: no autograd through the kernel, and operands that are
CUDA tensors on one device, of the right dtype, and contiguous or (for
kernels that take strides) with unit stride along their last dim."""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor


def refuse_autograd(kernel: str, named: dict[str, torch.Tensor]) -> None:
    """Raise when grad mode is on and an operand requires grad.  A
    ctypes kernel's output has no ``grad_fn``, so training through it
    would silently stop learning; the kernels are forward-only."""
    if not torch.is_grad_enabled():
        return
    wants = [name for name, t in named.items() if t.requires_grad]
    if wants:
        raise RuntimeError(
            f"{kernel}: {', '.join(wants)} require(s) grad, but the kernel has no "
            f"backward; call it under torch.no_grad() or on detached tensors "
            f"(the trainer's gradients go through the plain PyTorch forward)"
        )


def check_operands(kernel: str, named: dict[str, torch.Tensor],
                   dtypes: dict[str, torch.dtype] | None = None) -> torch.device:
    """Every operand on one CUDA device, contiguous, float32 unless
    ``dtypes`` names another dtype for it.  Returns the device."""
    first = _check_placed(kernel, named, dtypes or {})
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")
    return first


def check_rows(kernel: str, named: dict[str, torch.Tensor]) -> torch.device:
    """Every operand a float32 view on one CUDA device with unit stride
    along its last dim (any other strides: the kernel takes them as
    arguments).  Returns the device."""
    first = _check_placed(kernel, named, {})
    for name, t in named.items():
        if t.dim() == 0 or (t.shape[-1] > 1 and t.stride(-1) != 1):
            raise ValueError(f"{kernel}: {name} needs unit stride along its last dim, has "
                             f"strides {t.stride()}")
    return first


def _check_placed(kernel: str, named: dict[str, torch.Tensor],
                  dtypes: dict[str, torch.dtype]) -> torch.device:
    first = next(iter(named.values())).device
    for name, t in named.items():
        if isinstance(t, DTensor):  # its pointer would be the local shard's, its shape global
            raise TypeError(f"{kernel}: {name} is a DTensor, the kernel takes a rank's local "
                            f"tensor")
        if t.device.type != "cuda":
            raise ValueError(f"{kernel}: {name} is on {t.device}, the kernel takes CUDA tensors")
        if t.device != first:
            raise ValueError(f"{kernel}: {name} is on {t.device}, the first operand on {first}")
        want = dtypes.get(name, torch.float32)
        if t.dtype != want:
            raise TypeError(f"{kernel}: {name} is {t.dtype}, the kernel takes {want}")
    return first
