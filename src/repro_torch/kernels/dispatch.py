"""Device and kernel-mode resolution shared by the fused CUDA paths.

The ``kernel`` knob on ``PartitionerConfig`` selects the implementation
of the three fused hot loops:

  * ``"composed"`` — torch-ops pipelines (sort + segment ops), the twin
    of the JAX package's XLA-composed path. Runs on any device.
  * ``"fused"``    — the hand-written CUDA kernels (``lp_move``,
    ``seg_merge``, ``bal_round``). On a CPU tensor each wrapper runs its
    kernel's plain PyTorch version, so CPU tests cover the fused wiring.
  * ``"auto"``     — "fused" on a CUDA device, "composed" anywhere else.

Entry points take an explicit ``device``. ``None`` means the card:
``resolve_device`` raises when CUDA is missing instead of quietly
running on the CPU; pass ``device="cpu"`` to run there on purpose.

There is no fallback from "fused" to "composed": the kernels tile across
CTAs, so the TPU path's VMEM gate has no counterpart. A fused call whose
operands exceed a kernel's launch limits (int32 ids and weight totals,
2^30 sort length) raises; ``kernel="composed"`` is the caller's choice.
So does an ELL build whose bytes exceed ``HOST_ELL_LIMIT_BYTES`` on the
host or the card's free memory (``EllTooLarge``, checked from the degree
array before anything is allocated). The slab width is capped
(``kernels/lp_move/ops.py::slab_width``), so a fused build stays within a
small constant of the CSR's bytes and only a graph whose CSR is itself
near the limits meets this error.
"""
from __future__ import annotations

from typing import Union

import torch

KERNEL_MODES = ("auto", "fused", "composed")

# bytes an ELL build (slabs, overflow and the build's temporaries) may
# take on the host
HOST_ELL_LIMIT_BYTES = 16 << 30


class NoCudaDevice(RuntimeError):
    """CUDA was asked for (explicitly or by default) and none is there."""


class EllTooLarge(RuntimeError):
    """An ELL build would exceed its byte limit: the host's
    ``HOST_ELL_LIMIT_BYTES`` or the card's free memory."""


def check_ell_bytes(what: str, shape, host_bytes: int, device_bytes: int,
                    device=None) -> None:
    """Raise ``EllTooLarge`` unless ``host_bytes`` fit the host limit and,
    on a CUDA ``device``, ``device_bytes`` fit its free memory."""
    if host_bytes > HOST_ELL_LIMIT_BYTES:
        raise EllTooLarge(
            f"{what}: the ELL form {tuple(shape)} needs {host_bytes} bytes "
            f"on the host, over the limit of {HOST_ELL_LIMIT_BYTES} "
            "(kernels.dispatch.HOST_ELL_LIMIT_BYTES)")
    if device is not None and torch.device(device).type == "cuda":
        free = torch.cuda.mem_get_info(torch.device(device))[0]
        if device_bytes > free:
            raise EllTooLarge(
                f"{what}: the ELL form {tuple(shape)} needs {device_bytes} "
                f"bytes on the card, over its {free} free bytes")


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """``None`` -> the current CUDA device. Raises when CUDA is asked for
    (explicitly or by default) but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDevice(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU on purpose")
    return dev


def check_kernel_mode(kernel: str) -> str:
    if kernel not in KERNEL_MODES:
        raise ValueError(f"unknown kernel mode {kernel!r}; expected one "
                         f"of {KERNEL_MODES}")
    return kernel


def resolve_kernel_mode(kernel: str, device: torch.device) -> str:
    """Map the config knob to a concrete mode ("fused" | "composed")."""
    check_kernel_mode(kernel)
    if kernel == "auto":
        return "fused" if device.type == "cuda" else "composed"
    return kernel

