# ported from paddle_tpu/core/place.py
"""Device places for the PyTorch port.

In the JAX package ``CUDAPlace`` is only an alias of ``TPUPlace``
(paddle_tpu/__init__.py). Here it is a real CUDA device:
``CUDAPlace(i)`` returns ``torch.device("cuda", i)`` (``TPUPlace`` is its
alias, the mirror of the JAX package's), and ``CPUPlace()`` returns
``torch.device("cpu")``, so a place can be handed to any tensor
call that takes a device.

:func:`resolve_device` is the one rule every entry point of the port
applies to its ``device`` argument: ``None`` means the card, and asking for
the card on a machine without one raises instead of carrying on quietly on
the CPU. A caller that wants the CPU says so (``device="cpu"``), as the
tests do.
"""

from __future__ import annotations

import torch

__all__ = ["CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "TPUPlace",
           "resolve_device"]


def CPUPlace() -> torch.device:
    return torch.device("cpu")


def CUDAPlace(device_id: int = 0) -> torch.device:
    return torch.device("cuda", int(device_id))


# A Fluid script written for the JAX package names its accelerator
# ``TPUPlace``; here that accelerator is the card.
TPUPlace = CUDAPlace


class CUDAPinnedPlace:
    """Page-locked host memory, from which the card copies without a
    staging buffer (reference: ``platform/place.h`` ``CUDAPinnedPlace``).
    It holds data on its way to the card and is no device a program runs
    on: :func:`resolve_device` refuses it. ``DataFeeder(place=...)`` hands
    out pinned host tensors for it, and the reader's ``DevicePrefetcher``
    stages every batch in such memory."""

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self).__name__)

    def __repr__(self):
        return "CUDAPinnedPlace()"


def resolve_device(device=None) -> torch.device:
    """``device`` (None, a string, a ``torch.device`` or a place) as a
    ``torch.device``. ``None`` resolves to ``cuda``, and a CUDA device
    without an index to the current card; a CUDA device raises
    ``RuntimeError`` when PyTorch sees no GPU."""
    if isinstance(device, CUDAPinnedPlace):
        raise ValueError(
            "CUDAPinnedPlace is page-locked host memory for data on its way "
            "to the card, not a device to run on; use CUDAPlace or CPUPlace")
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %r (cuda or cpu)" % (device,))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA GPU by default, and "
                "torch.cuda.is_available() is False here; pass "
                "device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
