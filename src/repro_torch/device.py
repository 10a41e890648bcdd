"""Device policy of the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``, as the tests do). A CUDA request on a machine without a
usable card raises :class:`DeviceUnavailableError`; nothing falls back to
the CPU silently. ``meta`` (shapes without memory) is the dry-run's
device (``launch/dryrun``): the kernels' wrappers take their meta route
there.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["DeviceUnavailableError", "resolve_device", "dtype_of"]


class DeviceUnavailableError(RuntimeError):
    """The requested device does not exist on this machine."""


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False (torch {torch.__version__}); pass device='cpu' to "
            f"run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise DeviceUnavailableError(f"unsupported device {str(dev)!r}")
    return dev


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, "
                         f"got {name!r}")
    return _DTYPES[name]
