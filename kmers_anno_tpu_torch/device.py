"""Device selection: every entry point takes an explicit device name."""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """``"cpu"``, ``"cuda"`` or ``"cuda:N"`` → a ``torch.device``.

    Asking for CUDA on a machine without it raises; it never quietly
    gives the CPU.
    """
    dev = torch.device(name)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {name!r}: use cpu or cuda")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not "
                           "available on this machine")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"device {name!r} requested but only "
                           f"{torch.cuda.device_count()} CUDA device(s) "
                           "exist")
    return dev
