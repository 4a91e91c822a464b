"""Device selection: every entry point takes an explicit device name.

Also the two helpers the engines share for their device arrays: the
power-of-two sizes they pad to, and the integer threshold table that lets
a device compare reproduce a float64 quotient test.
"""

from __future__ import annotations

import numpy as np
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


def pow2_bucket(n: int, minimum: int) -> int:
    """``n`` rounded up to a power of two, and at least ``minimum``."""
    n = max(n, minimum)
    return 1 << (n - 1).bit_length()


def min_ev_table(min_strength: float, max_len: int) -> np.ndarray:
    """minev[L] = smallest integer ev with NOT (ev / L < min_strength),
    under float64 division — so a device's integer compare reproduces the
    host's ``evidence / length < min_strength`` bit-exactly."""
    L = np.arange(max_len + 1, dtype=np.int64)
    L[0] = 1
    ev = np.ceil(min_strength * L).astype(np.int64)
    ev = np.maximum(ev, 0)
    ev = np.where((ev - 1) >= 0, np.where((ev - 1) / L >= min_strength,
                                          ev - 1, ev), ev)
    ev = np.where(ev / L < min_strength, ev + 1, ev)
    bad = (ev / L < min_strength) | ((ev - 1) / L >= min_strength)
    bad &= ev - 1 >= 0
    if bad.any():  # pragma: no cover - construction is provably 1 step
        raise AssertionError("min_ev_table failed to converge")
    return ev.astype(np.int32)
