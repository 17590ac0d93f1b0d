"""Device selection for the port: explicit, with no fallback.

Unlike ``aligntools_tpu/backend.py``, which degrades to the CPU when the
accelerator is unreachable, the port runs where it is told: ``"cuda"``
must be a visible Hopper GPU (compute capability 9.0, the ``sm_90a``
target the kernels are built for) or the call raises; ``"cpu"`` runs the
kernels' plain PyTorch versions and must be asked for by name.
"""

from __future__ import annotations

import torch


def resolve_device(name, cpu_hint: str = "pass --device cpu") -> torch.device:
    """``name`` as a torch.device the port can run on, or raise.
    ``cpu_hint`` tells the caller's user how to ask for the CPU."""
    dev = torch.device(name)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            f"false (no CUDA build of torch, or no visible GPU); "
            f"{cpu_hint} to run the plain PyTorch versions on the CPU"
        )
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    cap = torch.cuda.get_device_capability(idx)
    if cap != (9, 0):
        raise RuntimeError(
            f"the CUDA kernels are built for sm_90a (Hopper, compute "
            f"capability 9.0); {torch.cuda.get_device_name(idx)} has "
            f"{cap[0]}.{cap[1]}"
        )
    return torch.device("cuda", idx)
