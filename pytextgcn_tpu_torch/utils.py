"""Small runtime utilities."""

from __future__ import annotations

import ctypes
import os
import sys
from typing import Optional, Union

import torch

# build outputs (native host library, CUDA kernels) go here, inside the
# package and listed in .gitignore
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the GPU: it raises when no GPU is present instead of
    falling back to the CPU, so a run that was meant for the card can never
    silently measure the CPU. Pass ``"cpu"`` explicitly to run there.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


_M_MMAP_THRESHOLD = -3
_M_MMAP_MAX = -4
_tuned = False


def tune_allocator() -> bool:
    """Keep large malloc blocks on the heap instead of per-allocation mmaps.

    glibc serves big allocations (every large numpy array) by mmap and
    munmaps them on free, so each one pays first-touch page faults again.
    Where memory is backed lazily (a virtual machine), those faults dominate
    the host-side graph and plan builds. Raising ``M_MMAP_THRESHOLD`` keeps
    freed pages faulted in and reused. Trade-off: freed memory stays with
    the process, and the setting cannot be undone in it.

    Disable with ``PYTEXTGCN_NO_MALLOPT=1``. Returns True if applied.
    """
    global _tuned
    if _tuned or os.environ.get("PYTEXTGCN_NO_MALLOPT") == "1":
        return _tuned
    if not sys.platform.startswith("linux"):
        return False
    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:
        return False
    libc.mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    libc.mallopt.restype = ctypes.c_int
    ok = libc.mallopt(_M_MMAP_THRESHOLD, 1 << 30) == 1
    ok = libc.mallopt(_M_MMAP_MAX, 0) == 1 and ok
    _tuned = bool(ok)
    return _tuned
