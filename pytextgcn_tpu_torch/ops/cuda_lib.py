"""Build and load a hand-written CUDA kernel library.

Each kernel source under ``csrc/`` has a plain C entry point. It is compiled
with ``nvcc`` for ``sm_90a`` at first use into ``_build/cuda`` (listed in
.gitignore) and loaded with ctypes; nothing here runs on import.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Optional, Sequence

from ..utils import BUILD_DIR

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
OUT_DIR = os.path.join(BUILD_DIR, "cuda")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")
    return path


class CudaLibrary:
    """``csrc/<source>`` compiled into ``lib<stem><tag>.so``, exposing the C
    function ``symbol`` with ctypes ``argtypes``, and any of
    ``extra_symbols`` (name -> argtypes) by name; each returns a CUDA error
    code as int. ``flags`` are extra nvcc flags (a timing build's -D
    macros), built under their own ``tag``."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence,
                 flags: Sequence[str] = (), tag: str = "",
                 extra_symbols: Optional[Dict[str, Sequence]] = None):
        self.src = os.path.join(CSRC_DIR, source)
        self.so = os.path.join(OUT_DIR, f"lib{os.path.splitext(source)[0]}{tag}.so")
        self.symbol = symbol
        self.argtypes = {symbol: list(argtypes)}
        self.argtypes.update((name, list(a)) for name, a in (extra_symbols or {}).items())
        self.flags = list(flags)
        self._fns = {}
        self._lock = threading.Lock()

    def build(self, verbose: bool = False) -> str:
        """Compile the source if the library is missing or older than it.
        With ``verbose`` the compiler's output (register and spill counts
        from ``-Xptxas -v``) is returned; else ''."""
        with self._lock:
            stale = (not os.path.exists(self.so)
                     or os.path.getmtime(self.so) < os.path.getmtime(self.src))
            if not (stale or verbose):
                return ""
            os.makedirs(OUT_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=OUT_DIR)
            os.close(fd)
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                   "-O3", "-shared", "-Xcompiler", "-fPIC", *self.flags, "-o", tmp, self.src]
            if verbose:
                cmd[1:1] = ["-Xptxas", "-v"]
            try:
                res = subprocess.run(cmd, capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
                os.replace(tmp, self.so)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            return res.stdout + res.stderr

    def fn(self, symbol: Optional[str] = None):
        """The loaded C function ``symbol`` (default: the library's
        ``symbol``), built first if needed."""
        symbol = symbol or self.symbol
        if symbol not in self._fns:
            self.build()
            fn = getattr(ctypes.CDLL(self.so), symbol)
            fn.argtypes = self.argtypes[symbol]
            fn.restype = ctypes.c_int
            self._fns[symbol] = fn
        return self._fns[symbol]

    def launch(self, name: str, *args, symbol: Optional[str] = None) -> None:
        """Call the C function ``symbol`` (default: the library's
        ``symbol``); raise if it returns a CUDA error."""
        err = self.fn(symbol)(*args)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
