"""Build and load the port's hand-written CUDA kernels.

Each kernel source under vearch_tpu_torch/csrc/ is compiled with nvcc for
sm_90a into a shared library with a plain C interface, loaded with
ctypes. The library lands in vearch_tpu_torch/_build/ under a name that
carries a hash of the source and the flags, so an edited source rebuilds
and an unchanged one is loaded as it is. A build happens at first use,
on the machine with the GPU; a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from source on the machine with the GPU")
    return found


class CudaLibrary:
    """One csrc/ source built into one ctypes library.

    `functions` maps each exported C function to its argument types
    (`ctypes.c_void_p` for every pointer and the stream, or ctypes cuts
    them to 32 bits); every function returns a cudaError_t as int."""

    def __init__(self, source: str, functions: dict[str, list]):
        self.source = PKG / "csrc" / source
        self.functions = functions
        #: nvcc's output of this process's build (registers and shared
        #: memory per kernel, from -Xptxas -v); empty when the library
        #: was already built
        self.build_log = ""
        #: the built library's file, once loaded
        self.path = ""
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        """Build (if needed) and load the library; returns the handle."""
        with self._lock:
            if self._lib is None:
                self._lib = self._build_and_load()
            return self._lib

    def _build_and_load(self) -> ctypes.CDLL:
        src = self.source.read_bytes()
        digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
        so = BUILD_DIR / f"{self.source.stem}_{digest.hexdigest()[:16]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            t0 = time.monotonic()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.source)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed building {self.source.name}"
                                   f":\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
            self.build_log = (f"built {so.name} in "
                              f"{time.monotonic() - t0:.1f}s\n"
                              f"{proc.stdout}{proc.stderr}")
        self.path = str(so)
        lib = ctypes.CDLL(self.path)
        for name, argtypes in self.functions.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        return lib
