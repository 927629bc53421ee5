"""Build and load the port's native code.

Each kernel source under vearch_tpu_torch/csrc/ is compiled with nvcc for
sm_90a into a shared library with a plain C interface, loaded with
ctypes (`CudaLibrary`). The host-side HNSW graph (csrc/vearch_hnsw.cpp)
is a CPython extension module, compiled with g++ against the running
interpreter's headers and imported from its file (`HostExtension`).
Either lands in vearch_tpu_torch/_build/ under a name that carries a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one is loaded as it is. A build happens at first use, under a
lock, so two threads that launch at once build once; a failed build
raises. `count_launch` adds one to a wrapper's launch counter under a
lock, so launches from the batch scheduler's thread and the caller's
are all counted. Each build or load of a library is a compile event of
program `build.<source stem>` (ops/perf_model.note_program), with its
seconds, so the flight recorder sees a build that happens after warmup.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import tempfile
import threading
import time
from pathlib import Path

from vearch_tpu_torch.ops import perf_model

PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


_COUNT_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """One more launch of `wrapper`'s kernel (its `launches` attribute)."""
    with _COUNT_LOCK:
        wrapper.launches += 1


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
                t0 = time.perf_counter()
                self._lib = self._build_and_load()
                _note_build(self.source, self.path, t0)
            return self._lib

    def _build_and_load(self) -> ctypes.CDLL:
        self.path, self.build_log = _build(self.source, [_nvcc()],
                                           NVCC_FLAGS, "nvcc")
        lib = ctypes.CDLL(self.path)
        for name, argtypes in self.functions.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        return lib


class HostExtension:
    """One csrc/ C++ source built with g++ into a CPython extension module
    named `module` (its PyInit_<module>), built against this
    interpreter's headers and imported from the built file."""

    def __init__(self, source: str, module: str):
        self.source = PKG / "csrc" / source
        self.module = module
        self.build_log = ""
        self.path = ""
        self._mod = None
        self._lock = threading.Lock()

    def load(self):
        """Build (if needed) and import the module; returns it."""
        with self._lock:
            if self._mod is None:
                t0 = time.perf_counter()
                flags = ["-O3", "-shared", "-fPIC", "-std=c++17",
                         f"-I{sysconfig.get_paths()['include']}"]
                self.path, self.build_log = _build(self.source, ["g++"],
                                                   flags, "g++")
                spec = importlib.util.spec_from_file_location(self.module,
                                                              self.path)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                self._mod = mod
                _note_build(self.source, self.path, t0)
            return self._mod


def _note_build(source: Path, path: str, t0: float) -> None:
    perf_model.note_program(f"build.{source.stem}", Path(path).name,
                            (time.perf_counter() - t0) * 1e3)


def _build(source: Path, compiler: list[str], flags: list[str],
           name: str) -> tuple[str, str]:
    """Compile `source` into _build/<stem>_<hash>.so unless that file is
    there; returns (path, build log, empty when the file was reused)."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode())
    so = BUILD_DIR / f"{source.stem}_{digest.hexdigest()[:16]}.so"
    if so.exists():
        return str(so), ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.monotonic()
    proc = subprocess.run([*compiler, *flags, "-o", tmp, str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{name} failed building {source.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return str(so), (f"built {so.name} in {time.monotonic() - t0:.1f}s\n"
                     f"{proc.stdout}{proc.stderr}")
