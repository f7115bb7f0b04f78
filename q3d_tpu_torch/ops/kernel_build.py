"""Build the port's CUDA kernels with ``nvcc`` at first use; bind with ctypes.

Each ``csrc/*.cu`` file has a plain ``extern "C"`` interface and is compiled
on its own into a shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <lib>.so csrc/<name>.cu

The library lands in ``.torch_ext_build/`` at the repo root (git-ignored),
named by a hash of its source and flags, so an edited source rebuilds and an
unchanged one is reused.  ``build_all`` starts one ``nvcc`` per missing
library, all at once, and waits for every one.  A build or load failure
raises: no caller falls back to a plain version because a kernel is missing.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / ".torch_ext_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")]:
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from csrc/ at first use")


class CudaLibrary:
    """One ``csrc`` source: its build, its ctypes handle, and the launch count
    of its kernel.  ``signatures`` maps each exported C function to its
    ctypes argtypes; every function returns the ``cudaError_t`` of its launch.

    ``launches`` is a plain counter: the op's wrapper adds one where it
    launches the kernel, and nowhere else."""

    def __init__(self, source, signatures):
        self.source = CSRC / source
        self.signatures = signatures
        self.launches = 0
        self._lib = None

    @property
    def so_path(self):
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"{self.source.stem}-{digest}.so"

    def start_build(self):
        """Start ``nvcc`` for this library -> (Popen, tmp path), or None when
        the library is already built."""
        so = self.so_path
        if so.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp

    def finish_build(self, started):
        proc, tmp = started
        log, _ = proc.communicate()
        so = self.so_path
        so.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source.name} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, so)

    def lib(self):
        """The loaded library, building it first when needed."""
        if self._lib is None:
            build_all([self])
            lib = ctypes.CDLL(str(self.so_path))
            for name, argtypes in self.signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def call(self, name, *args):
        """Launch through C function ``name``; raises on a launch error."""
        err = getattr(self.lib(), name)(*args)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def build_all(libraries):
    """Build every library that is not built yet, one ``nvcc`` each, all
    started together.  Returns the wall seconds spent."""
    t0 = time.perf_counter()
    started = [(lib, lib.start_build()) for lib in libraries]
    errors = []
    for lib, s in started:
        if s is None:
            continue
        try:
            lib.finish_build(s)
        except RuntimeError as e:        # wait for every nvcc before raising
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0
