"""Build the port's CUDA kernels with ``nvcc`` at first use; bind with ctypes.

Each ``csrc/*.cu`` file has a plain ``extern "C"`` interface and is compiled
into a shared library, once per variant (a source may split its instances
across variants with ``-D`` flags, so that their builds run in parallel):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v [variant flags] -o <lib>.so csrc/<name>.cu

The libraries land in ``.torch_ext_build/`` at the repo root (git-ignored),
named by a hash of the source and the flags, so an edited source rebuilds
and an unchanged one is reused.
``build_all`` starts one ``nvcc`` per missing library, all at once, and waits
for every one.  A build or load failure raises: no caller falls back to a
plain version because a kernel is missing.
"""

import collections
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
    """One ``csrc`` source: its builds, its ctypes handles, and the launch
    count of its kernel.  ``signatures`` maps each exported C function to its
    ctypes argtypes, or to (argtypes, restype) for a function that launches
    nothing; a launching function returns the ``cudaError_t`` of its
    launch.  ``variants`` holds one tuple of extra ``nvcc`` flags per build
    of the source; a function is bound from whichever build exports it.

    ``launches`` counts launches per exported function (a ``Counter``): the
    op's wrapper adds one to its function's count where it launches the
    kernel, and nowhere else."""

    def __init__(self, source, signatures, variants=((),)):
        self.source = CSRC / source
        self.signatures = signatures
        self.variants = tuple(tuple(v) for v in variants)
        self.launches = collections.Counter()
        self._fns = None

    @property
    def so_paths(self):
        """One library path per variant, named by the content hash."""
        text = self.source.read_bytes()
        paths = []
        for i, extra in enumerate(self.variants):
            flags = " ".join(NVCC_FLAGS + extra).encode()
            digest = hashlib.sha256(text + flags).hexdigest()[:16]
            tag = f"-v{i}" if len(self.variants) > 1 else ""
            paths.append(BUILD_DIR / f"{self.source.stem}{tag}-{digest}.so")
        return paths

    def start_build(self):
        """Start ``nvcc`` for each variant not built yet -> list of
        (Popen, tmp path, library path)."""
        started = []
        for so, extra in zip(self.so_paths, self.variants):
            if so.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp), str(self.source)]
            started.append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True),
                            tmp, so))
        return started

    def finish_build(self, started):
        """Wait for every started ``nvcc``; raise if any failed."""
        errors = []
        for proc, tmp, so in started:
            log, _ = proc.communicate()
            so.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {so.name} "
                              f"(exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, so)
        if errors:
            raise RuntimeError("\n".join(errors))

    def lib(self):
        """The bound C functions by name, building the libraries first when
        needed."""
        if self._fns is None:
            build_all([self])
            fns = {}
            for so in self.so_paths:
                lib = ctypes.CDLL(str(so))
                for name, sig in self.signatures.items():
                    fn = getattr(lib, name, None)
                    if fn is not None and name not in fns:
                        argtypes, restype = sig if isinstance(sig, tuple) \
                            else (sig, ctypes.c_int)
                        fn.argtypes = argtypes
                        fn.restype = restype
                        fns[name] = fn
            missing = set(self.signatures) - set(fns)
            if missing:
                raise RuntimeError(f"{self.source.name}: no build exports "
                                   f"{sorted(missing)}")
            self._fns = fns
        return self._fns

    def call(self, name, *args):
        """Launch through C function ``name``; raises on a launch error."""
        err = self.lib()[name](*args)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def build_all(libraries):
    """Build every library that is not built yet, one ``nvcc`` each, all
    started together.  Returns the wall seconds spent."""
    t0 = time.perf_counter()
    started = [(lib, lib.start_build()) for lib in libraries]
    errors = []
    for lib, s in started:
        try:
            lib.finish_build(s)
        except RuntimeError as e:        # wait for every nvcc before raising
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0
