"""Build the port's hand-written CUDA kernels with ``nvcc`` and load them.

Each kernel is one ``csrc/*.cu`` file with a plain C interface, compiled
for Hopper (``sm_90a``) into a shared library under ``build/kernels/`` at
the root of the checkout and bound with ``ctypes``.  A library is named by
the hash of its source and flags, so a changed source builds anew and an
unchanged one is built once.  :func:`build` starts one ``nvcc`` for each
library that is missing, all at once, and waits for them all.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
#: every kernel's flags; a kernel adds its own after these
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    """One CUDA source and the flags it is compiled with."""

    name: str
    source: Path
    extra_flags: tuple[str, ...] = ()

    @property
    def flags(self) -> tuple[str, ...]:
        return BASE_FLAGS + self.extra_flags

    @property
    def path(self) -> Path:
        tag = hashlib.sha256(self.source.read_bytes()
                             + " ".join(self.flags).encode()).hexdigest()
        return BUILD_DIR / f"lib{self.name}_{tag[:16]}.so"


@dataclasses.dataclass(frozen=True)
class BuildResult:
    library: KernelLibrary
    seconds: float  # 0.0 where the library already existed
    ptxas: str  # nvcc's ``-Xptxas=-v`` report (empty unless verbose)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built at "
                       "first use and need the CUDA toolkit")


def _compile(lib: KernelLibrary, nvcc: str, verbose: bool) -> BuildResult:
    tmp = lib.path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *lib.flags, "-o", str(tmp), str(lib.source)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {lib.source.name} "
                           f"({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib.path)
    return BuildResult(lib, seconds, proc.stderr.strip())


def build(*libraries: KernelLibrary, verbose: bool = False
          ) -> list[BuildResult]:
    """Compile every library that does not exist yet, one ``nvcc`` each,
    all started together.  With ``verbose``, ptxas reports each kernel's
    registers, shared memory and spills.  Raises if any build fails."""
    missing = [lib for lib in libraries if not lib.path.exists()]
    built = {}
    if missing:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with ThreadPoolExecutor(len(missing)) as pool:
            futures = [pool.submit(_compile, lib, nvcc, verbose)
                       for lib in missing]
            built = {f.result().library: f.result() for f in futures}
    return [built.get(lib, BuildResult(lib, 0.0, "")) for lib in libraries]


@functools.cache
def load(library: KernelLibrary) -> ctypes.CDLL:
    """The built library, loaded (built first where it is missing)."""
    build(library)
    return ctypes.CDLL(str(library.path))
