"""Build the package's native sources and load them with ``ctypes``.

Each kernel source in ``csrc/`` has a plain ``extern "C"`` interface (no
PyTorch headers, so a build takes seconds). It is compiled for ``sm_90a``
by ``nvcc`` (``KernelLibrary``; ``--split-compile=0`` spreads its optimizer
and ptxas over the host's cores: the same SASS, and attention.cu's 54
kernels build in about 37 s instead of 85 s on an 8-core H100 host), or for
the host by the C++ compiler (``HostLibrary``: the URDF scene compiler),
into ``_build/`` at first use,
under a name that carries a digest of the source and the flags, and
loaded as a shared library, with the compiler's log (for nvcc, ptxas's
registers and spills per kernel) kept beside it. ``build_all`` starts one
compiler per source at the same time. A failed build raises with the
compiler's log.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterable, List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
BASE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--split-compile=0", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared", "-pthread"]


class KernelLibrary:
    """One ``csrc/<name>.cu`` (or the CUDA source at ``source``) and the
    shared library built from it."""

    suffix, base_flags = ".cu", BASE_FLAGS

    def __init__(self, name: str, extra_flags: Optional[List[str]] = None,
                 source: Optional[os.PathLike] = None):
        self.name = name
        self.source = (Path(source) if source is not None
                       else CSRC_DIR / f"{name}{self.suffix}")
        self.flags = self.base_flags + list(extra_flags or [])
        self._lib = None

    def compiler(self) -> str:
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError(f"nvcc not found: {self.source} cannot be built")
        return nvcc

    def path(self) -> Path:
        digest = hashlib.sha1(self.source.read_bytes() + " ".join(self.flags).encode())
        return BUILD_DIR / f"lib{self.name}_{digest.hexdigest()[:12]}.so"

    def _start(self):
        """Start nvcc unless this source and these flags were built already;
        returns (process, temporary output) or None."""
        out = self.path()
        if out.exists():
            return None
        compiler = self.compiler()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([compiler, *self.flags, "-o", str(tmp), str(self.source)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        return proc, tmp

    def _finish(self, started) -> str:
        log_path = self.path().with_suffix(".log")
        if started is None:
            return log_path.read_text() if log_path.exists() else ""
        proc, tmp = started
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(proc.args[0]).name} failed on {self.source} "
                               f"({proc.returncode}):\n{stdout}{stderr}")
        log_path.write_text(stdout + stderr)
        os.replace(tmp, self.path())
        return stdout + stderr

    def build(self) -> str:
        """Compile the source unless it was built already; returns the
        compiler's log of the build."""
        return self._finish(self._start())

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            self.build()
            self._lib = ctypes.CDLL(str(self.path()))
        return self._lib


class HostLibrary(KernelLibrary):
    """One ``csrc/<name>.cpp`` built for the host by the C++ compiler on
    PATH (``g++``, else ``c++``: the one nvcc takes as its host compiler)
    with the flags of the JAX package's ``native/Makefile``. ``$CXX`` is not
    read: a compiler that links its own static C++ runtime gives a library
    that crashes inside a process whose C++ runtime PyTorch has loaded."""

    suffix, base_flags = ".cpp", HOST_FLAGS

    def compiler(self) -> str:
        for cxx in ("g++", "c++"):
            path = shutil.which(cxx)
            if path:
                return path
        raise RuntimeError(f"no C++ compiler (g++, c++) on PATH: {self.source} cannot be built")


def build_all(libraries: Iterable[KernelLibrary]) -> List[str]:
    """Build several libraries side by side (one source may be built with
    several sets of flags); returns their compilers' logs in the same
    order."""
    libraries = list(libraries)
    started = []
    try:
        for lib in libraries:
            started.append(lib._start())
        return [lib._finish(s) for lib, s in zip(libraries, started)]
    finally:
        for s in started:                  # a failure leaves no compiler running
            if s is not None and s[0].poll() is None:
                s[0].kill()
