"""Build the package's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each kernel source in ``csrc/`` has a plain ``extern "C"`` interface (no
PyTorch headers, so a build takes seconds). It is compiled for ``sm_90a``
into ``_build/`` at first use, under a name that carries a digest of the
source and the flags, and loaded as a shared library, with nvcc's log
(ptxas's registers and spills per kernel) kept beside it. ``build_all``
starts one ``nvcc`` per source at the same time.
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class KernelLibrary:
    """One ``csrc/<name>.cu`` (or the CUDA source at ``source``) and the
    shared library built from it."""

    def __init__(self, name: str, extra_flags: Optional[List[str]] = None,
                 source: Optional[os.PathLike] = None):
        self.name = name
        self.source = Path(source) if source is not None else CSRC_DIR / f"{name}.cu"
        self.flags = BASE_FLAGS + list(extra_flags or [])
        self._lib = None

    def path(self) -> Path:
        digest = hashlib.sha1(self.source.read_bytes() + " ".join(self.flags).encode())
        return BUILD_DIR / f"lib{self.name}_{digest.hexdigest()[:12]}.so"

    def _start(self):
        """Start nvcc unless this source and these flags were built already;
        returns (process, temporary output) or None."""
        out = self.path()
        if out.exists():
            return None
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError(f"nvcc not found: {self.source} cannot be built")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc, *self.flags, "-o", str(tmp), str(self.source)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        return proc, tmp

    def _finish(self, started) -> str:
        log_path = self.path().with_suffix(".log")
        if started is None:
            return log_path.read_text() if log_path.exists() else ""
        proc, tmp = started
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source} "
                               f"({proc.returncode}):\n{stderr}")
        log_path.write_text(stdout + stderr)
        os.replace(tmp, self.path())
        return stdout + stderr

    def build(self) -> str:
        """Compile the source unless it was built already; returns nvcc's
        log of the build."""
        return self._finish(self._start())

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            self.build()
            self._lib = ctypes.CDLL(str(self.path()))
        return self._lib


def build_all(libraries: Iterable[KernelLibrary]) -> List[str]:
    """Build several libraries side by side (one source may be built with
    several sets of flags); returns their nvcc logs in the same order."""
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
