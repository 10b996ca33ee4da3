"""Build and load the port's hand-written CUDA kernels.

Counterpart of ``deepspeed_tpu/ops/op_builder.py``. Each kernel source under
``ops/csrc/`` exposes a plain C function; ``nvcc`` compiles it for Hopper
(``sm_90a``) into a shared library that ``ctypes`` loads. Nothing here
includes PyTorch's headers, so a build takes seconds. Libraries land in
``ops/build/`` (listed in ``.gitignore``) under a name keyed by a hash of the
source and the flags: an unchanged source is never rebuilt, and a changed one
never loads a stale library.

Every kernel wrapper counts its launches in :data:`LAUNCHES` (one per kernel
launch, nowhere else), so a caller can show that a run went through the
kernel: set the counts to 0 with :func:`reset_launch_counts`, run, and read
them back.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Optional

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# kernel name -> launches since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda``'s,
    else the one on PATH. Raises when there is none (no silent CPU path)."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


class CudaKernelLib:
    """One ``.cu`` source built into one shared library."""

    def __init__(self, source: str):
        self.source = os.path.join(CSRC_DIR, source)
        self.name = os.path.splitext(source)[0]
        self._lib: Optional[ctypes.CDLL] = None
        self.build_seconds = 0.0
        self.compiler_output = ""

    def lib_path(self) -> str:
        with open(self.source, "rb") as fh:
            digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return os.path.join(BUILD_DIR, f"{self.name}-{digest[:16]}.so")

    def load(self) -> ctypes.CDLL:
        """Build the library unless it exists, then load it (once)."""
        if self._lib is None:
            path = self.lib_path()
            if not os.path.exists(path):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{path}.tmp{os.getpid()}"
                t0 = time.perf_counter()
                proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, self.source],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                self.compiler_output = proc.stdout
                self.build_seconds = time.perf_counter() - t0
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {self.source}:\n{proc.stdout}")
                os.replace(tmp, path)  # atomic: readers never see a partial file
            self._lib = ctypes.CDLL(path)
        return self._lib
