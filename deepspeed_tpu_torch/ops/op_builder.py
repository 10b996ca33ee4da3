"""Build and load the port's hand-written CUDA kernels.

Counterpart of ``deepspeed_tpu/ops/op_builder.py``. Each kernel source under
``ops/csrc/`` exposes a plain C function; ``nvcc`` compiles it for Hopper
(``sm_90a``) into a shared library that ``ctypes`` loads. Nothing here
includes PyTorch's headers, so a build takes seconds. Libraries land in
``ops/build/`` (listed in ``.gitignore``) under a name keyed by a hash of the
source, the shared ``.cuh`` headers and the flags: an unchanged source is
never rebuilt, and a changed source or header never loads a stale library.
``nvcc``'s output (ptxas's registers and spills for every kernel) is kept
beside each library, so a library loaded from the build directory reports it
as one just built does.

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
        """The library's path, keyed by the source, every ``.cuh`` header
        under ``csrc/`` (a source may include any of them) and the flags."""
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
        for path in [self.source] + [os.path.join(CSRC_DIR, f) for f in headers]:
            with open(path, "rb") as fh:
                digest.update(os.path.basename(path).encode() + b"\0" + fh.read())
        return os.path.join(BUILD_DIR, f"{self.name}-{digest.hexdigest()[:16]}.so")

    def load(self) -> ctypes.CDLL:
        """Build the library unless it and its compiler output exist, then
        load it (once); :attr:`compiler_output` is nvcc's output either way."""
        if self._lib is None:
            path = self.lib_path()
            log = f"{os.path.splitext(path)[0]}.log"
            if not (os.path.exists(path) and os.path.exists(log)):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{path}.tmp{os.getpid()}"
                t0 = time.perf_counter()
                proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, self.source],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                self.build_seconds = time.perf_counter() - t0
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {self.source}:\n{proc.stdout}")
                with open(f"{log}.tmp{os.getpid()}", "w") as fh:
                    fh.write(proc.stdout)
                # atomic, the log first: a library on disk always has its log
                os.replace(f"{log}.tmp{os.getpid()}", log)
                os.replace(tmp, path)
            with open(log) as fh:
                self.compiler_output = fh.read()
            self._lib = ctypes.CDLL(path)
        return self._lib
