"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources are ``show_tell_tpu_torch/csrc/*.cu``, each with a plain C
interface.  They are compiled together, at first use, into one shared
library for Hopper (``sm_90a``) under ``build/show_tell_tpu_torch/`` at
the root of the checkout.  The library's file name carries a hash of the
sources and the flags, so an edited source builds anew and a stale
library is never loaded.  A missing ``nvcc`` or a failed build raises,
with nvcc's own error output.

    python -m show_tell_tpu_torch.ops.build    # build now, print the path
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Optional

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "show_tell_tpu_torch")
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lib: Optional[ctypes.CDLL] = None


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's usual place."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc"))
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and %s/bin); the CUDA "
        "kernels of show_tell_tpu_torch build only where the CUDA toolkit is "
        "installed" % DEFAULT_CUDA_HOME
    )


def _sources():
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not sources:
        raise KernelBuildError("no CUDA sources under %s" % CSRC_DIR)
    return sources


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, "libst_kernels_%s.so" % h.hexdigest()[:16])


def build() -> str:
    """Compile the sources if the library for their hash is missing.
    Returns the library's path."""
    lib = library_path()
    if os.path.isfile(lib):
        return lib
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (lib, os.getpid())
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *_sources()]
    result = subprocess.run(cmd, capture_output=True, text=True)
    if result.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise KernelBuildError(
            "nvcc failed (exit %d): %s\n%s" % (result.returncode, " ".join(cmd), result.stderr)
        )
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the C signatures."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.st_fused_gru_step.argtypes = [i, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, p]
        lib.st_fused_gru_step.restype = i
        _lib = lib
    return _lib


if __name__ == "__main__":
    print(build())
