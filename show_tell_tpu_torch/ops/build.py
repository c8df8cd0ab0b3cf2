"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The kernels are ``show_tell_tpu_torch/csrc/*.cu``, each with a plain C
interface, and they share device code through ``csrc/*.cuh``.  At first
use each ``.cu`` is compiled for Hopper (``sm_90a``) by its own ``nvcc``,
all started together, and the objects are linked into one shared library
under ``build/show_tell_tpu_torch/`` at the root of the checkout.  The
library's file name carries a hash of every source under ``csrc/``
(``*.cu``, ``*.cuh``, ``*.h``) and of the flags, so an edited kernel or
header builds anew and a stale library is never loaded.  A missing
``nvcc`` or a failed build raises, with nvcc's own error output.

    python -m show_tell_tpu_torch.ops.build            # build now, print the path
    python -m show_tell_tpu_torch.ops.build --ptxas    # each kernel instance's registers and spills
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import sys
import tempfile
from typing import List, Optional

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "show_tell_tpu_torch")
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
SOURCE_SUFFIXES = (".cu", ".cuh", ".h")

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


def _sources(names: Optional[List[str]] = None):
    """The kernels to compile: every ``csrc/*.cu``, or those of ``names`` (file names)."""
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if names is not None:
        sources = [src for src in sources if os.path.basename(src) in names]
    if not sources:
        raise KernelBuildError("no CUDA sources under %s" % CSRC_DIR)
    return sources


def library_path() -> str:
    """Where the library for the current sources (kernels and headers) and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        if name.endswith(SOURCE_SUFFIXES):
            with open(os.path.join(CSRC_DIR, name), "rb") as f:
                h.update(name.encode() + b"\0" + f.read())
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
    objs = tmp + ".objs"
    os.makedirs(objs, exist_ok=True)
    try:
        compiles = []
        for src in _sources():
            obj = os.path.join(objs, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            compiles.append((cmd, obj, proc))
        errors = [proc.communicate()[1] for _, _, proc in compiles]  # wait for all of them
        for (cmd, _, proc), err in zip(compiles, errors):
            _raise_if_failed(cmd, proc.returncode, err)
        cmd = [nvcc, "-shared", "-o", tmp, *(obj for _, obj, _ in compiles)]
        result = subprocess.run(cmd, capture_output=True, text=True)
        _raise_if_failed(cmd, result.returncode, result.stderr)
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    finally:
        shutil.rmtree(objs, ignore_errors=True)
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def ptxas_report(names: Optional[List[str]] = None) -> List[str]:
    """Compile every source (or those of ``names``) once more with
    ``-Xptxas -v`` (the objects are thrown away) and return one line per
    kernel instance: its source, its name (demangled when the toolkit's
    cu++filt is there), the registers a thread uses, its stack frame and
    spill bytes."""
    nvcc = find_nvcc()
    found = []  # (source, mangled name, registers, "stack frame, spill stores, spill loads")
    with tempfile.TemporaryDirectory() as tmp:
        compiles = []
        for src in _sources(names):
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", src, "-o", os.path.join(tmp, os.path.basename(src) + ".o")]
            compiles.append((cmd, src, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        for cmd, src, proc in compiles:
            err = proc.communicate()[1]
            _raise_if_failed(cmd, proc.returncode, err)
            name, frame = None, "no stack frame"
            for line in err.splitlines():
                m = re.search(r"Function properties for (\S+)", line)
                if m:
                    name, frame = m.group(1), "no stack frame"
                elif "bytes stack frame" in line:
                    frame = line.strip()
                m = re.search(r"Used (\d+) registers", line)
                if m and name:
                    found.append((os.path.basename(src), name, int(m.group(1)), frame))
                    name = None
    names = [name for _, name, _, _ in found]
    demangler = os.path.join(os.path.dirname(nvcc), "cu++filt")
    if names and os.access(demangler, os.X_OK):
        out = subprocess.run([demangler], input="\n".join(names), capture_output=True, text=True).stdout.splitlines()
        if len(out) == len(names):
            names = [n.replace("(anonymous namespace)::", "") for n in out]
    return ["%s %s: %d registers, %s" % (src, name, regs, frame)
            for (src, _, regs, frame), name in zip(found, names)]


def _raise_if_failed(cmd, returncode: int, stderr: str) -> None:
    if returncode != 0:
        raise KernelBuildError("nvcc failed (exit %d): %s\n%s" % (returncode, " ".join(cmd), stderr))


def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the C signatures."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        signatures = {
            "st_fused_gru_step": [i] + [p] * 14 + [i] * 8 + [p],
            "st_fused_lstm_step": [i] + [p] * 16 + [i] * 8 + [p],
            "st_fused_gru_dense_step": [i] + [p] * 13 + [i] * 8 + [p],
            "st_fused_lstm_dense_step": [i] + [p] * 15 + [i] * 8 + [p],
            "st_fused_gru_topk_step": [i] + [p] * 16 + [i] * 10 + [p],
            "st_fused_lstm_topk_step": [i] + [p] * 18 + [i] * 10 + [p],
            "st_gru_stack_step": [i] + [p] * 10 + [i] * 7 + [p],
            "st_lstm_stack_step": [i] + [p] * 12 + [i] * 7 + [p],
            "st_whole_gru_decode": [i] + [p] * 15 + [i] * 9 + [p],
            "st_fused_attn_step": [i] + [p] * 22 + [i] * 10 + [p],
            "st_fused_attn_lstm_step": [i] + [p] * 24 + [i] * 10 + [p],
            "st_fused_attn_dense_step": [i] + [p] * 21 + [i] * 10 + [p],
            "st_fused_attn_lstm_dense_step": [i] + [p] * 23 + [i] * 10 + [p],
            "st_attention_context": [i] + [p] * 9 + [i] * 5 + [p],
            "st_project_argmax": [i] + [p] * 5 + [i] * 4 + [p],
            "st_project_topk": [i] + [p] * 7 + [i] * 6 + [p],
            "st_preprocess": [i, p, p, ll] + [f] * 7 + [p],
            "st_stem": [i] * 3 + [p] * 4 + [i, p],
        }
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, i
        _lib = lib
    return _lib


if __name__ == "__main__":
    print("\n".join(ptxas_report()) if "--ptxas" in sys.argv[1:] else build())
