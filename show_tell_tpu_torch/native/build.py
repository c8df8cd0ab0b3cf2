"""Build the native JPEG decoder (fastimage.cpp: libjpeg decode and PIL's
antialiased bilinear resize) with g++ into a shared library.

The library is built at first use (``fastimage.is_available()``) into
``build/show_tell_tpu_torch/`` at the root of the checkout, as the CUDA
kernels are.  Its name carries a hash of the source, the flags and the
host CPU that ``-march=native`` resolves to, so an edited source or a
checkout carried to another CPU builds anew and never loads a stale or
foreign library.  The flags are the JAX package's
(show_tell_tpu/native/build.py), so both decode to the same bytes.

    python -m show_tell_tpu_torch.native.build    # build now, print the path or why not
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from typing import Tuple

from show_tell_tpu_torch.ops.build import BUILD_DIR

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fastimage.cpp")
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
LIBS = ("-ljpeg", "-lpthread")


def library_path() -> str:
    """Where the library for this source, these flags and this CPU lives.
    Raises OSError or subprocess.CalledProcessError where g++ cannot run."""
    target = subprocess.run(["g++", "-march=native", "-Q", "--help=target"], capture_output=True, text=True,
                            timeout=60, check=True).stdout
    h = hashlib.sha256(" ".join(FLAGS + LIBS).encode() + b"\0" + target.encode() + b"\0")
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, "libfastimage_%s.so" % h.hexdigest()[:16])


def build() -> Tuple[str, str]:
    """Compile fastimage.cpp if its library is missing.  Returns (path,
    "") on success and ("", why) where g++ or libjpeg is missing or the
    compile fails; never raises for those, since the PIL loader stands in."""
    try:
        lib = library_path()
    except (OSError, subprocess.SubprocessError) as e:
        return "", "g++ cannot run: %s" % e
    if os.path.isfile(lib):
        return lib, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (lib, os.getpid())
    cmd = ["g++", *FLAGS, SRC, "-o", tmp, *LIBS]
    try:
        result = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if result.returncode != 0:
            return "", "g++ failed (exit %d): %s" % (result.returncode, result.stderr.strip()[-500:])
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    except (OSError, subprocess.SubprocessError) as e:
        return "", "g++ failed: %s" % e
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib, ""


if __name__ == "__main__":
    path, why = build()
    print(path or "not built: %s" % why)
    sys.exit(0 if path else 1)
