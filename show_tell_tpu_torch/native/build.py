"""Build the port's two host libraries with g++ into shared libraries:

  fastimage    fastimage.cpp: libjpeg decode and PIL's antialiased bilinear
               resize (data/images.load_images, the loaders);
  fastmetrics  fastmetrics.cpp: the caption scorer behind
               evaluation/metrics.evaluate and the corpus-BLEU pass of
               evaluation/tester.test_model.

Each library is built at first use (``fastimage.is_available()``,
``fastmetrics.is_available()``) into ``build/show_tell_tpu_torch/`` at the
root of the checkout, as the CUDA kernels are.  Its name carries a hash of
the source, the flags and the host CPU that ``-march=native`` resolves to,
so an edited source or a checkout carried to another CPU builds anew and
never loads a stale or foreign library.  The flags are the JAX package's
(show_tell_tpu/native/build.py), so both decode to the same bytes and
score to the same floats: fastmetrics' ``-ffp-contract=off`` keeps every
rounding of the Python scorers (no FMA contraction, no -ffast-math).

    python -m show_tell_tpu_torch.native.build    # build both now, print the paths or why not
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from typing import Tuple

from show_tell_tpu_torch.ops.build import BUILD_DIR

HERE = os.path.dirname(os.path.abspath(__file__))
# name -> (g++ flags, link flags)
LIBRARIES = {
    "fastimage": (("-O3", "-march=native", "-shared", "-fPIC"), ("-ljpeg", "-lpthread")),
    "fastmetrics": (("-O3", "-march=native", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC"), ()),
}


def library_path(name: str = "fastimage") -> str:
    """Where library ``name`` for its source, its flags and this CPU lives.
    Raises OSError or subprocess.CalledProcessError where g++ cannot run."""
    flags, libs = LIBRARIES[name]
    target = subprocess.run(["g++", "-march=native", "-Q", "--help=target"], capture_output=True, text=True,
                            timeout=60, check=True).stdout
    h = hashlib.sha256(" ".join(flags + libs).encode() + b"\0" + target.encode() + b"\0")
    with open(os.path.join(HERE, name + ".cpp"), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, "lib%s_%s.so" % (name, h.hexdigest()[:16]))


def build(name: str = "fastimage") -> Tuple[str, str]:
    """Compile ``name``.cpp if its library is missing.  Returns (path, "")
    on success and ("", why) where g++ (or, for fastimage, libjpeg) is
    missing or the compile fails; never raises for those, since a Python
    path stands in for each (PIL; metrics.py's scorers)."""
    try:
        lib = library_path(name)
    except (OSError, subprocess.SubprocessError) as e:
        return "", "g++ cannot run: %s" % e
    if os.path.isfile(lib):
        return lib, ""
    flags, libs = LIBRARIES[name]
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (lib, os.getpid())
    cmd = ["g++", *flags, os.path.join(HERE, name + ".cpp"), "-o", tmp, *libs]
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
    ok = True
    for name in LIBRARIES:
        path, why = build(name)
        print("%s: %s" % (name, path or "not built: %s" % why))
        ok = ok and bool(path)
    sys.exit(0 if ok else 1)
