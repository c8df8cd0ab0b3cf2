"""How far the f32 fused stem lands from its twin and from f64 on one NVIDIA GPU.

    python tools/stem_precision.py [--root DIR] [--variant fresh-sums]

Imports show_tell_tpu_torch from DIR (default: this checkout), so that one
script measures two checkouts alike, each in its own process, and runs its
f32 stem (stem_fused_cuda) on chip_smoke.py's stem operands
(chip_smoke.stem_stub: kaiming-scaled conv1, BN off the identity) and on
uint8 images of one seed at B = 1, 32 and 64, RGB and s2d layouts, pool on
and off.  For each: the largest error against the plain twin
(stem_fused_plain) and against the f64 evaluation of the same sums
(stem_fused_f64), and the twin's own against f64.

--variant fresh-sums also builds, with nvcc beside the library, a copy of
DIR's csrc/stem.cu whose k8 steps sum their two products (x lo, x hi) from
zero and add them to the f32 sums by an f32 add (the order of the 3xTF32
kernels, which the tensor cores' truncating accumulation forced there), and
runs it on the same inputs: whether the stem needs that order.

Prints the card's name and power limit, one line a case, and a JSON line
of every number.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name -> (text of csrc/stem.cu's conv_rows_tf32, its replacement)
VARIANTS = {
    "fresh-sums": (
        "#pragma unroll\n"
        "        for (int j = 0; j < kRows; ++j)\n"
        "#pragma unroll\n"
        "          for (int h = 0; h < 2; ++h) mma_tf32_1688(acc[j][2 * np + h], af[j], bl[2 * h], bl[2 * h + 1]);\n"
        "#pragma unroll\n"
        "        for (int j = 0; j < kRows; ++j)\n"
        "#pragma unroll\n"
        "          for (int h = 0; h < 2; ++h) mma_tf32_1688(acc[j][2 * np + h], af[j], bh[2 * h], bh[2 * h + 1]);\n",
        "#pragma unroll\n"
        "        for (int j = 0; j < kRows; ++j)\n"
        "#pragma unroll\n"
        "          for (int h = 0; h < 2; ++h) {\n"
        "            float d[4];\n"
        "            mma_tf32_1688_zero(d, af[j], bl[2 * h], bl[2 * h + 1]);\n"
        "            mma_tf32_1688(d, af[j], bh[2 * h], bh[2 * h + 1]);\n"
        "#pragma unroll\n"
        "            for (int e = 0; e < 4; ++e) acc[j][2 * np + h][e] += d[e];\n"
        "          }\n",
    ),
}


def variant_library(cs, root, variant):
    """The stem of DIR with the variant's edit, built into a library of its own; returns its st_stem."""
    from show_tell_tpu_torch.ops import build

    csrc = os.path.join(root, "show_tell_tpu_torch", "csrc")
    old, new = VARIANTS[variant]
    source = open(os.path.join(csrc, "stem.cu")).read()
    if source.count(old) != 1:
        cs.fail("csrc/stem.cu of %s no longer holds the text that variant %s edits" % (root, variant))
    workdir = os.path.join(build.BUILD_DIR, "stem_precision.%d" % os.getpid())
    os.makedirs(workdir, exist_ok=True)
    for header in ("vocab_mma.cuh", "decode_common.cuh"):
        shutil.copy(os.path.join(csrc, header), workdir)
    path = os.path.join(workdir, "stem.cu")
    open(path, "w").write(source.replace(old, new))
    so = os.path.join(workdir, "libstem_%s.so" % variant)
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", path, "-o", so]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        cs.fail("nvcc failed on the %s variant of stem.cu (exit %d): %s" % (variant, proc.returncode,
                                                                            proc.stderr.strip()[-2000:]))
    entry = ctypes.CDLL(so).st_stem
    entry.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    entry.restype = ctypes.c_int
    return entry


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="checkout whose show_tell_tpu_torch is measured")
    ap.add_argument("--variant", choices=sorted(VARIANTS), help="also measure a variant of the checkout's stem.cu")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import numpy as np
    import torch

    import show_tell_tpu_torch
    from show_tell_tpu_torch.ops import stream_arg
    from show_tell_tpu_torch.ops.s2d_stem import space_to_depth
    from show_tell_tpu_torch.ops.stem import prepare_stem, stem_fused_cuda, stem_fused_f64, stem_fused_plain

    if not show_tell_tpu_torch.__file__.startswith(root + os.sep):
        cs.fail("show_tell_tpu_torch came from %s, not from %s" % (show_tell_tpu_torch.__file__, root))
    if not torch.cuda.is_available():
        cs.fail("torch finds no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    variant = variant_library(cs, root, args.variant) if args.variant else None
    rng = np.random.RandomState(cs.SEED + 19)
    prepared = prepare_stem(cs.stem_stub(rng, device), torch.float32)
    rgb64 = cs.u8_images(rng, (64, cs.IMG, cs.IMG, 3), device)
    err = lambda a, b: (a.double() - b.double()).abs().max().item()
    rows = {}
    torch.backends.cudnn.allow_tf32 = False
    for B in (1, 32, 64):
        for layout in ("rgb", "s2d"):
            x = rgb64[:B] if layout == "rgb" else space_to_depth(rgb64[:B]).contiguous()
            for pool in (True, False):
                got = stem_fused_cuda(x, prepared, pool)
                twin = stem_fused_plain(x, prepared, pool)
                exact = stem_fused_f64(x, prepared, pool)
                row = {"twin": err(got, twin), "f64": err(got, exact), "twin_f64": err(twin, exact),
                       "max_abs": exact.abs().max().item()}
                line = ("%s float32 stem B=%d %s %s from %s: max_abs_err against the twin %.3g, against f64 %.3g; "
                        "the twin against f64 %.3g; |f64| <= %.3g" % (smi, B, layout, "pool" if pool else "no pool",
                                                                       root, row["twin"], row["f64"], row["twin_f64"],
                                                                       row["max_abs"]))
                if variant is not None:
                    out = torch.empty_like(got)
                    rc = variant(0, int(layout == "rgb"), int(pool), x.data_ptr(), prepared["w"].data_ptr(),
                                 prepared["tc"].data_ptr(), out.data_ptr(), B, stream_arg(device))
                    torch.cuda.synchronize()
                    if rc != 0:
                        cs.fail("the %s variant of the stem failed: cudaError %d" % (args.variant, rc))
                    row[args.variant] = {"twin": err(out, twin), "f64": err(out, exact),
                                         "equal": bool(torch.equal(out, got))}
                    line += "; %s: against the twin %.3g, against f64 %.3g%s" % (
                        args.variant, row[args.variant]["twin"], row[args.variant]["f64"],
                        ", bit-equal to the kernel" if row[args.variant]["equal"] else "")
                rows["%s B=%d %s" % (layout, B, "pool" if pool else "no pool")] = row
                print(line, flush=True)
    print(json.dumps({"root": root, "card": smi, "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
