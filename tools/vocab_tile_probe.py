"""Where the time of the projection kernels' V-tiles goes on one NVIDIA GPU: a clock64 probe of project_tiles.

    python tools/vocab_tile_probe.py [--rows 1,32,64] [--iters 20] [--dtypes float32,bfloat16] [--variant NAME]

Builds tools/vocab_tile_probe.cu (project_argmax.cu's and project_topk.cu's
kernels, their device code included from vocab_mma.cuh, with an end that
sums thread 0's clock64 cycles between project_tiles' marks in every block)
with nvcc beside the kernel library, and runs it at the flagship widths
(H = 512, V = 9,956, chip_smoke.vocab_inputs), f32 and bf16, the argmax
kernel at B rows and the top-k kernel (k = 3) at R = 3 B, at the V-tiles
vocab_tiles gives on the card.  For each: the mean over blocks of the
cycles each block spent waiting for its chunks (the cp.async wait and the
barrier after it), issuing copies, in the products, staging logits and in
the end's scan, then the grid barrier after project_tiles and the phase
after it (the tokens, or merge_topk), converted to us by block 0's
%globaltimer; medians over --iters launches after 3.  Beside them, CUDA-
event times (chip_smoke.event_median_ms) of the probe's launch and of the
library's kernel on the same operands.  Prints the card's name and power
limit, one line a kernel, dtype and size, and a JSON line of every number.

--variant builds the probe on a copy of csrc/vocab_mma.cuh with one edit
(VARIANTS; the f32 instances' results are then not the library's, only
their times are read): no-products skips the f32 products of whole
chunks (the memory pipeline and the ends alone), no-weights copies only
the weight tile's first chunk (the products and the ring alone), cvt-split
splits by cvt.rna.tf32.f32 in place of its integer rounding.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAMPS = 13  # kStamps of the probe
PHASES = ("tile start", "waiting for chunks", "issuing copies", "products", "staging logits", "end scan")
# name -> (text of csrc/vocab_mma.cuh, its replacement)
VARIANTS = {
    "no-products": ("            tf32x3_products<S::kChunk / kStep>(acc, cnt, nts, b_at, a_at, a_step);\n",
                    "            (void)cnt;\n"),
    "no-weights": ("        if (g == 0) {\n", "        if (s == 0) {\n"),
    "cvt-split": ("  big = (v + 0x1000u) & 0xffffe000u;\n"
                  "  small = (__float_as_uint(__uint_as_float(v) - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;\n",
                  '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(__uint_as_float(v)));\n'
                  '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(__uint_as_float(v) - __uint_as_float(big)));\n'),
}


def probe_source(variant, workdir):
    """The probe's source: tools/vocab_tile_probe.cu, or for a variant a copy of it in ``workdir`` beside copies of
    the headers it includes, vocab_mma.cuh with the variant's edit."""
    source = os.path.join(HERE, "tools", "vocab_tile_probe.cu")
    if variant is None:
        return source
    csrc = os.path.join(HERE, "show_tell_tpu_torch", "csrc")
    old, new = VARIANTS[variant]
    header = open(os.path.join(csrc, "vocab_mma.cuh")).read()
    if header.count(old) != 1:
        raise SystemExit("vocab_mma.cuh no longer holds the text that variant %s edits" % variant)
    os.makedirs(workdir, exist_ok=True)
    open(os.path.join(workdir, "vocab_mma.cuh"), "w").write(header.replace(old, new))
    shutil.copy(os.path.join(csrc, "decode_common.cuh"), workdir)
    probe = open(source).read().replace("../show_tell_tpu_torch/csrc/", "")
    source = os.path.join(workdir, "vocab_tile_probe.cu")
    open(source, "w").write(probe)
    return source


def split(st, grid):
    """{phase: us} of one launch's stamps (int64 numpy, [grid, STAMPS]): the mean over blocks."""
    import numpy as np

    st = st[:grid * STAMPS].reshape(grid, STAMPS).astype(np.float64)
    per_us = (st[0, 10] - st[0, 6]) / ((st[0, 12] - st[0, 11]) / 1e3)  # block 0's cycles an us
    mean = lambda v: float(v.mean() / per_us)
    out = {name: mean(st[:, i]) for i, name in enumerate(PHASES)}
    out["before project_tiles"] = mean(st[:, 7] - st[:, 6])
    out["project_tiles"] = mean(st[:, 8] - st[:, 7])
    out["grid barrier"] = mean(st[:, 9] - st[:, 8])
    out["after the barrier"] = mean(st[:, 10] - st[:, 9])
    out["kernel"] = float((st[0, 12] - st[0, 11]) / 1e3)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", default="1,32,64", help="argmax rows B (the top-k kernel at 3 B)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--variant", choices=sorted(VARIANTS), help="one edit of the device code (see above)")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    from show_tell_tpu_torch.ops import build
    from show_tell_tpu_torch.ops.vocab import project_argmax_cuda, project_topk_cuda, vocab_tiles

    if not torch.cuda.is_available():
        cs.fail("torch finds no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    so = os.path.join(build.BUILD_DIR, "libvocab_tile_probe.%d.so" % os.getpid())
    workdir = os.path.join(build.BUILD_DIR, "vocab_tile_probe.%d" % os.getpid())
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", probe_source(args.variant, workdir), "-o", so]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    build.load_library()  # the library's nvcc processes run beside the probe's
    err = proc.communicate()[1]
    if proc.returncode != 0:
        cs.fail("nvcc failed on vocab_tile_probe.cu (exit %d): %s" % (proc.returncode, err))
    lib = ctypes.CDLL(so)
    os.remove(so)
    shutil.rmtree(workdir, ignore_errors=True)
    entry = lib.st_vocab_tile_probe
    entry.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    entry.restype = ctypes.c_int
    print(smi, flush=True)

    import numpy as np

    device = torch.device("cuda", 0)
    rng = np.random.RandomState(cs.SEED + 23)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    results = []
    for dtype in (getattr(torch, name) for name in args.dtypes.split(",")):
        vocab = cs.vocab_inputs(rng, cs.H, dtype, device)
        g = vocab_tiles(cs.H, cs.V, sms, dtype)
        for B in (int(b) for b in args.rows.split(",")):
            for topk in (False, True):
                R = cs.K_BEAM * B if topk else B
                top = cs.uniform(rng, (R, cs.H), 1.0, dtype, device)
                i32 = lambda *s: torch.empty(s, dtype=torch.int32, device=device)
                tok, best = i32(R), torch.empty(R, dtype=torch.int64, device=device)
                keys = torch.empty(g.tiles, R, cs.K_BEAM, dtype=torch.int64, device=device)
                ms = torch.empty(g.tiles, R, 2, dtype=torch.float32, device=device)
                logp, ids = torch.empty(R, cs.K_BEAM, device=device), i32(R, cs.K_BEAM)
                stamps = torch.zeros(g.tiles * STAMPS, dtype=torch.int64, device=device)

                def run():
                    code = entry(0 if dtype == torch.float32 else 1, int(topk), top.data_ptr(), vocab["w"].data_ptr(),
                                 vocab["b"].data_ptr(), tok.data_ptr(), best.data_ptr(), keys.data_ptr(),
                                 ms.data_ptr(), logp.data_ptr(), ids.data_ptr(), stamps.data_ptr(), R, cs.H, cs.V,
                                 cs.K_BEAM, g.mv, torch.cuda.current_stream(device).cuda_stream)
                    if code:
                        cs.fail("st_vocab_tile_probe failed: CUDA error %d" % code)

                library = ((lambda: project_topk_cuda(vocab, top, cs.K_BEAM)) if topk
                           else (lambda: project_argmax_cuda(vocab, top)))
                lib_ms, probe_ms = cs.event_median_ms(library), cs.event_median_ms(run)
                splits = []
                for it in range(3 + args.iters):
                    run()
                    if it >= 3:
                        splits.append(split(stamps.cpu().numpy(), g.tiles))
                med = {k: statistics.median(s[k] for s in splits) for k in splits[0]}
                name = "project_topk" if topk else "project_argmax"
                row = {"kernel": name, "dtype": cs.dname(dtype), "rows": R, "mv": g.mv, "tiles": g.tiles,
                       "variant": args.variant, "us": med, "probe_ms": probe_ms, "library_ms": lib_ms}
                results.append(row)
                print("%s %s %s %s=%d (mv %d, %d tiles; %s): %s; kernel start to end %.2f us (clock64 and "
                      "%%globaltimer, median of %d); probe launch %.4f ms, the library's kernel %.4f ms (CUDA events)"
                      % (smi, name, cs.dname(dtype), "R" if topk else "B", R, g.mv, g.tiles,
                         "variant " + args.variant if args.variant else "the library's device code",
                         ", ".join("%s %.2f us" % (k, med[k]) for k in ("before project_tiles", "project_tiles",
                                                                        *PHASES, "grid barrier",
                                                                        "after the barrier")),
                         med["kernel"], args.iters, probe_ms, lib_ms), flush=True)
    print(json.dumps({"card": smi, "probe": results}), flush=True)


if __name__ == "__main__":
    main()
