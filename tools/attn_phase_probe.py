"""Where the time of the f32 fused attention step goes on one NVIDIA GPU: a clock64 probe of its phases.

    python tools/attn_phase_probe.py [--batch 32,64] [--iters 20]

Builds tools/attn_phase_probe.cu (the step's own device code, included from
show_tell_tpu_torch/csrc/fused_attn_step.cu, with a clock64 stamp at every
phase boundary of every block) with nvcc beside the kernel library, and runs
it on f32 operands at the flagship widths (chip_smoke.attn_inputs: L=5,
E=H=A=512, P=49, V=9,956), greedy at B rows and dense at R = 3 B beam rows,
each cell, by route: 0 the SIMT code the f32 instances ran before the 3xTF32
tiles, in one launch, 1 the library's f32 instance (the attention's launch,
then the step's) and, for the GRU greedy step, route 1 with 2 route 0's
A1, 3 A1 on the 3xTF32 tiles, 4 A2 a block a row, 5 in one launch.  For
each phase (A1, A2's scores and context, each layer, the projection with
its end) and the gap between the launches: the time from the grid barrier
before it to the one after it (the mean over blocks, each block's clock
converted to us by block 0's %globaltimer over the launch) and the slowest
block's own work in it, medians over --iters launches after 3.  Beside them,
CUDA-event times (chip_smoke.event_median_ms) of the probe's launch and of
the library's instance (fused_attn_decode_step_cuda, fused_attn_dense_step_cuda).
Prints the card's name and power limit, one line a route, cell, end and
size, and a JSON line of every number.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUTES = {0: "SIMT, one launch (before)", 1: "the library: attention launch, then the 3xTF32 step",
          2: "the library with route 0's A1", 3: "the library with A1 on the 3xTF32 tiles",
          4: "the library with A2 a block a row", 5: "the library's phases in one launch"}
ATTN_KEYS = ("feats_e", "att1", "wdec", "bdec", "wfull", "b_emb")
HEADER, FIRST, MAX_BLOCKS = 8, 6, 132 * 16  # the stamps' layout (kHeader, kFirst, kMaxBlocks in the probe)


def phase_split(st, L):
    """{phase: (wall us, slowest block's work us)} of one launch's stamps (int64 numpy; the layout of
    attn_phase_probe.cu), with the gap between the two launches and their grids."""
    import numpy as np

    grid1, grid2 = int(st[0]), int(st[1])
    first = st[HEADER:HEADER + grid1 * FIRST].reshape(grid1, FIRST).astype(np.float64)
    at = HEADER + MAX_BLOCKS * FIRST
    second = st[at:at + grid2 * (2 * L + 2)].reshape(grid2, 2 * L + 2).astype(np.float64)
    out = {}
    for blocks, g0, g1, spans in (
            (first, 2, 3, [("A1", 0, 1, 2), ("A2 scores", 2, 3, 4), ("A2 context", 4, 5, None)]),
            (second, 4, 5, [("layer %d" % l, 2 * l, 2 * l + 1, 2 * l + 2) for l in range(L)]
             + [("projection", 2 * L, 2 * L + 1, None)])):
        us = (blocks[0, -1] - blocks[0, 0]) / ((st[g1] - st[g0]) / 1e3)  # block 0's cycles an us
        for name, begin, done, leave in spans:
            work = float((blocks[:, done] - blocks[:, begin]).max() / us)
            out[name] = (float((blocks[:, leave] - blocks[:, begin]).mean() / us) if leave else work, work)
    out["between launches"] = (float(st[4] - st[3]) / 1e3,) * 2
    out["total"] = (float(st[5] - st[2]) / 1e3,) * 2
    out["grids"] = (grid1, grid2)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", default="32,64", help="greedy rows B (the dense step at 3 B)")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import numpy as np
    import torch

    from show_tell_tpu_torch.ops import build
    from show_tell_tpu_torch.ops.fused_attn import fused_attn_decode_step_cuda, fused_attn_dense_step_cuda
    from show_tell_tpu_torch.ops.fused_step import layer_split

    if not torch.cuda.is_available():
        cs.fail("torch finds no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    so = os.path.join(build.BUILD_DIR, "libattn_phase_probe.%d.so" % os.getpid())
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-I", HERE,
           os.path.join(HERE, "tools", "attn_phase_probe.cu"), "-o", so]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    build.load_library()  # the library's nvcc processes run beside the probe's
    err = proc.communicate()[1]
    if proc.returncode != 0:
        cs.fail("nvcc failed on attn_phase_probe.cu (exit %d): %s" % (proc.returncode, err))
    lib = ctypes.CDLL(so)
    os.remove(so)
    entry = lib.st_attn_phase_probe
    entry.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 26 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    entry.restype = ctypes.c_int
    print(smi, flush=True)

    f32, device = torch.float32, torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(cs.SEED + 19)
    ptr = lambda t: None if t is None else t.data_ptr()
    results = []
    for B in (int(b) for b in args.batch.split(",")):
        for cell in ("gru", "lstm"):
            for dense in (False, True):
                R = cs.K_BEAM * B if dense else B
                prep, w_emb, state = cs.attn_inputs(rng, R, f32, device, cell)
                lstm = cell == "lstm"
                hs, c_in = state if lstm else (state, None)
                L, _, Hd = hs.shape
                _, P, E = prep["feats_e"].shape
                A, V = prep["att1"].shape[2], prep["vocab"]["w"].shape[0]
                x, att2 = torch.empty(R, 2 * E, device=device), torch.empty(R, A + P, device=device)
                new_hs, new_cs = torch.empty_like(hs), None if c_in is None else torch.empty_like(c_in)
                tok, best = torch.empty(R, dtype=torch.int32, device=device), torch.empty(R, dtype=torch.int64,
                                                                                           device=device)
                logits = torch.empty(R, V, device=device)
                partial, split_ptrs, split_ints = layer_split(R, 2 * E, Hd, device, f32)
                stamps = torch.zeros(HEADER + MAX_BLOCKS * (FIRST + 2 * L + 2), dtype=torch.int64, device=device)
                st, vo = prep["stacked"], prep["vocab"]
                library = fused_attn_dense_step_cuda if dense else fused_attn_decode_step_cuda
                lib_ms = cs.event_median_ms(lambda: library(prep, w_emb, state))
                for route in (tuple(ROUTES) if cell == "gru" and not dense else (0, 1)):
                    def run(route=route):
                        code = entry(route, int(lstm), int(dense), stamps.data_ptr(), w_emb.data_ptr(),
                                     *(prep[k].data_ptr() for k in ATTN_KEYS),
                                     *(st[k].data_ptr() for k in ("w_ih0", "w_ihU", "w_hh", "b_ih", "b_hh")),
                                     hs.data_ptr(), ptr(c_in), vo["w"].data_ptr(), vo["b"].data_ptr(), x.data_ptr(),
                                     att2.data_ptr(), new_hs.data_ptr(), ptr(new_cs), tok.data_ptr(), best.data_ptr(),
                                     logits.data_ptr(), *split_ptrs, L, R, E, Hd, A, P, V, *split_ints,
                                     torch.cuda.current_stream(device).cuda_stream)
                        if code:
                            cs.fail("st_attn_phase_probe route %d failed: CUDA error %d" % (route, code))

                    probe_ms = cs.event_median_ms(run)
                    splits = []
                    for it in range(3 + args.iters):
                        run()
                        if it >= 3:
                            splits.append(phase_split(stamps.cpu().numpy(), L))
                    med = {k: tuple(statistics.median(s[k][i] for s in splits) for i in (0, 1)) for k in splits[0]
                           if k != "grids"}
                    layers = sum(med["layer %d" % l][0] for l in range(L))
                    row = {"route": route, "route_name": ROUTES[route], "cell": cell, "end": "dense" if dense else
                           "argmax", "rows": R, "splits": split_ints[:2], "grids": splits[0]["grids"],
                           "probe_ms": probe_ms, "library_ms": lib_ms, "phases_us": med}
                    results.append(row)
                    print("%s f32 attention %s %s %s=%d route %d (%s): A1 %.2f us (slowest block %.2f), A2 scores "
                          "%.2f (%.2f), A2 context %.2f (%.2f), between the launches %.2f, layer 0 %.2f (%.2f), "
                          "layers 1-%d %.2f, layers in all %.2f, projection %.2f; start to end %.2f us (clock64 and "
                          "%%globaltimer, median of %d; grids %s, S = %s); probe launches %.4f ms, the library's "
                          "instance %.4f ms (CUDA events)"
                          % (smi, cell, row["end"], "R" if dense else "B", R, route, ROUTES[route], *med["A1"],
                             *med["A2 scores"], *med["A2 context"], med["between launches"][0], *med["layer 0"],
                             L - 1, layers - med["layer 0"][0], layers, med["projection"][0], med["total"][0],
                             args.iters, row["grids"], split_ints[:2], probe_ms, lib_ms), flush=True)
    print(json.dumps({"card": smi, "probe": results}), flush=True)


if __name__ == "__main__":
    main()
