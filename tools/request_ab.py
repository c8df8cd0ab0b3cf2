"""Whole served requests with this checkout's stem and attention-context kernels against another checkout's, in turns.

    python tools/request_ab.py --other DIR [--pairs N]

DIR is another checkout (for example the parent commit unpacked under
build/). Its csrc/stem.cu and csrc/attention_context.cu are compiled with
nvcc for sm_90a (one process each, both at once) into libraries of their
own, and launched in place of this checkout's two kernels; everything
else is this checkout's, in one process on one NVIDIA GPU. DIR's two
kernels take the entry points that came before the stem's class table and
the context's att2 scratch: st_stem(dtype, layout, pool, x, w, t, out, B,
stream) and st_attention_context(dtype, feats, att1, h, wdec, bdec, wfull,
ctx, alpha, B, P, C, A, H, stream).

Two served paths of chip_smoke.py's flagships (ResNet-101, random weights
from seed 0, bf16, 64 images of 224 x 224): the pooled GRU's s2d greedy
request (one stem launch) and the attention GRU's beam request (K = 3;
one context launch, at step 0). For each, N pairs of requests, the two
sides' order alternating (this, other, other, this, ...), on the host
clock to ids on the host, each request's launch checked. The shared
host's slow spells hit both sides of a pair alike, so the paired
difference resolves what whole-run medians do not. Prints the card's
name and power limit, a line a path (each side's median, the median
paired difference with its quartiles, the pairs this side won) and a JSON
line.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="checkout whose stem.cu and attention_context.cu are the B side")
    ap.add_argument("--pairs", type=int, default=200, help="pairs of requests a path")
    args = ap.parse_args()
    other = os.path.abspath(args.other)
    sys.path.insert(0, HERE)
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import numpy as np
    import torch

    from show_tell_tpu_torch.models.captioner import CaptionerConfig, init_captioner
    from show_tell_tpu_torch.ops import attention as attn_mod, build, dtype_code, raise_on_error, stream_arg
    from show_tell_tpu_torch.ops import stem as stem_mod
    from show_tell_tpu_torch.serve import Captioner

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build.load_library()  # this checkout's library, while the other's two sources compile
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    csrc = os.path.join(other, "show_tell_tpu_torch", "csrc")
    procs = {}
    for name in ("stem", "attention_context"):
        so = os.path.join(build.BUILD_DIR, "libother_%s.%d.so" % (name, os.getpid()))
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-I", csrc, os.path.join(csrc, name + ".cu"), "-o", so]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        err = proc.communicate()[1]
        if proc.returncode != 0:
            sys.exit("nvcc failed on %s's %s.cu (exit %d): %s" % (other, name, proc.returncode, err))
        libs[name] = ctypes.CDLL(so)
        os.remove(so)  # loaded; nothing else reads it
    p, i = ctypes.c_void_p, ctypes.c_int
    libs["stem"].st_stem.argtypes = [i] * 3 + [p] * 4 + [i, p]
    libs["attention_context"].st_attention_context.argtypes = [i] + [p] * 8 + [i] * 5 + [p]

    def other_stem(images_u8, prepared, pool=True):
        layout = stem_mod._layout(images_u8)
        w, t, device = prepared["w"], prepared["t"], images_u8.device
        side = stem_mod.S2D_SIDE // 2 if pool else stem_mod.S2D_SIDE
        out = torch.empty(images_u8.shape[0], side, side, stem_mod.CHANNELS, dtype=w.dtype, device=device)
        err = libs["stem"].st_stem(dtype_code("stem_fused", w.dtype), layout, int(pool), images_u8.data_ptr(),
                                   w.data_ptr(), t.data_ptr(), out.data_ptr(), images_u8.shape[0], stream_arg(device))
        raise_on_error("stem_fused (other)", err)
        stem_mod.stem_fused.launches += 1
        return out

    def other_context(weights, feats_pm, att1, h):
        B, P, C = feats_pm.shape
        A, H = att1.shape[2], h.shape[1]
        ctx = torch.empty(B, C, dtype=feats_pm.dtype, device=feats_pm.device)
        alpha = torch.empty(B, P, dtype=torch.float32, device=feats_pm.device)
        err = libs["attention_context"].st_attention_context(
            dtype_code("attention_context", feats_pm.dtype), feats_pm.data_ptr(), att1.data_ptr(), h.data_ptr(),
            weights["wdec"].data_ptr(), weights["bdec"].data_ptr(), weights["wfull"].data_ptr(), ctx.data_ptr(),
            alpha.data_ptr(), B, P, C, A, H, stream_arg(feats_pm.device))
        raise_on_error("attention_context (other)", err)
        attn_mod.attention_context.launches += 1
        return ctx, alpha

    sides = {"this": (stem_mod.stem_fused_cuda, attn_mod.attention_context_cuda), "other": (other_stem, other_context)}

    def use(side):
        stem_mod.stem_fused_cuda, attn_mod.attention_context_cuda = sides[side]

    imgs = np.random.RandomState(cs.SEED + 1).randint(0, 256, (64, cs.IMG, cs.IMG, 3), dtype=np.uint8)
    report = {}
    for path, cfg, s2d, beam, counter in (
            ("s2d greedy request", CaptionerConfig("gru", 101, cs.E, cs.H, cs.V, cs.L), True, 0, stem_mod.stem_fused),
            ("attention beam request", CaptionerConfig("attn", 101, cs.AE, cs.H, cs.V, cs.L, nos_filters=cs.AC,
                                                       attn_dim=cs.AA), False, cs.K_BEAM,
             attn_mod.attention_context)):
        params, bn_state = init_captioner(cfg, torch.Generator().manual_seed(cs.SEED))
        cap = Captioner(params, bn_state, cfg, cs.SyntheticVocab(cs.V), "bfloat16", device="gpu", s2d=s2d)

        def request(side):
            use(side)
            counter.launches = 0
            t0 = time.perf_counter()
            ids = cap.caption_ids(imgs, beam)
            ms = 1e3 * (time.perf_counter() - t0)
            if counter.launches != 1:
                sys.exit("%s (%s side) launched %s %d times, expected 1" % (path, side, counter.__name__,
                                                                            counter.launches))
            return ms, ids

        ids = {side: request(side)[1] for side in sides}  # warm-up: cuDNN plans, allocator
        ms = {side: [] for side in sides}
        for k in range(args.pairs):
            for side in (("this", "other") if k % 2 == 0 else ("other", "this")):
                ms[side].append(request(side)[0])
        use("this")
        diff = [a - b for a, b in zip(ms["this"], ms["other"])]
        q1, q2, q3 = statistics.quantiles(diff, n=4)
        med = {side: statistics.median(v) for side, v in ms.items()}
        won = sum(d < 0 for d in diff)
        report[path] = {"this_ms": med["this"], "other_ms": med["other"], "diff_ms": [q1, q2, q3], "won": won,
                        "pairs": args.pairs, "ids_equal": float((ids["this"] == ids["other"]).mean())}
        print("%s bf16 B=64 %s, this checkout against %s, %d pairs in turns (host clock to ids on the host): median "
              "%.3f ms (%.1f captions/s) against %.3f ms (%.1f captions/s); this minus other, median %.3f ms "
              "[quartiles %.3f, %.3f]; this side faster in %d of %d pairs; ids of the two sides equal on %.4f of "
              "positions" % (smi, path, other, args.pairs, med["this"], 64e3 / med["this"], med["other"],
                             64e3 / med["other"], q2, q1, q3, won, args.pairs, report[path]["ids_equal"]),
              flush=True)
    print(json.dumps({"card": smi, "other": other, "paths": report}), flush=True)


if __name__ == "__main__":
    main()
