"""Greedy captions/s at B=64 of the PyTorch port's flagship families on one NVIDIA GPU.

    python tools/greedy_rate.py [--root DIR] [--rounds N] [--variants gru,lstm,attn,attn_lstm]

Imports show_tell_tpu_torch from DIR (default: this checkout), so that one
script times two checkouts alike, each in its own process.  Each family's
bf16 Captioner is built as chip_smoke.py builds it (ResNet-101, random
weights from seed 0, a synthetic vocabulary of 9,956 words, the flagship
widths) and serves three requests of 64 random 224 x 224 images through
chip_smoke.greedy_rates: one warm-up request, then N rounds of the three,
the families in turns, each request timed alone on the host clock to ids
on the host.  Prints the card's name and power limit, one line a family
(median [min, max] captions/s) and a JSON line of every request's rate.
"""

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="checkout whose show_tell_tpu_torch is timed")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--variants", default="gru,lstm,attn,attn_lstm")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import numpy as np
    import torch

    import show_tell_tpu_torch
    from show_tell_tpu_torch.models.captioner import CaptionerConfig, init_captioner
    from show_tell_tpu_torch.serve import Captioner

    if not show_tell_tpu_torch.__file__.startswith(root + os.sep):
        cs.fail("show_tell_tpu_torch came from %s, not from %s" % (show_tell_tpu_torch.__file__, root))
    if not torch.cuda.is_available():
        cs.fail("torch finds no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    vocab = cs.SyntheticVocab(cs.V)
    img_rng = np.random.RandomState(cs.SEED + 1)
    served = {}
    for variant in args.variants.split(","):
        if variant.startswith("attn"):
            cfg = CaptionerConfig(variant, 101, cs.AE, cs.H, cs.V, cs.L, nos_filters=cs.AC, attn_dim=cs.AA)
        else:
            cfg = CaptionerConfig(variant, 101, cs.LE if variant == "lstm" else cs.E, cs.H, cs.V, cs.L)
        params, bn_state = init_captioner(cfg, torch.Generator().manual_seed(cs.SEED))
        cap = Captioner(params, bn_state, cfg, vocab, "bfloat16", device="gpu")
        served[variant] = (cap, [img_rng.randint(0, 256, (64, cs.IMG, cs.IMG, 3), dtype=np.uint8) for _ in range(3)])
    rates = cs.greedy_rates(served, args.rounds)
    print(smi, flush=True)
    for variant, per_s in rates.items():
        print("%s greedy bf16 B=64 from %s: %.1f captions/s, median [min, max] [%.1f, %.1f] of %d requests"
              % (variant, root, statistics.median(per_s), min(per_s), max(per_s), len(per_s)), flush=True)
    print(json.dumps({"root": root, "card": smi, "rates": rates}), flush=True)


if __name__ == "__main__":
    main()
