"""Whether the f32 greedy decode of an untrained attention captioner is fixed by f32 at all, on one NVIDIA GPU.

    python tools/f32_plain_orders.py [--root DIR] [--batches N]

chip_smoke.py holds each f32 request's ids to the card's plain decode (its
phase 5: the attention GRU, flagship widths, random weights from seed 0,
eight 224 x 224 images).  The untrained step's initial state reaches
|h| ~ 7e4, where a gate on the edge of saturation turns one f32 rounding into
another trajectory.  This tool decodes that request (the same draws of the
smoke's image stream) and N more batches of 8 (seed 123) three ways: the
kernels of the checkout at DIR (Captioner.caption_ids), the card's plain
decode (chip_smoke.plain_decode) and the same plain decode of the same card
features on the CPU, another order of the f32 sums (plain_decode(...,
host=True)).  Prints one line a batch and one a row where two of the three
part; the last line is a JSON object of the counts.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="checkout whose show_tell_tpu_torch decodes")
    ap.add_argument("--batches", type=int, default=8, help="batches of 8 beyond the smoke's request")
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
    torch.backends.cuda.matmul.allow_tf32 = False
    # the smoke's image stream (chip_smoke.main's img_rng) up to phase 5's f32 request of the attention GRU: phase 4's
    # requests of the pooled GRU (three of 64; f32, beam and s2d f32 requests of 8) and LSTM (three of 64; f32 and
    # beam requests of 8), then phase 5's three requests of 64
    rng = np.random.RandomState(cs.SEED + 1)
    big, small = (64, cs.IMG, cs.IMG, 3), (8, cs.IMG, cs.IMG, 3)
    for shape in [big] * 3 + [small] * 3 + [big] * 3 + [small] * 2 + [big] * 3:
        rng.randint(0, 256, shape, dtype=np.uint8)
    more = np.random.RandomState(123)
    batches = [rng.randint(0, 256, small, dtype=np.uint8)]
    batches += [more.randint(0, 256, small, dtype=np.uint8) for _ in range(args.batches)]
    cfg = CaptionerConfig("attn", 101, cs.AE, cs.H, cs.V, cs.L, nos_filters=cs.AC, attn_dim=cs.AA)
    params, bn_state = init_captioner(cfg, torch.Generator().manual_seed(cs.SEED))
    cap = Captioner(params, bn_state, cfg, cs.SyntheticVocab(cs.V), "float32", device="gpu")
    counts = {"rows": 0, "kernel = card plain": 0, "card plain = CPU plain": 0, "kernel = CPU plain": 0}
    print(smi, flush=True)
    for i, imgs in enumerate(batches):
        kernel = cap.caption_ids(imgs, 0)
        card = cs.plain_decode(cap, imgs)[0]
        host = cs.plain_decode(cap, imgs, host=True)[0]
        agree = {"kernel = card plain": (kernel == card).all(1), "card plain = CPU plain": (card == host).all(1),
                 "kernel = CPU plain": (kernel == host).all(1)}
        counts["rows"] += len(imgs)
        for k, v in agree.items():
            counts[k] += int(v.sum())
        for r in range(len(imgs)):
            if not all(v[r] for v in agree.values()):
                print("batch %d row %d (%s): %s" % (i, r, "the smoke's request" if i == 0 else "seed 123",
                                                     ", ".join("%s %s" % (k, bool(v[r])) for k, v in agree.items())))
        print("%s f32 attention GRU from %s, batch %d of 8 images: %s" % (
            smi, root, i, ", ".join("%s on %d" % (k, int(v.sum())) for k, v in agree.items())), flush=True)
    print(json.dumps({"root": root, "card": smi, "counts": counts}), flush=True)


if __name__ == "__main__":
    main()
