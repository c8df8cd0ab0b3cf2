"""bf16 training convergence A/B on the PyTorch port.

Trains the synthetic grounded-captioning demo (tools/demo_synthetic_torch.py:
its dataset, argv and CLI) twice at one seed, one dataset and one number of
epochs: once in f32, the parity dtype, and once with ``--train_dtype
bfloat16`` (bf16 forward and backward inside the loss; f32 master weights,
gradients, optimizer state and BN statistics), then prints the two test
phases' scores side by side.  Each dtype trains in its own subprocess, so the
two runs share no process state; each writes its scores to a JSON file.

    python tools/bf16_convergence_torch.py [--images 400] [--epochs 12] [--device gpu|cpu] [--out table.json]

It runs on the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

TOOLS = os.path.dirname(os.path.abspath(__file__))
KEYS = ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L", "test_loss"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--images", type=int, default=400)
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "bf16_conv_torch"))
    p.add_argument("--device", default="gpu", choices=["gpu", "cpu"])
    p.add_argument("--out", default="", help="optional JSON output path")
    args = p.parse_args(argv)

    scores = {}
    for dtype in ("float32", "bfloat16"):
        print("== training %s (%d epochs) ==" % (dtype, args.epochs), flush=True)
        root = os.path.join(args.root, dtype)
        result = os.path.join(args.root, "scores_%s.json" % dtype)
        os.makedirs(args.root, exist_ok=True)
        subprocess.run([sys.executable, os.path.join(TOOLS, "demo_synthetic_torch.py"), "--images", str(args.images),
                        "--epochs", str(args.epochs), "--root", root, "--device", args.device, "--train_dtype", dtype,
                        "--out", result], check=True, timeout=3600)
        with open(result) as f:
            scores[dtype] = json.load(f)

    print("\n=== bf16-compute training convergence, PyTorch port (synthetic demo, equal seeds/epochs) ===")
    print("%-10s %12s %12s %10s" % ("metric", "f32", "bf16", "delta"))
    table = {}
    for k in KEYS:
        a, b = scores["float32"]["scores"][k], scores["bfloat16"]["scores"][k]
        table[k] = {"f32": a, "bf16": b, "delta": b - a}
        print("%-10s %12.4f %12.4f %+10.4f" % (k, a, b, b - a))
    probes = {d: (scores[d]["probe"]["color"], scores[d]["probe"]["shape"]) for d in scores}
    print("%-10s %12s %12s" % ("unseen c/s", "%d/%d" % probes["float32"], "%d/%d" % probes["bfloat16"]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"epochs": args.epochs, "images": args.images, "device": args.device, "table": table,
                       "probe_color_shape_of_16": probes}, f, indent=1)
        print("wrote", args.out)
    return table


if __name__ == "__main__":
    main()
