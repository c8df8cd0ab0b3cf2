"""Hyperparameter sweep through the PyTorch port's CLI: the counterpart of
tools/sweep.py, importing only show_tell_tpu_torch, so it runs where JAX is
not installed.  It automates the reference report's experiment grid
(Final_Report.pdf Table 2: embed {256,512} x lr {0.01,0.001,0.0001} x
{SGD,Adam}).

Each run trains through ``show_tell_tpu_torch.cli.run.run`` into its own
output directory, named like the reference's Log_Output convention (e.g.
GRU_COCO_lr_0_001_Embed512_SGD) and as tools/sweep.py names it, so
tools/loss_analysis.py can plot the sweep directly.

    python tools/sweep_torch.py --data_dir ... --sweep_output out/sweep \\
        --variant gru --num_epochs 5 \\
        --lrs 0.01,0.001 --embeds 256,512 --optimizers SGD,Adam

Unknown flags pass through to every run; ``--image_cache DIR`` makes the
runs share one decoded-image cache (the first run fills it; prefill it
beforehand with tools/prefill_cache_torch.py).  Writes
SWEEP_OUTPUT/sweep_summary.json: each run's name, settings and scores.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def run_name(variant: str, lr: float, embed: int, optimizer: str) -> str:
    return "%s_COCO_lr_%s_Embed%d_%s" % (variant.upper(), ("%g" % lr).replace(".", "_"), embed, optimizer)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--variant", default="gru", choices=["gru", "lstm", "attn", "attn_lstm"])
    parser.add_argument("--sweep_output", required=True)
    parser.add_argument("--lrs", default="0.01,0.001,0.0001")
    parser.add_argument("--embeds", default="256,512")
    parser.add_argument("--optimizers", default="SGD,Adam")
    args, passthrough = parser.parse_known_args(argv)

    from show_tell_tpu_torch.cli.run import run

    results = []
    for lr in [float(x) for x in args.lrs.split(",")]:
        for embed in [int(x) for x in args.embeds.split(",")]:
            for optimizer in args.optimizers.split(","):
                name = run_name(args.variant, lr, embed, optimizer)
                out_dir = os.path.join(args.sweep_output, name)
                os.makedirs(out_dir, exist_ok=True)
                print("=== sweep run:", name, "===")
                argv_run = passthrough + [
                    "--output_dir", out_dir,
                    "--lr", str(lr),
                    "--embedding_length", str(embed),
                    "--optimizer_type", optimizer,
                ]
                res = run(args.variant, argv_run)
                record = {"run": name, "lr": lr, "embed": embed, "optimizer": optimizer}
                if "scores" in res:
                    record["scores"] = {k: float(v) for k, v in res["scores"].items()}
                results.append(record)

    summary = os.path.join(args.sweep_output, "sweep_summary.json")
    with open(summary, "w") as f:
        json.dump(results, f, indent=1)
    print("wrote", summary)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
