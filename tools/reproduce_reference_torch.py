"""Reproduction of the reference's published runs through the PyTorch port:
the counterpart of tools/reproduce_reference.py, importing only
show_tell_tpu_torch, so it runs where JAX is not installed.

Per row it assembles the exact CLI invocation (the reference's
hyperparameters, 100 epochs, greedy eval: the decode of every published
number) and, after the test phase, prints measured against published
metrics with the north-star gate (BLEU-4 within 0.1 of the reference,
BASELINE.json).  The run needs MS-COCO and ImageNet backbone weights on
disk, which it does not fetch:

    python tools/reproduce_reference_torch.py --row gru_512_lr001_sgd \\
        --data_dir /data/COCO --backbone_weights resnet101.pth --execute

The default is a dry run: print the command (``python -m
show_tell_tpu_torch.cli.main...``) without running it.  The rows are
BASELINE.md's (Final_Report.pdf Tables 2-3), the same as
tools/reproduce_reference.py's.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

# (variant, embed, lr, optimizer, resnet) -> published {metric: value x 100}
ROWS = {
    "gru_256_lr01_sgd": dict(variant="gru", embed=256, lr=0.01, opt="SGD", resnet=101,
                             published=dict(Bleu_1=63.7, Bleu_2=44.72, Bleu_3=35.97, Bleu_4=30.77, CIDEr=86.77,
                                            ROUGE_L=34.24)),
    "gru_256_lr001_sgd": dict(variant="gru", embed=256, lr=0.001, opt="SGD", resnet=101,
                              published=dict(Bleu_1=66.72, Bleu_2=47.23, Bleu_3=37.86, Bleu_4=32.17, CIDEr=87.08,
                                             ROUGE_L=35.18)),
    "gru_512_lr01_sgd": dict(variant="gru", embed=512, lr=0.01, opt="SGD", resnet=101,
                             published=dict(Bleu_1=63.99, Bleu_2=44.88, Bleu_3=36.11, Bleu_4=30.87, CIDEr=86.17,
                                            ROUGE_L=33.55)),
    # The reference's best row (Final_Report.pdf Table 2, bolded).
    "gru_512_lr001_sgd": dict(variant="gru", embed=512, lr=0.001, opt="SGD", resnet=101,
                              published=dict(Bleu_1=67.46, Bleu_2=47.56, Bleu_3=38.03, Bleu_4=32.30, CIDEr=89.06,
                                             ROUGE_L=35.84)),
    "gru_512_lr0001_sgd": dict(variant="gru", embed=512, lr=0.0001, opt="SGD", resnet=101,
                               published=dict(Bleu_1=58.0, Bleu_2=36.7, Bleu_3=30.58, Bleu_4=26.89, CIDEr=55.01,
                                              ROUGE_L=31.84)),
    "gru_512_lr001_adam": dict(variant="gru", embed=512, lr=0.001, opt="Adam", resnet=101,
                               published=dict(Bleu_1=66.44, Bleu_2=46.41, Bleu_3=36.93, Bleu_4=31.31, CIDEr=88.00,
                                              ROUGE_L=35.77)),
    "gru_512_lr0001_adam": dict(variant="gru", embed=512, lr=0.0001, opt="Adam", resnet=101,
                                published=dict(Bleu_1=62.75, Bleu_2=43.80, Bleu_3=35.32, Bleu_4=30.28, CIDEr=84.99,
                                               ROUGE_L=33.68)),
    "lstm_512_lr0001_adam": dict(variant="lstm", embed=512, lr=0.0001, opt="Adam", resnet=101,
                                 published=dict(Bleu_1=62.4, Bleu_2=43.81, Bleu_3=35.36, Bleu_4=30.33, CIDEr=84.79,
                                                ROUGE_L=33.4)),
    "gru_resnet50_512_lr0001_adam": dict(variant="gru", embed=512, lr=0.0001, opt="Adam", resnet=50,
                                         published=dict(Bleu_1=62.57, Bleu_2=43.59, Bleu_3=35.19, Bleu_4=30.17,
                                                        CIDEr=83.95, ROUGE_L=33.71)),
}
ENTRY = {"gru": "main", "lstm": "main_lstm", "attn": "main_attn", "attn_lstm": "main_attn_lstm"}


def build_argv(row: dict, args) -> list:
    """The exact training and eval flags of one published row.

    Fixed by the reference: 5 layers, hidden 512, batch 32, momentum 0.9,
    vocabulary threshold 5, 100 epochs, greedy decode (the report leaves
    beam search to future work), eval on val2014.
    """
    argv = [
        "--data_dir", args.data_dir,
        "--output_dir", args.output_dir,
        "--embedding_length", str(row["embed"]),
        "--num_hidden_units", "512",
        "--num_layers", "5",
        "--batch_size", "32",
        "--vocab_threshold", "5",
        "--optimizer_type", row["opt"],
        "--lr", str(row["lr"]),
        "--momentum", "0.9",
        "--num_epochs", str(args.num_epochs),
        "--resnet_version", str(row["resnet"]),
        "--is_training", "1",
        "--is_testing", "1",
        "--load_model_test", "model_%d" % args.num_epochs,
        "--keep_checkpoints", "3",
    ]
    if args.backbone_weights:
        argv += ["--backbone_weights", args.backbone_weights]
    if args.deterministic_eval:
        argv += ["--eval_augment", "0"]
    if args.dp:
        argv += ["--dp", str(args.dp)]
    return argv


def command(row: dict, argv: list) -> str:
    """The shell command of a row, one flag a line."""
    return "python -m show_tell_tpu_torch.cli.%s \\\n    " % ENTRY[row["variant"]] + " \\\n    ".join(
        " ".join(argv[i : i + 2]) for i in range(0, len(argv), 2))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--row", default="gru_512_lr001_sgd", choices=sorted(ROWS))
    p.add_argument("--data_dir", default="./data/MSCOCO")
    p.add_argument("--output_dir", default="./output/reproduce")
    p.add_argument("--backbone_weights", default="", help="torchvision resnet .pth (the reference uses pretrained=True)")
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--dp", type=int, default=0, help="data-parallel processes, one a card (reference: a single GPU)")
    p.add_argument("--deterministic_eval", action="store_true",
                   help="disable the reference's eval-time random flips (utils.py:96) for a pinned metric run")
    p.add_argument("--execute", action="store_true", help="actually run (default: print the command)")
    args = p.parse_args(argv)

    row = ROWS[args.row]
    run_argv = build_argv(row, args)
    print("# Row %s — published (x100): %s" % (args.row, row["published"]))
    print(command(row, run_argv))

    if not args.execute:
        print("\n(dry run; pass --execute to train+evaluate)")
        return 0

    from show_tell_tpu_torch.cli.run import run

    scores = run(row["variant"], run_argv)["scores"]
    print("\n%-9s %10s %10s %8s" % ("metric", "measured", "published", "delta"))
    ok = True
    for k, pub in row["published"].items():
        got = scores[k] * 100.0
        delta = got - pub
        print("%-9s %10.2f %10.2f %+8.2f" % (k, got, pub, delta))
        if k == "Bleu_4" and abs(delta) > 0.1:
            ok = False
    print("\nBLEU-4 within 0.1 of the reference: %s" % ("YES" if ok else "NO"))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
