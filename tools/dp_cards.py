"""Data parallelism across the visible NVIDIA GPUs (or CPU processes): DDP train steps and the sharded eval against
one process.

    python tools/dp_cards.py [--world N] [--device cuda|cpu] [--small] [--steps S] [--batch B]

For the pooled GRU and the attention GRU (chip_smoke.py's flagship widths,
ResNet-101, random weights from seed 0; --small: ResNet-18 at 64 x 64,
E=16, H=24, L=2, V=40, for a rehearsal on the CPU), a seeded global batch
of B uint8 images with captions of the synthetic vocabulary:

- one process (device 0) runs S f32 SGD train steps, flips on;
- N ranks (parallel.multihost.spawn, as ``cli.main --dp N`` spawns them:
  nccl on CUDA, each on its own card; gloo on the CPU) run the same steps
  over a parallel.mesh mesh, each on its B/N rows;
- each rank's losses are held to the one process's within 1e-4 relative
  (the f32 card step's bar in chip_smoke.py), the ranks' to each other
  exactly;
- train images/s of one process and of the N ranks over the last S - 2
  steps (two warm up): by CUDA events on each rank's stream and by the
  host clock.  Each step ends in ``float(loss)``, a host sync, as the
  train loop's steps do, so the events span the host's issue too; on the
  CPU the host clock alone;
- test_model greedy (no flips) over three seeded eval batches of B,
  sharded over the N ranks, against one process: every word-level score
  equal, test_loss within 1e-5 relative.

Prints the card's name and power limit first (on CUDA), one line a
check, and a JSON line of every number last; exits non-zero on a failed
check.  Each spawned group of ranks is joined within --timeout seconds.
"""

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ("gru", "attn")
LOSS_RTOL = 1e-4
EVAL_BATCHES = 3
WARM_STEPS = 2


def config(variant, small):
    from show_tell_tpu_torch.models.captioner import CaptionerConfig

    if small:
        kw = dict(nos_filters=512, attn_dim=16) if variant == "attn" else {}
        return CaptionerConfig(variant, 18, 16, 24, 40, 2, max_caption_length=8, **kw)
    kw = dict(nos_filters=2048, attn_dim=512) if variant == "attn" else {}
    return CaptionerConfig(variant, 101, 256 if variant == "gru" else 512, 512, 9956, 5, **kw)


def batch(rng, B, side, vocab, T=17):
    """uint8 images and <start> ... <end> captions, lengths descending as the loader sorts them."""
    import numpy as np

    images = rng.randint(0, 256, (B, side, side, 3), dtype=np.uint8)
    lengths = np.sort(rng.randint(6, T + 1, B))[::-1].astype(np.int32).copy()
    captions = np.zeros((B, T), np.int32)
    for i, n in enumerate(lengths):
        captions[i, :n] = rng.randint(4, vocab, n)
        captions[i, 0], captions[i, n - 1] = 1, 2
    return images, captions, lengths


class Vocab:
    def __init__(self, size):
        self.index_to_word = ["<pad>", "<start>", "<end>", "<unk>"] + ["w%d" % i for i in range(4, size)]
        self.word_to_index = {w: i for i, w in enumerate(self.index_to_word)}

    def start_token(self):
        return "<start>"

    def end_token(self):
        return "<end>"

    def __len__(self):
        return len(self.index_to_word)


class Batches(list):
    batch_size = 0


def run(work, device, mesh=None):
    """The S train steps of each family and the eval on ``device`` (over ``mesh``): losses, seconds a step,
    eval scores."""
    import torch

    from show_tell_tpu_torch.evaluation import tester
    from show_tell_tpu_torch.models.captioner import init_captioner
    from show_tell_tpu_torch.train.train_step import create_train_state, make_train_step

    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    out = {"train": {}}
    cuda = device.type == "cuda"
    for variant in VARIANTS:
        cfg = config(variant, inputs["small"])
        init = init_captioner(cfg, torch.Generator().manual_seed(0))
        ts = create_train_state(cfg, "SGD", 0.01, 0.9, device=device, seed=1, init=init, mesh=mesh)
        step = make_train_step(cfg)
        losses = [float(step(ts, *inputs["batch"])) for _ in range(WARM_STEPS)]
        timed = inputs["steps"] - WARM_STEPS
        if cuda:
            torch.cuda.synchronize(device)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(timed):
            losses.append(float(step(ts, *inputs["batch"])))
        host_s = (time.perf_counter() - t0) / timed
        event_s = None
        if cuda:
            end.record()
            end.synchronize()
            event_s = start.elapsed_time(end) / 1e3 / timed
        out["train"][variant] = {"losses": losses, "host_s": host_s, "event_s": event_s}
        del ts
    cfg = config("gru", inputs["small"])
    ts = create_train_state(cfg, "SGD", 0.01, 0.9, device=device, seed=1,
                            init=init_captioner(cfg, torch.Generator().manual_seed(0)))
    data = Batches(inputs["eval"])
    data.batch_size = len(inputs["eval"][0][0])
    params = {"output_dir": os.path.join(work, "eval"), "eval_augment": 0, "score_threads": 1,
              "dp": mesh.dp if mesh is not None else 0}
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        out["eval"] = tester.test_model(ts, cfg, data, Vocab(cfg.vocab_size), params)
    return out


def rank_main(work, cuda):
    """One rank, in its group: ``run`` on its own card (or the CPU) over the mesh of every rank."""
    import torch

    sys.path.insert(0, HERE)
    from show_tell_tpu_torch.parallel import multihost
    from show_tell_tpu_torch.parallel.mesh import make_mesh

    device = multihost.local_device("gpu" if cuda else "cpu")
    if not cuda:
        torch.set_num_threads(2)
    return run(work, device, make_mesh(multihost.process_count(), device=device))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=0, help="ranks (0: every visible card; on the CPU, 4)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--small", action="store_true", help="ResNet-18 at 64 x 64 and tiny widths")
    ap.add_argument("--steps", type=int, default=22, help="train steps a family (the first %d warm up)" % WARM_STEPS)
    ap.add_argument("--batch", type=int, default=32, help="the global batch")
    ap.add_argument("--timeout", type=int, default=900, help="seconds for the spawned ranks")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    from show_tell_tpu_torch.parallel import multihost

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        sys.exit("torch finds no CUDA device")
    world = args.world or (torch.cuda.device_count() if cuda else 4)
    card = "CPU, %d processes" % world
    if cuda:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        print(card, flush=True)
        from show_tell_tpu_torch.ops import build

        build.load_library()  # built once here, before the ranks load it
    else:
        torch.set_num_threads(2)
    if args.batch % world:
        sys.exit("--batch %d does not divide over %d ranks" % (args.batch, world))
    if args.steps <= WARM_STEPS:
        sys.exit("--steps must exceed the %d warm-up steps" % WARM_STEPS)
    small = args.small
    side = 64 if small else 224
    vocab = config("gru", small).vocab_size
    rng = np.random.RandomState(5)
    work = tempfile.mkdtemp(prefix="dp_cards_")
    os.makedirs(os.path.join(work, "eval"))
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump({"small": small, "steps": args.steps, "batch": batch(rng, args.batch, side, vocab),
                     "eval": [(tuple("img%d_%d.jpg" % (k, i) for i in range(args.batch)),)
                              + batch(rng, args.batch, side, vocab) for k in range(EVAL_BATCHES)]}, f)
    one = run(work, torch.device("cuda", 0) if cuda else torch.device("cpu"))
    backend = multihost.backend_for("gpu" if cuda else "cpu")
    ranks = multihost.spawn(rank_main, world, (work, cuda), "gpu" if cuda else "cpu", timeout=args.timeout)
    failed = []
    report = {"card": card, "world": world, "backend": backend, "global_batch": args.batch, "steps": args.steps,
              "train": {}, "eval": {}}
    for variant in VARIANTS:
        ref = one["train"][variant]
        got = [r["train"][variant] for r in ranks]
        equal = all(g["losses"] == got[0]["losses"] for g in got)
        gap = max(abs(a - b) / abs(b) for a, b in zip(got[0]["losses"], ref["losses"]))
        timed = args.steps - WARM_STEPS
        rates = {}
        for clock in ("event_s", "host_s"):
            if ref[clock] is not None:  # a step of the N ranks lasts as long as their slowest
                rates[clock] = (args.batch / ref[clock], args.batch / max(g[clock] for g in got))
        report["train"][variant] = {"losses_one": ref["losses"], "losses_ranks": got[0]["losses"], "gap": gap,
                                    "ranks_equal": equal, "timed_steps": timed,
                                    "images_per_s": {k[:-2]: {"one": v[0], "ranks": v[1]} for k, v in rates.items()}}
        print("%s f32 B=%d, %d steps: the %d ranks' losses against one process's, largest gap %.2e relative (bar "
              "%g; ranks equal: %s; last loss %.7f / %.7f); train images/s over %d steps after %d warm-up, one "
              "process / %d ranks: %s"
              % (variant, args.batch, args.steps, world, gap, LOSS_RTOL, equal, got[0]["losses"][-1],
                 ref["losses"][-1], timed, WARM_STEPS, world,
                 "; ".join("%s %.1f / %.1f" % ({"event_s": "CUDA events", "host_s": "host clock"}[k], *v)
                           for k, v in rates.items())), flush=True)
        if gap > LOSS_RTOL or not equal:
            failed.append(variant)
    for r, got in enumerate(ranks):
        off = [k for k in one["eval"] if k != "test_loss" and got["eval"][k] != one["eval"][k]]
        loss_gap = abs(got["eval"]["test_loss"] - one["eval"]["test_loss"]) / abs(one["eval"]["test_loss"])
        report["eval"]["rank%d" % r] = {"unequal": off, "test_loss_gap": loss_gap}
        if off or loss_gap > 1e-5:
            failed.append("eval rank %d" % r)
    print("sharded test_model over %d ranks, %d batches of %d: every word-level score equal to one process's on "
          "every rank: %s; test_loss gaps %s" % (world, EVAL_BATCHES, args.batch,
                                                 not any(v["unequal"] for v in report["eval"].values()),
                                                 " ".join("%.2e" % v["test_loss_gap"]
                                                          for v in report["eval"].values())), flush=True)
    print(json.dumps(report), flush=True)
    if failed:
        sys.exit("failed: %s" % failed)


if __name__ == "__main__":
    main()
