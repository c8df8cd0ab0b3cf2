"""Serving over a dp x mp mesh of the visible NVIDIA GPUs (or CPU processes), against one card.

    python tools/mesh_cards.py [--world N] [--device cuda|cpu] [--small] [--rows B] [--requests R]

For the pooled GRU and the attention LSTM (chip_smoke.py's flagship
widths, ResNet-101, random weights from seed 0; --small: ResNet-18 at
64 x 64, E=16, H=24, L=2, V=41, for a rehearsal on the CPU), in bf16, with
B rows a dp share:

- for each mesh (dp, mp) of (N, 1) and (N/2, 2), N ranks
  (parallel.multihost.spawn, as ``serve.main --dp --mp`` spawns them: nccl
  on CUDA, each on its own card; gloo on the CPU) serve one seeded request
  of dp x B uint8 images through Captioner(dp, mp), greedy and by beam
  K=3: one warm-up request, then R timed by the host clock (to the ids on
  the host);
- one process on card 0 serves each dp share of that request (B rows) by
  the same route: the served route under (N, 1), the sharded route with a
  one-rank vocabulary shard under (N/2, 2); and R requests of B by the
  served route, timed the same way;
- the ranks' ids must equal each other, and one card's on at least 0.95
  of positions;
- captions/s per card: a request's rows over its median time, over the N
  cards; one card's the same at B.

Prints the card's name and power limit first (on CUDA), one line a
check, and a JSON line of every number last; exits non-zero on a failed
check.  Each spawned group of ranks is joined within --timeout seconds.
"""

import argparse
import json
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ("gru", "attn_lstm")
K = 3
SHARE = 0.95


def config(variant, small):
    from show_tell_tpu_torch.models.captioner import CaptionerConfig

    attention = variant.startswith("attn")
    if small:
        kw = dict(nos_filters=512, attn_dim=16) if attention else {}
        return CaptionerConfig(variant, 18, 16, 24, 41, 2, **kw)
    kw = dict(nos_filters=2048, attn_dim=512) if attention else {}
    return CaptionerConfig(variant, 101, 256 if variant == "gru" else 512, 512, 9956, 5, **kw)


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


def timed(cap, images, beam_size, requests):
    """One warm-up request, then ``requests`` on the host clock: (ids, seconds of each)."""
    ids = cap.caption_ids(images, beam_size)
    seconds = []
    for _ in range(requests):
        t0 = time.perf_counter()
        ids = cap.caption_ids(images, beam_size)
        seconds.append(time.perf_counter() - t0)
    return ids, seconds


def rank_main(work, cuda, dp, mp):
    """One rank, in its group: both families served over the (dp, mp) mesh on its own card (or the CPU)."""
    import torch

    sys.path.insert(0, HERE)
    from show_tell_tpu_torch.models.captioner import init_captioner
    from show_tell_tpu_torch.parallel import multihost
    from show_tell_tpu_torch.serve import Captioner

    device = multihost.local_device("gpu" if cuda else "cpu")
    if not cuda:
        torch.set_num_threads(1)
    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    images = inputs["images"][: dp * inputs["rows"]]
    out = {}
    for variant in VARIANTS:
        cfg = config(variant, inputs["small"])
        params, bn_state = init_captioner(cfg, torch.Generator().manual_seed(0))
        cap = Captioner(params, bn_state, cfg, Vocab(cfg.vocab_size), "bfloat16", device=device, dp=dp, mp=mp)
        for beam_size in (0, K):
            out[variant, beam_size] = timed(cap, images, beam_size, inputs["requests"])
        del cap
    return out


def one_card(inputs, device, meshes):
    """Card 0 alone: each dp share of each mesh's request by the mesh's route, and the served route's time at B."""
    import numpy as np
    import torch

    from show_tell_tpu_torch.models.captioner import init_captioner, prepare_decode
    from show_tell_tpu_torch.parallel.mesh import decoder_vocab_shard, make_mesh
    from show_tell_tpu_torch.serve import Captioner

    B, out = inputs["rows"], {}
    for variant in VARIANTS:
        cfg = config(variant, inputs["small"])
        params, bn_state = init_captioner(cfg, torch.Generator().manual_seed(0))
        cap = Captioner(params, bn_state, cfg, Vocab(cfg.vocab_size), "bfloat16", device=device)
        sharded = Captioner(params, bn_state, cfg, Vocab(cfg.vocab_size), "bfloat16", device=device)
        decoder_vocab_shard(make_mesh(1, 1), sharded.model.decoder)
        sharded.prepared = prepare_decode(sharded.model, sharded.dtype)
        for beam_size in (0, K):
            out[variant, beam_size, "rate"] = timed(cap, inputs["images"][:B], beam_size, inputs["requests"])[1]
            for dp, mp in meshes:
                route = sharded if mp > 1 else cap
                shares = [inputs["images"][d * B:(d + 1) * B] for d in range(dp)]
                out[variant, beam_size, dp, mp] = np.concatenate([route.caption_ids(x, beam_size) for x in shares])
        del cap, sharded
    return out


def measure(work, args, world, card, cuda, side):
    """One card's run, then each mesh's; returns the report and the failed checks."""
    import numpy as np
    import torch

    from show_tell_tpu_torch.parallel import multihost

    meshes = ((world, 1), (world // 2, 2))
    inputs = {"small": args.small, "rows": args.rows, "requests": args.requests,
              "images": np.random.RandomState(7).randint(0, 256, (world * args.rows, side, side, 3), dtype=np.uint8)}
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    one = one_card(inputs, torch.device("cuda", 0) if cuda else torch.device("cpu"), meshes)
    backend = multihost.backend_for("gpu" if cuda else "cpu")
    report = {"card": card, "world": world, "backend": backend, "rows": args.rows, "requests": args.requests,
              "one_card": {}, "meshes": {}}
    failed = []
    for variant in VARIANTS:
        for beam_size in (0, K):
            secs = one[variant, beam_size, "rate"]
            report["one_card"]["%s k%d" % (variant, beam_size)] = {
                "seconds": secs, "captions_per_s": args.rows / statistics.median(secs)}
    for dp, mp in meshes:
        t0 = time.perf_counter()
        ranks = multihost.spawn(rank_main, world, (work, cuda, dp, mp), "gpu" if cuda else "cpu",
                                timeout=args.timeout)
        wall = time.perf_counter() - t0
        for variant in VARIANTS:
            for beam_size in (0, K):
                ids = [r[variant, beam_size][0] for r in ranks]
                equal = all((i == ids[0]).all() for i in ids[1:])
                share = float((ids[0] == one[variant, beam_size, dp, mp]).mean())
                secs = ranks[0][variant, beam_size][1]
                per_card = dp * args.rows / max(statistics.median(r[variant, beam_size][1]) for r in ranks) / world
                one_rate = report["one_card"]["%s k%d" % (variant, beam_size)]["captions_per_s"]
                report["meshes"]["dp%d mp%d %s k%d" % (dp, mp, variant, beam_size)] = {
                    "ranks_equal": equal, "share": share, "rank0_seconds": secs, "captions_per_s_per_card": per_card}
                print("%s (dp, mp) = (%d, %d), %s %s, bf16, %d rows a dp share: ids of the %d ranks equal: %s; equal "
                      "one card's (the same route on each share) on %.4f of positions (bar %g); captions/s per card "
                      "%.1f (median of %d requests, the slowest rank), one card at B=%d %.1f"
                      % (card, dp, mp, variant, "beam K=%d" % K if beam_size else "greedy", args.rows, world, equal,
                         share, SHARE, per_card, args.requests, args.rows, one_rate), flush=True)
                if not equal or share < SHARE:
                    failed.append("dp%d mp%d %s k%d" % (dp, mp, variant, beam_size))
        print("(dp, mp) = (%d, %d): the %d ranks took %.1f s (spawn, weights, build, requests)" % (dp, mp, world, wall),
              flush=True)
    return report, failed


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=0, help="ranks (0: every visible card; on the CPU, 4)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--small", action="store_true", help="ResNet-18 at 64 x 64 and tiny widths")
    ap.add_argument("--rows", type=int, default=64, help="rows of a request a dp share")
    ap.add_argument("--requests", type=int, default=5, help="timed requests after one warm-up")
    ap.add_argument("--timeout", type=int, default=900, help="seconds for each group of spawned ranks")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        sys.exit("torch finds no CUDA device")
    world = args.world or (torch.cuda.device_count() if cuda else 4)
    if world < 2 or world % 2:
        sys.exit("--world must be even and at least 2 (the (N/2, 2) mesh)")
    card = "CPU, %d processes" % world
    if cuda:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        print(card, flush=True)
        from show_tell_tpu_torch.ops import build

        build.load_library()  # built once here, before the ranks load it
    else:
        torch.set_num_threads(2)
    side = 64 if args.small else 224
    work = tempfile.mkdtemp(prefix="mesh_cards_")
    try:
        report, failed = measure(work, args, world, card, cuda, side)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(report), flush=True)
    if failed:
        sys.exit("failed: %s" % failed)

if __name__ == "__main__":
    main()
