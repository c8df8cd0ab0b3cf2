"""Device times of the pooled fused-step kernels at the flagship widths on one NVIDIA GPU.

    python tools/step_times.py [--root DIR] [--requests N]

Imports show_tell_tpu_torch from DIR (default: this checkout), so that one
script times two checkouts alike, each in its own process.  In bf16, with
chip_smoke.py's inputs and timer (CUDA events, median of 30 after 5, each
call queued behind a 1 ms spin): the GRU's fused greedy step
(fused_gru_decode_step_cuda) at B = 1, 64 and 512 with its operands warm
in L2 and cold (a 64 MB write between the spin and the call), and the
whole decode of T = 25 steps (gru_whole_greedy_decode_cuda; median of 10
after 2) at the same B; the GRU's and the LSTM's beam steps, top-k (k=3,
warm and cold) and dense, at R = 3 and 192 beam rows; the GRU's and the
LSTM's stack steps (gru_stack_step_cuda, lstm_stack_step_cuda: the
sharded-projection route's recurrence alone) at B = 1, 64 and 512, warm
and cold; the fused s2d stem (stem_fused_cuda, RGB layout, pooled: the
served call) at B = 1 and 64 and the attention context
(attention_context_cuda) at B = 1, 64 and 256, warm and cold; the rows
with no single PyTorch call (the four greedy steps, the two attention dense
steps, the whole decode, the preprocess) beside their composite
yardsticks (chip_smoke.library_yardsticks) at B = 1 and 64 (R = 3 and 192
for the dense steps).  Then
sha256 digests of every bf16 tensor-core instance's outputs on inputs of
their own seed (the greedy, dense and top-k steps of both cells and the
whole decode at B=64, R=192; the attention greedy and dense steps; the
stem and the attention context at B=64), so that two checkouts that
print the same digests gave bit-equal outputs.  With --requests N, also
whole requests of 64 images on the host clock (to ids on the host, median
of N after one warm-up): the pooled GRU's s2d greedy request and the
attention GRU's beam request (K=3), the Captioners built as chip_smoke.py
builds them (ResNet-101, random weights from seed 0).  Prints the card's
name and power limit, one line a kernel and B, and a JSON line of every
time and digest.
"""

import argparse
import hashlib
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
    ap.add_argument("--root", default=HERE, help="checkout whose show_tell_tpu_torch is timed")
    ap.add_argument("--requests", type=int, default=0, help="also time N whole requests of each served path")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import numpy as np
    import torch

    import show_tell_tpu_torch
    from show_tell_tpu_torch.ops.fused_attn import fused_attn_decode_step_cuda, fused_attn_dense_step_cuda
    from show_tell_tpu_torch.ops.fused_beam import fused_dense_step_cuda, fused_topk_step_cuda
    from show_tell_tpu_torch.ops.fused_step import fused_gru_decode_step_cuda, fused_lstm_decode_step_cuda
    from show_tell_tpu_torch.ops.attention import attention_context_cuda
    from show_tell_tpu_torch.ops.rnn import gru_stack_step_cuda, lstm_stack_step_cuda
    from show_tell_tpu_torch.ops.stem import prepare_stem, stem_fused_cuda
    from show_tell_tpu_torch.ops.whole_decode import gru_whole_greedy_decode_cuda

    if not show_tell_tpu_torch.__file__.startswith(root + os.sep):
        cs.fail("show_tell_tpu_torch came from %s, not from %s" % (show_tell_tpu_torch.__file__, root))
    if not torch.cuda.is_available():
        cs.fail("torch finds no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    rng = np.random.RandomState(cs.SEED)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    times = {}
    print(smi, flush=True)
    for B in (1, 64, 512):
        stacked, vocab, x, hs = cs.step_inputs(rng, B, torch.bfloat16, device)
        step = lambda: fused_gru_decode_step_cuda(stacked, vocab, x, hs)
        prepared, feats = cs.whole_inputs(rng, B, torch.bfloat16, device)
        times["step", B] = (cs.event_median_ms(step), cs.event_median_ms(step, before=flush.zero_))
        times["whole", B] = (cs.event_median_ms(lambda: gru_whole_greedy_decode_cuda(prepared, feats, cs.T), iters=10,
                                                warmup=2),)
        print("%s bf16 B=%d from %s: fused GRU greedy step %.4f ms, L2 cold %.4f ms; whole decode T=%d %.4f ms"
              % (smi, B, root, *times["step", B], cs.T, times["whole", B][0]), flush=True)
    for R in (3, 192):
        for cell, Ed in (("gru", cs.E), ("lstm", cs.LE)):
            stacked, vocab, x, state = cs.step_inputs(rng, R, torch.bfloat16, device, Ed, cell)
            topk = lambda: fused_topk_step_cuda(stacked, vocab, x, state, cs.K_BEAM)
            times[cell + " topk", R] = (cs.event_median_ms(topk), cs.event_median_ms(topk, before=flush.zero_))
            times[cell + " dense", R] = (cs.event_median_ms(lambda: fused_dense_step_cuda(stacked, vocab, x, state)),)
            print("%s bf16 R=%d from %s: fused %s top-%d beam step %.4f ms, L2 cold %.4f ms; dense beam step %.4f ms"
                  % (smi, R, root, cell.upper(), cs.K_BEAM, *times[cell + " topk", R], times[cell + " dense", R][0]),
                  flush=True)
    for B in (1, 64, 512):
        for cell, Ed, step in (("gru", cs.E, gru_stack_step_cuda), ("lstm", cs.LE, lstm_stack_step_cuda)):
            stacked, _, x, state = cs.step_inputs(rng, B, torch.bfloat16, device, Ed, cell)
            run = lambda: step(stacked, x, state)
            times[cell + " stack", B] = (cs.event_median_ms(run), cs.event_median_ms(run, before=flush.zero_))
            print("%s bf16 B=%d from %s: %s stack step %.4f ms, L2 cold %.4f ms"
                  % (smi, B, root, cell.upper(), *times[cell + " stack", B]), flush=True)
    sprep = prepare_stem(cs.stem_stub(rng, device), torch.bfloat16)
    for B in (1, 64):
        x = cs.u8_images(rng, (B, cs.IMG, cs.IMG, 3), device)
        run = lambda: stem_fused_cuda(x, sprep)
        times["stem", B] = (cs.event_median_ms(run), cs.event_median_ms(run, before=flush.zero_))
        print("%s bf16 B=%d from %s: stem (RGB, pooled) %.4f ms, L2 cold %.4f ms" % (smi, B, root, *times["stem", B]),
              flush=True)
    for B in (1, 64, 256):
        weights, feats, att1, h = cs.context_inputs(rng, B, torch.bfloat16, device)
        run = lambda: attention_context_cuda(weights, feats, att1, h)
        times["attention_context", B] = (cs.event_median_ms(run), cs.event_median_ms(run, before=flush.zero_))
        print("%s bf16 B=%d from %s: attention_context %.4f ms, L2 cold %.4f ms"
              % (smi, B, root, *times["attention_context", B]), flush=True)
    # the yardsticks of the rows with no single PyTorch call (chip_smoke.library_yardsticks: composites of
    # PyTorch's own calls on the kernel's operands) beside the kernel, at B = 1 and 64 (R = 3 and 192 for the dense
    # steps), each behind a 10 ms spin
    for B in (1, 64):
        with torch.inference_mode():
            for name, (yard, kernel, plain) in cs.library_yardsticks(np.random.RandomState(cs.SEED + 11), B,
                                                                     device).items():
                rows = 3 * B if name in cs.BEAM_KERNELS else B
                iters = 10 if name == "gru_whole_greedy_decode" else 30
                times[name, rows] = (cs.event_median_ms(kernel, iters=iters, warmup=2),)
                times[name + " yardstick", rows] = (cs.event_median_ms(yard, iters=iters, warmup=2,
                                                                       spin=cs.LIBRARY_SPIN_CYCLES),)
                print("%s bf16 %s=%d from %s: %s kernel %.4f ms, yardstick (%s) %.4f ms, against the twin %s"
                      % (smi, "R" if name in cs.BEAM_KERNELS else "B", rows, root, name, times[name, rows][0],
                         cs.LIBRARY_CALLS[name], times[name + " yardstick", rows][0],
                         cs.yardstick_agreement(yard(), plain())), flush=True)
    # the bits of every bf16 tensor-core instance, from inputs of their own seed
    drng = np.random.RandomState(cs.SEED + 7)
    raw = lambda t: t.cpu().contiguous().view(torch.uint8).numpy().tobytes()
    flat = lambda out: [t for o in (out if isinstance(out, tuple) else (out,))
                        for t in (o if isinstance(o, tuple) else (o,))]
    digests = {}
    for cell, Ed in (("gru", cs.E), ("lstm", cs.LE)):
        greedy = fused_lstm_decode_step_cuda if cell == "lstm" else fused_gru_decode_step_cuda
        stacked, vocab, x, state = cs.step_inputs(drng, 64, torch.bfloat16, device, Ed, cell)
        digests[cell + " greedy B=64"] = greedy(stacked, vocab, x, state)
        stacked, vocab, x, state = cs.step_inputs(drng, 192, torch.bfloat16, device, Ed, cell)
        digests[cell + " dense R=192"] = fused_dense_step_cuda(stacked, vocab, x, state)
        digests[cell + " top-k R=192"] = fused_topk_step_cuda(stacked, vocab, x, state, cs.K_BEAM)
        prep, w_emb, astate = cs.attn_inputs(drng, 64, torch.bfloat16, device, cell)
        digests["attention %s greedy B=64" % cell] = fused_attn_decode_step_cuda(prep, w_emb, astate)
        prep, w_emb, astate = cs.attn_inputs(drng, 192, torch.bfloat16, device, cell)
        digests["attention %s dense R=192" % cell] = fused_attn_dense_step_cuda(prep, w_emb, astate)
    prepared, feats = cs.whole_inputs(drng, 64, torch.bfloat16, device)
    digests["gru whole decode B=64"] = gru_whole_greedy_decode_cuda(prepared, feats, cs.T)
    digests["stem B=64"] = stem_fused_cuda(cs.u8_images(drng, (64, cs.IMG, cs.IMG, 3), device),
                                           prepare_stem(cs.stem_stub(drng, device), torch.bfloat16))
    digests["attention_context B=64"] = attention_context_cuda(*cs.context_inputs(drng, 64, torch.bfloat16, device))
    torch.cuda.synchronize()
    digests = {k: hashlib.sha256(b"".join(raw(t) for t in flat(v))).hexdigest()[:16] for k, v in digests.items()}
    print("%s bf16 tensor-core instances from %s, sha256 of their outputs: %s"
          % (smi, root, ", ".join("%s %s" % kv for kv in digests.items())), flush=True)
    if args.requests:
        from show_tell_tpu_torch.models.captioner import CaptionerConfig, init_captioner
        from show_tell_tpu_torch.serve import Captioner

        imgs = np.random.RandomState(cs.SEED + 1).randint(0, 256, (64, cs.IMG, cs.IMG, 3), dtype=np.uint8)
        for name, cfg, s2d, beam in (
                ("s2d greedy request", CaptionerConfig("gru", 101, cs.E, cs.H, cs.V, cs.L), True, 0),
                ("attention beam request", CaptionerConfig("attn", 101, cs.AE, cs.H, cs.V, cs.L, nos_filters=cs.AC,
                                                           attn_dim=cs.AA), False, cs.K_BEAM)):
            params, bn_state = init_captioner(cfg, torch.Generator().manual_seed(cs.SEED))
            cap = Captioner(params, bn_state, cfg, cs.SyntheticVocab(cs.V), "bfloat16", device="gpu", s2d=s2d)
            cap.caption_ids(imgs, beam)  # warm-up: cuDNN plans, allocator
            ms = []
            for _ in range(args.requests):
                t0 = time.perf_counter()
                cap.caption_ids(imgs, beam)
                ms.append(1e3 * (time.perf_counter() - t0))
            times[name, 64] = (statistics.median(ms), min(ms), max(ms))
            print("%s bf16 B=64 from %s: %s %.3f ms, %.1f captions/s (host clock, median of %d; min %.3f, max %.3f "
                  "ms)" % (smi, root, name, times[name, 64][0], 64e3 / times[name, 64][0], args.requests,
                           times[name, 64][1], times[name, 64][2]), flush=True)
    beam_rows = lambda name: name.endswith(("topk", "dense")) or name.split(" ")[0] in cs.BEAM_KERNELS
    print(json.dumps({"root": root, "card": smi, "ms": {"%s %s=%d" % (k[0], "R" if beam_rows(k[0]) else "B", k[1]): v
                                                        for k, v in times.items()}, "digests": digests}), flush=True)


if __name__ == "__main__":
    main()
