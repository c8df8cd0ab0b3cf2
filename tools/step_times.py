"""Device times of the pooled fused-step kernels at the flagship widths on one NVIDIA GPU.

    python tools/step_times.py [--root DIR] [--requests N]
    python tools/step_times.py [--root DIR] --dtype float32 [--rows NAME,...]

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
stem and the attention context at B=64; the projection kernels,
project_argmax at B=64 and project_topk at R=192, which are also timed
at B = 1, 64 and R = 3, 192), so that two checkouts that
print the same digests gave bit-equal outputs.  With --requests N, also
whole requests of 64 images on the host clock (to ids on the host, median
of N after one warm-up): the pooled GRU's s2d greedy request and the
attention GRU's beam request (K=3), the Captioners built as chip_smoke.py
builds them (ResNet-101, random weights from seed 0).  Prints the card's
name and power limit, one line a kernel and B, and a JSON line of every
time and digest.

With --dtype float32, every f32 instance of the 14 TPU kernels' ports
instead (f32_instances; --rows: only those named): the pooled greedy and
stack steps (the tensor cores in split-precision TF32, as every f32
instance but the context and the preprocess) at B = 1, 32, 64 and 512,
every other instance at B = 1, 32, 64 (R = 3, 96, 192 beam rows), each with its
operands warm in L2 and cold, and the whole decode at B = 1, 64 and 512 (median of 10 after
2); beside each, its f32 composite yardstick (PyTorch's own calls on the
same operands, with TF32 off; chip_smoke.library_yardsticks where it
builds the row), its bound (chip_smoke.bound: bytes over 3.35 TB/s against
operations over the card's 67 TFLOP/s of f32, or, for the instances on
the tensor cores, three TF32 products a multiply-add over its 495 TFLOP/s
of TF32; the stem two, its pixels being exact in TF32), its plain twin's
time (at B=64, R=192) and its launches on the f32 eval path; every row's
kernel / yardstick at B=1 (R=3) in one line; then, where the checkout's f32 greedy steps take
``splits``, their K split swept (S = 1 .. 8 at B = 1, 32, 64, 128, 192, warm
and cold, beside the S that stack_tiles takes), and where its f32 stack steps
do (they run the split 3xTF32 layers), theirs at B = 1, 32, 64; then the
stack steps at L = 1 .. 5 layers of the same widths (B = 1, 32, 64, 512, warm
and cold): the least-squares slope a layer against the bound's, and the
intercept, which splits the step's excess over its bound into what each
layer adds and a fixed cost (launch, barriers, layer 0's wider input);
then sha256 digests of every f32 instance's outputs, so that two
checkouts that print the same digests gave bit-equal outputs.
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
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"),
                    help="float32: every f32 instance beside its f32 yardstick instead")
    ap.add_argument("--rows", default="", help="float32: only these instances (comma-separated names)")
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
    from show_tell_tpu_torch.ops.vocab import project_argmax_cuda, project_topk_cuda
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
    if args.dtype == "float32":
        f32_instances(cs, root, smi, device, flush, [r for r in args.rows.split(",") if r])
        return
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
    vocab_b = cs.vocab_inputs(rng, cs.H, torch.bfloat16, device)
    for name, sizes in (("project_argmax", (1, 64)), ("project_topk", (3, 192))):
        for n in sizes:
            h = cs.uniform(rng, (n, cs.H), 1.0, torch.bfloat16, device)
            run = ((lambda: project_argmax_cuda(vocab_b, h)) if name == "project_argmax"
                   else (lambda: project_topk_cuda(vocab_b, h, cs.K_BEAM)))
            times[name, n] = (cs.event_median_ms(run), cs.event_median_ms(run, before=flush.zero_))
            print("%s bf16 %s=%d from %s: %s %.4f ms, L2 cold %.4f ms"
                  % (smi, "R" if name in cs.BEAM_KERNELS else "B", n, root, name, *times[name, n]), flush=True)
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
    pvocab = cs.vocab_inputs(drng, cs.H, torch.bfloat16, device)
    digests["project_argmax B=64"] = project_argmax_cuda(pvocab, cs.uniform(drng, (64, cs.H), 1.0, torch.bfloat16,
                                                                             device))
    digests["project_topk R=192"] = project_topk_cuda(pvocab, cs.uniform(drng, (192, cs.H), 1.0, torch.bfloat16,
                                                                          device), cs.K_BEAM)
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


# the launches of each f32 instance on the f32 eval path (test_model, greedy, B=32): a batch's, where it runs there
F32_EVAL_LAUNCHES = {
    "fused_gru_decode_step": "25 a batch (pooled GRU)", "fused_lstm_decode_step": "25 a batch (pooled LSTM)",
    "fused_attn_decode_step": "25 a batch (attention GRU)",
    "fused_attn_lstm_decode_step": "25 a batch (attention LSTM)",
    "fused_gru_dense_step": "24 a beam batch (--beam_size)", "fused_lstm_dense_step": "24 a beam batch (--beam_size)",
    "fused_attn_dense_step": "24 a beam batch (--beam_size)", "fused_attn_lstm_dense_step": "24 a beam batch",
    "attention_context": "1 an attention beam batch",
    "gru_stack_step": "25 a batch under --mp", "lstm_stack_step": "25 a batch under --mp",
}


def f32_instances(cs, root, smi, device, flush, only=()):
    """--dtype float32: every f32 instance (or those ``only`` names), warm
    and cold, beside its f32 composite yardstick (TF32 off) and its bound;
    the K split of the f32 greedy and stack steps swept; the stack steps at
    L = 1 .. 5; then their digests."""
    import hashlib
    import inspect

    import numpy as np
    import torch
    import torch.nn.functional as F

    from show_tell_tpu_torch.ops.attention import attention_context_cuda, attention_context_plain
    from show_tell_tpu_torch.ops.fused_beam import (
        fused_dense_step_cuda,
        fused_dense_step_plain,
        fused_topk_step_cuda,
        fused_topk_step_plain,
    )
    from show_tell_tpu_torch.ops.fused_step import (
        MAX_SPLITS,
        fused_gru_decode_step_cuda,
        fused_lstm_decode_step_cuda,
        sm_count,
        stack_tiles,
        tf32x3_step,
    )
    from show_tell_tpu_torch.ops.rnn import gru_stack_plain, gru_stack_step_cuda, lstm_stack_plain, lstm_stack_step_cuda
    from show_tell_tpu_torch.ops.s2d_stem import S2D_PAD, space_to_depth
    from show_tell_tpu_torch.ops.stem import prepare_stem, stem_fused_cuda, stem_fused_plain
    from show_tell_tpu_torch.ops.vocab import (
        project_argmax_cuda,
        project_argmax_plain,
        project_topk_cuda,
        project_topk_plain,
    )

    f32, K = torch.float32, cs.K_BEAM
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(cs.SEED + 13)
    hx = lambda state: tuple(state) if isinstance(state, tuple) else state
    rows = {}  # (name, B or R) -> {"ms", "cold_ms", "yard_ms", "bound_ms", "bound_by"}
    # the rows whose yardstick chip_smoke.library_yardsticks builds (at B rows; the dense steps' at 3 B)
    library_rows = ("fused_gru_decode_step", "fused_lstm_decode_step", "fused_attn_decode_step",
                    "fused_attn_lstm_decode_step", "fused_attn_dense_step", "fused_attn_lstm_dense_step",
                    "preprocess_images", "gru_whole_greedy_decode")

    def both(cuda, plain, *args):  # (kernel call, plain twin call) on the same operands
        return (lambda: cuda(*args)), (lambda: plain(*args))

    def cases(name, n, draw=rng):
        """(kernel call, plain twin call, yardstick call) of instance ``name`` at n rows, operands drawn from
        ``draw``."""
        if name in library_rows:
            yard, kernel, plain = cs.library_yardsticks(draw, n // K if name in cs.BEAM_KERNELS else n, device, f32,
                                                        (name,))[name]
            return kernel, plain, yard
        cell = "lstm" if "lstm" in name else "gru"
        Ed = cs.LE if cell == "lstm" else cs.E
        if name in ("fused_gru_dense_step", "fused_lstm_dense_step", "fused_gru_topk_step", "fused_lstm_topk_step",
                    "gru_stack_step", "lstm_stack_step"):
            stacked, vocab, x, state = cs.step_inputs(draw, n, f32, device, Ed, cell)
            rnn = cs.library_rnn(cell, stacked, Ed)
            top = lambda: rnn(x[None], hx(state))[0][0]
            if name.endswith("dense_step"):
                return (*both(fused_dense_step_cuda, fused_dense_step_plain, stacked, vocab, x, state),
                        lambda: torch.addmm(vocab["b"], top(), vocab["w"].T))
            if name.endswith("topk_step"):
                return (*both(fused_topk_step_cuda, fused_topk_step_plain, stacked, vocab, x, state, K),
                        lambda: torch.log_softmax(torch.addmm(vocab["b"], top(), vocab["w"].T), dim=-1).topk(K))
            stack = (lstm_stack_step_cuda, lstm_stack_plain) if cell == "lstm" else (gru_stack_step_cuda,
                                                                                    gru_stack_plain)
            return (*both(*stack, stacked, x, state), lambda: rnn(x[None], hx(state)))
        if name == "attention_context":
            weights, feats, att1, h = cs.context_inputs(draw, n, f32, device)
            return (*both(attention_context_cuda, attention_context_plain, weights, feats, att1, h),
                    lambda: torch.bmm(torch.softmax(F.leaky_relu(att1 + torch.addmm(weights["bdec"], h,
                                                                                     weights["wdec"].T)[:, None], 0.2)
                                                    @ weights["wfull"], dim=1)[:, None, :], feats)[:, 0])
        if name.startswith("project_"):
            vocab = cs.vocab_inputs(draw, cs.H, f32, device)
            top = cs.uniform(draw, (n, cs.H), 1.0, f32, device)
            logits = lambda: torch.addmm(vocab["b"], top, vocab["w"].T)
            if name == "project_argmax":
                return (*both(project_argmax_cuda, project_argmax_plain, vocab, top), lambda: logits().argmax(dim=-1))
            return (*both(project_topk_cuda, project_topk_plain, vocab, top, K),
                    lambda: torch.log_softmax(logits(), dim=-1).topk(K))
        imgs = cs.u8_images(draw, (n, cs.IMG, cs.IMG, 3), device)
        sprep = prepare_stem(cs.stem_stub(draw, device), f32)  # the stem: cuDNN's 4x4 conv of the s2d form + t, pool
        x12 = space_to_depth(imgs).permute(0, 3, 1, 2).float()
        w4 = sprep["w"].reshape(4, 4, 12, 64).permute(3, 2, 0, 1).contiguous()
        tp = sprep["t"].permute(2, 0, 1)[None]
        return (*both(stem_fused_cuda, stem_fused_plain, imgs, sprep),
                lambda: F.max_pool2d(F.relu(F.conv2d(F.pad(x12, S2D_PAD), w4) + tp), 3, 2, 1))

    pooled = (1, 32, 64, 512)
    batch = (1, 32, 64)
    beam = tuple(r * K for r in batch)  # R = 3, 96, 192
    plan = {name: pooled for name in ("fused_gru_decode_step", "fused_lstm_decode_step", "gru_stack_step",
                                      "lstm_stack_step")}
    plan.update({name: batch for name in ("fused_attn_decode_step", "fused_attn_lstm_decode_step",
                                          "attention_context", "project_argmax", "preprocess_images", "stem_fused")})
    plan.update({name: beam for name in ("fused_gru_dense_step", "fused_lstm_dense_step", "fused_gru_topk_step",
                                         "fused_lstm_topk_step", "fused_attn_dense_step", "fused_attn_lstm_dense_step",
                                         "project_topk")})
    if only:
        unknown = set(only) - set(plan) - {"gru_whole_greedy_decode"}
        if unknown:
            cs.fail("--rows names no f32 instance: %s" % sorted(unknown))
    wanted = lambda name: not only or name in only
    note = "(CUDA events, median of 30 after 5, each call queued behind a 1 ms spin, the yardstick's a 10 ms spin)"
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for name, sizes in plan.items():
            for n in sizes if wanted(name) else ():
                kernel, plain, yard = cases(name, n)
                ms, cold = cs.event_median_ms(kernel), cs.event_median_ms(kernel, before=flush.zero_)
                y_ms = cs.event_median_ms(yard, spin=cs.LIBRARY_SPIN_CYCLES)
                p_ms = cs.event_median_ms(plain, iters=10, warmup=2) if n == sizes[2] else None  # B=64, R=192
                b_ms, b_by = cs.bound(name, n, dtype="float32")
                rows[name, n] = {"ms": ms, "cold_ms": cold, "yard_ms": y_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                                 "bound_by": b_by}
                print("%s float32 %s %s=%d from %s: kernel %.4f ms, L2 cold %.4f ms; f32 yardstick %.4f ms "
                      "(kernel / yardstick %.3f); plain %s; bound %.4f ms (%s), kernel / bound %.1f; eval launches: "
                      "%s %s" % (smi, name, "R" if name in cs.BEAM_KERNELS else "B", n, root, ms, cold, y_ms,
                                 ms / y_ms, "%.4f ms" % p_ms if p_ms else "not timed", b_ms, b_by, ms / b_ms,
                                 F32_EVAL_LAUNCHES.get(name, "none"), note), flush=True)
        for B in (1, 64, 512) if wanted("gru_whole_greedy_decode") else ():  # the whole decode of T steps and
            run, plain, yard = cases("gru_whole_greedy_decode", B)  # its composite yardstick (library_yardsticks)
            ms = cs.event_median_ms(run, iters=10, warmup=2)
            cold = cs.event_median_ms(run, iters=10, warmup=2, before=flush.zero_)
            y_ms = cs.event_median_ms(yard, iters=10, warmup=2, spin=cs.LIBRARY_SPIN_CYCLES)
            p_ms = cs.event_median_ms(plain, iters=5, warmup=1) if B == 64 else None
            b_ms, b_by = cs.bound("gru_whole_greedy_decode", B, int(torch.unique(run()[:, :-1]).numel()), "float32")
            rows["gru_whole_greedy_decode", B] = {"ms": ms, "cold_ms": cold, "yard_ms": y_ms, "plain_ms": p_ms,
                                                  "bound_ms": b_ms, "bound_by": b_by}
            print("%s float32 gru_whole_greedy_decode B=%d T=%d from %s: kernel %.4f ms, L2 cold %.4f ms; f32 "
                  "yardstick %.4f ms (kernel / yardstick %.3f; host issue in it); bound %.4f ms (%s), kernel / bound "
                  "%.1f; median of 10 after 2" % (smi, B, cs.T, root, ms, cold, y_ms, ms / y_ms, b_ms, b_by, ms / b_ms),
                  flush=True)
    # every row's kernel / yardstick at its smallest size (B=1; R=3 for the beam rows), in one line
    smallest = {"%s %s=%d" % (name, "R" if name in cs.BEAM_KERNELS else "B", n): r["ms"] / r["yard_ms"]
                for (name, n), r in rows.items() if n == min(m for other, m in rows if other == name)}
    print("%s float32 kernel / yardstick at B=1 (beam rows R=3) from %s: %s"
          % (smi, root, ", ".join("%s %.3f" % kv for kv in smallest.items())), flush=True)
    # the K split of the f32 greedy and stack steps: every S the kernel takes, L2 warm and cold, beside the one
    # stack_tiles takes; where the checkout takes a forced f32 S (its greedy steps since the 3xTF32 tiles, its stack
    # steps since they run them)
    splits = {}  # "name B" -> {S: (warm ms, cold ms)}, with the rule's S
    sweeps = []  # (name, cell, layer-0 width, call with a forced S, the B swept)
    if "splits" in inspect.signature(fused_gru_decode_step_cuda).parameters:
        sweeps += [("fused_%s_decode_step" % cell, cell, Ed, lambda a, S, c=call: c(*a, splits=S),
                    (1, 32, 64, 128, 192))  # 192: the beam steps' R at B = 64, K = 3 (the same layers)
                   for cell, Ed, call in (("gru", cs.E, fused_gru_decode_step_cuda),
                                          ("lstm", cs.LE, fused_lstm_decode_step_cuda))]
    if tf32x3_step(f32, None):
        sweeps += [("%s_stack_step" % cell, cell, Ed, lambda a, S, c=call: c(a[0], *a[2:], splits=S), (1, 32, 64))
                   for cell, Ed, call in (("gru", cs.E, gru_stack_step_cuda), ("lstm", cs.LE, lstm_stack_step_cuda))]
    for name, cell, Ed, call, sizes in sweeps:
        if not wanted(name):
            continue
        for B in sizes:
            a = cs.step_inputs(rng, B, f32, device, Ed, cell)
            by_split = {S: (cs.event_median_ms(lambda: call(a, S)), cs.event_median_ms(lambda: call(a, S),
                                                                                       before=flush.zero_))
                        for S in range(1, MAX_SPLITS + 1)}
            rule = stack_tiles(B, Ed, cs.H, sm_count(device), dtype=f32).splits
            best = min(by_split, key=lambda S: by_split[S][0])
            splits["%s %d" % (name, B)] = {"rule": rule, "best": best, "ms": by_split}
            print("%s float32 %s B=%d K split from %s: %s; the rule takes S = %d (layer 0), %d (above): %.4f ms; "
                  "fastest warm S = %d, %.4f ms %s"
                  % (smi, name, B, root, ", ".join("S=%d %.4f ms (cold %.4f)" % (S, *t) for S, t in by_split.items()),
                     *rule, by_split[rule[1]][0] if rule[0] == rule[1] else float("nan"), best, by_split[best][0],
                     note), flush=True)
    # the stack steps at L = 1 .. 5 layers of the flagship widths (the first L layers of an L=5 stack): the slope a
    # layer and the intercept of a least-squares line through the times, against the bound's
    layers = {}  # "name B" -> {"ms": [warm ms at L = 1 .. 5], "cold_ms": [...], "bound_ms": [...], fit}
    for name, cell, Ed, call in (("gru_stack_step", "gru", cs.E, gru_stack_step_cuda),
                                 ("lstm_stack_step", "lstm", cs.LE, lstm_stack_step_cuda)):
        if not wanted(name):
            continue
        for B in (1, 32, 64, 512):
            stacked, _, x, state = cs.step_inputs(rng, B, f32, device, Ed, cell)
            warm, cold, bounds = [], [], []
            for Ld in range(1, cs.L + 1):
                st = {"w_ih0": stacked["w_ih0"], "w_ihU": stacked["w_ihU"][:Ld - 1], "w_hh": stacked["w_hh"][:Ld],
                      "b_ih": stacked["b_ih"][:Ld], "b_hh": stacked["b_hh"][:Ld]}
                sd = tuple(s[:Ld] for s in state) if cell == "lstm" else state[:Ld]
                warm.append(cs.event_median_ms(lambda: call(st, x, sd)))
                cold.append(cs.event_median_ms(lambda: call(st, x, sd), before=flush.zero_))
                bounds.append(cs.bound(name, B, dtype="float32", layers=Ld)[0])
            slope, icept = np.polyfit(np.arange(1, cs.L + 1), warm, 1)
            b_slope = (bounds[-1] - bounds[0]) / (cs.L - 1)  # the bound of each layer above layer 0
            excess = warm[-1] - bounds[-1]
            layers["%s %d" % (name, B)] = {"ms": warm, "cold_ms": cold, "bound_ms": bounds, "slope_ms": slope,
                                           "intercept_ms": icept, "bound_slope_ms": b_slope}
            print("%s float32 %s B=%d at L = 1 .. %d from %s: %s ms (L2 cold %s); bound %s ms; slope %.4f ms a layer "
                  "(bound %.4f, %.2fx), intercept %.4f ms; of the L=%d excess %.4f ms, (L-1) x (slope - bound slope) "
                  "%.4f ms goes with the layers above layer 0 %s"
                  % (smi, name, B, cs.L, root, " / ".join("%.4f" % v for v in warm),
                     " / ".join("%.4f" % v for v in cold), " / ".join("%.4f" % v for v in bounds), slope, b_slope,
                     slope / b_slope, icept, cs.L, excess, (cs.L - 1) * (slope - b_slope), note), flush=True)
    # the bits of every f32 instance, from inputs of their own seed: the SIMT ones must equal another checkout's
    drng = np.random.RandomState(cs.SEED + 17)
    flat = lambda out: [t for o in (out if isinstance(out, tuple) else (out,))
                        for t in (o if isinstance(o, tuple) else (o,))]
    digests = {}
    for name in (*plan, "gru_whole_greedy_decode") if not only else ():
        n = 64 * K if name in cs.BEAM_KERNELS else 64
        digests["%s %d" % (name, n)] = cases(name, n, drng)[0]()
    torch.cuda.synchronize()
    digests = {k: hashlib.sha256(b"".join(t.cpu().contiguous().numpy().tobytes() for t in flat(v))).hexdigest()[:16]
               for k, v in digests.items()}
    print("%s float32 instances from %s, sha256 of their outputs: %s"
          % (smi, root, ", ".join("%s %s" % kv for kv in digests.items())), flush=True)
    print(json.dumps({"root": root, "card": smi, "dtype": "float32",
                      "rows": {"%s %d" % k: v for k, v in rows.items()}, "smallest_over_yardstick": smallest,
                      "splits": splits, "layers": layers, "digests": digests}), flush=True)


if __name__ == "__main__":
    main()
