#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths once on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero with no ok line):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: the CUDA kernels from show_tell_tpu_torch/csrc, with nvcc;
  3. kernel against plain, at the flagship widths: the pooled fused step,
     GRU (L=5, E=256, H=512, V=9,956; B = 1, 64, 512; and E=1024 > H) and
     LSTM (E=512, same B); the fused attention step, GRU and LSTM (L=5,
     E=H=A=512, P=49, V=9,956; B = 1, 64, 256); the attention context
     (C=2048, same B); the projection + argmax (H=512, V=9,956, same B);
     f32 and bf16, with cross-block argmax ties;
  4. pooled main paths: a flagship pooled-GRU Captioner (ResNet-101,
     random weights from seed 0, bf16) serves three requests of 64
     images; the fused step must have launched 3 x 25 times and the ids
     must agree with the plain step's decode; then once more in f32 at
     B=8.  The same for a flagship pooled-LSTM Captioner (E=512) and the
     step's LSTM instance;
  5. attention main paths: the same for a flagship attention-GRU and an
     attention-LSTM Captioner (spatial ResNet-101, C=2048, E=H=A=512),
     each followed by one composite decode of the same features at B=64
     (25 launches each of the context and projection kernels);
  6. times: per-step kernel and plain times, and captions/s of each slice.
The last lines are the card's name and power limit, a JSON line of the
kernels, and {"ok": true, "device": {...}}.
"""

import json
import os
import statistics
import subprocess
import sys
import time

L, E, H, V = 5, 256, 512, 9956  # pooled flagship (bench.py:61-74, variant gru)
LE = 512  # pooled-LSTM flagship embed (bench.py:61-74, variant lstm)
AE, AC, AA, AP = 512, 2048, 512, 49  # attention flagship: embed, channels, attention width, positions
GATES = {"gru": 3, "lstm": 4}
T = 25
SEED = 0
# (rtol = atol for values, smallest top-2 logit gap at which tokens must agree):
# f32 differs from the plain twin by summation order only; bf16 by one bf16
# ulp of a |h| <= 1 value (2^-7 ~ 0.0078) after a cast, and its logits near
# ties by more than the f32 sums' order.
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 5e-2)}


def fail(msg):
    print("FAIL: %s" % msg, flush=True)
    sys.exit(1)


def phase(name, msg):
    print("[%s] %s" % (name, msg), flush=True)


class SyntheticVocab:
    """The vocabulary interface the Captioner reads: the four specials at
    ids 0-3 (<pad> <start> <end> <unk>) and synthetic words after them."""

    def __init__(self, size):
        words = ["<pad>", "<start>", "<end>", "<unk>"] + ["w%d" % i for i in range(size - 4)]
        self.word_to_index = {w: i for i, w in enumerate(words)}
        self.index_to_word = dict(enumerate(words))

    def __len__(self):
        return len(self.word_to_index)

    def start_token(self):
        return "<start>"

    def end_token(self):
        return "<end>"


def event_median_ms(fn, iters=30, warmup=5):
    """Median over ``iters`` launches of the device time between CUDA
    events recorded around each call, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(e0.elapsed_time(e1) for e0, e1 in pairs)


def dname(dtype):
    return str(dtype).split(".")[1]


def uniform(rng, shape, bound, dtype, device):
    import torch

    return torch.from_numpy(rng.uniform(-bound, bound, shape).astype("float32")).to(device, dtype).contiguous()


def stack_inputs(rng, I0, Hd, Ld, dtype, device, cell="gru"):
    """prepare_rnn_weights layout, U(+-1/sqrt(H)) as the decoder init draws it."""
    b = 1.0 / Hd ** 0.5
    G = GATES[cell] * Hd
    return {
        "w_ih0": uniform(rng, (G, I0), b, dtype, device),
        "w_ihU": uniform(rng, (Ld - 1, G, Hd), b, dtype, device),
        "w_hh": uniform(rng, (Ld, G, Hd), b, dtype, device),
        "b_ih": uniform(rng, (Ld, G), b, dtype, device),
        "b_hh": uniform(rng, (Ld, G), b, dtype, device),
    }


def vocab_inputs(rng, Hd, dtype, device):
    b = 1.0 / Hd ** 0.5
    return {"w": uniform(rng, (V, Hd), b, dtype, device), "b": uniform(rng, (V,), b, dtype, device)}


def state_inputs(rng, B, dtype, device, cell):
    """hs [L, B, H] in [-1, 1]; for the LSTM (hs, cs) with cs in [-2, 2]."""
    hs = uniform(rng, (L, B, H), 1.0, dtype, device)
    return (hs, uniform(rng, (L, B, H), 2.0, dtype, device)) if cell == "lstm" else hs


def step_inputs(rng, B, dtype, device, Ed=E, cell="gru"):
    """Pooled decode-step inputs at the flagship widths, kernel layout:
    stacked, vocab, x [B, E] and the state."""
    import torch

    x = torch.from_numpy(rng.randn(B, Ed).astype("float32")).to(device, dtype)
    return (stack_inputs(rng, Ed, H, L, dtype, device, cell), vocab_inputs(rng, H, dtype, device), x,
            state_inputs(rng, B, dtype, device, cell))


def attn_inputs(rng, B, dtype, device, cell="gru"):
    """Fused attention step inputs at the flagship widths: prepare_attn_decode's
    dict, the token embeddings [B, E] and the state."""
    import torch

    prep = {
        "stacked": stack_inputs(rng, 2 * AE, H, L, dtype, device, cell),
        "vocab": vocab_inputs(rng, H, dtype, device),
        "wdec": uniform(rng, (AA, H), H ** -0.5, dtype, device),
        "bdec": uniform(rng, (AA,), H ** -0.5, dtype, device),
        "wfull": uniform(rng, (AA,), AA ** -0.5, dtype, device),
        "b_emb": uniform(rng, (AE,), AC ** -0.5, dtype, device),
        "att1": uniform(rng, (B, AP, AA), 1.0, dtype, device),
        "feats_e": uniform(rng, (B, AP, AE), 1.0, dtype, device),
    }
    w_emb = torch.from_numpy(rng.randn(B, AE).astype("float32")).to(device, dtype)
    return prep, w_emb, state_inputs(rng, B, dtype, device, cell)


def top2_gap(logits):
    top = logits.float().topk(2, dim=-1).values
    return top[:, 0] - top[:, 1]


def check_states(what, got, ref, dtype):
    import torch

    tol = TOL[dname(dtype)][0]
    err = (got.float() - ref.float()).abs().max().item()
    if not torch.allclose(got.float(), ref.float(), rtol=tol, atol=tol):
        fail("%s differs from plain: max_abs_err %g (rtol = atol = %g)" % (what, err, tol))
    return err


def check_state(what, got, ref, dtype):
    """new_hs, and for the LSTM new_cs, against the plain twin's; returns the larger error."""
    if isinstance(got, tuple):
        return max(check_states(what + " new_hs", got[0], ref[0], dtype),
                   check_states(what + " new_cs", got[1], ref[1], dtype))
    return check_states(what + " new_hs", got, ref, dtype)


def check_tokens(what, tok, ref_tok, logits, dtype):
    gap_min = TOL[dname(dtype)][1]
    clear = top2_gap(logits) > gap_min
    bad = int(((tok != ref_tok) & clear).sum())
    if bad:
        fail("%s: tokens differ from plain on %d rows with a top-2 gap > %g" % (what, bad, gap_min))
    return int(clear.sum())


def kernels_against_plain(rng, device):
    """Phase 3.  Returns the bf16 B=64 max_abs_err of each kernel."""
    import torch

    from show_tell_tpu_torch.models.attention import last_h
    from show_tell_tpu_torch.ops.attention import attention_context_cuda, attention_context_plain
    from show_tell_tpu_torch.ops.fused_attn import fused_attn_decode_step_cuda, fused_attn_decode_step_plain
    from show_tell_tpu_torch.ops.fused_step import (
        fused_gru_decode_step_cuda,
        fused_gru_decode_step_plain,
        fused_lstm_decode_step_cuda,
        fused_lstm_decode_step_plain,
    )
    from show_tell_tpu_torch.ops.vocab import project_argmax_cuda, project_argmax_plain, project_logits

    pooled = (("fused_gru_decode_step", "gru", E, fused_gru_decode_step_cuda, fused_gru_decode_step_plain),
              ("fused_lstm_decode_step", "lstm", LE, fused_lstm_decode_step_cuda, fused_lstm_decode_step_plain))
    attention = (("fused_attn_decode_step", "gru"), ("fused_attn_lstm_decode_step", "lstm"))
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn, tol = dname(dtype), TOL[dname(dtype)]
        for name, cell, Ec, cuda_step, plain_step in pooled:
            shapes = ((1, Ec), (64, Ec), (512, Ec)) + (((64, 1024),) if cell == "gru" else ())
            for B, Ed in shapes:
                stacked, vocab, x, state = step_inputs(rng, B, dtype, device, Ed, cell)
                tok, new_state = cuda_step(stacked, vocab, x, state)
                torch.cuda.synchronize()
                ref_tok, ref_state = plain_step(stacked, vocab, x, state)
                what = "pooled %s step %s B=%d E=%d" % (cell, dn, B, Ed)
                err = check_state(what, new_state, ref_state, dtype)
                n = check_tokens(what, tok, ref_tok, project_logits(vocab, last_h(ref_state)), dtype)
                if dtype == torch.bfloat16 and B == 64 and Ed == Ec:
                    errs[name] = err
                phase("kernel", "%s: state max_abs_err %.3g (rtol atol %g); tokens equal on all %d rows with top-2 "
                      "gap > %g, %d rows closer" % (what, err, tol[0], n, tol[1], B - n))
            stacked, vocab, x, state = step_inputs(rng, 64, dtype, device, Ec, cell)
            vocab["w"][9000] = vocab["w"][7]
            vocab["b"][7] = vocab["b"][9000] = 100.0
            tok, _ = cuda_step(stacked, vocab, x, state)
            ref_tok, _ = plain_step(stacked, vocab, x, state)
            if not (bool((tok == 7).all()) and bool((ref_tok == 7).all())):
                fail("pooled %s step: tie of columns 7 and 9000 not resolved to 7 (%s): %s"
                     % (cell, dn, tok.unique().tolist()))
            phase("kernel", "pooled %s step %s tie between columns 7 and 9000 -> 7 on all 64 rows" % (cell, dn))

        for B in (1, 64, 256):
            for name, cell in attention:
                prep, w_emb, state = attn_inputs(rng, B, dtype, device, cell)
                tok, new_state = fused_attn_decode_step_cuda(prep, w_emb, state)
                torch.cuda.synchronize()
                ref_tok, ref_state = fused_attn_decode_step_plain(prep, w_emb, state)
                what = "attention %s step %s B=%d" % (cell, dn, B)
                err = check_state(what, new_state, ref_state, dtype)
                n = check_tokens(what, tok, ref_tok, project_logits(prep["vocab"], last_h(ref_state)), dtype)
                if dtype == torch.bfloat16 and B == 64:
                    errs[name] = err
                phase("kernel", "%s: state max_abs_err %.3g (rtol atol %g); tokens equal on all %d rows with top-2 "
                      "gap > %g, %d rows closer" % (what, err, tol[0], n, tol[1], B - n))
            top = last_h(state)
            feats = uniform(rng, (B, AP, AC), 1.0, dtype, device)
            ctx, alpha = attention_context_cuda(prep, feats, prep["att1"], top)
            torch.cuda.synchronize()
            ref_ctx, ref_alpha = attention_context_plain(prep, feats, prep["att1"], top)
            what = "attention context %s B=%d" % (dn, B)
            err = check_states(what + " ctx", ctx, ref_ctx, dtype)
            a_err = (alpha - ref_alpha).abs().max().item()
            if not torch.allclose(alpha, ref_alpha, rtol=1e-5, atol=1e-6):  # f32 in both: summation order
                fail("%s alpha max_abs_err %g (rtol 1e-5, atol 1e-6)" % (what, a_err))
            if dtype == torch.bfloat16 and B == 64:
                errs["attention_context"] = err
            phase("kernel", "%s: ctx max_abs_err %.3g (rtol atol %g), alpha max_abs_err %.3g (rtol 1e-5 atol 1e-6)"
                  % (what, err, tol[0], a_err))

            tok = project_argmax_cuda(prep["vocab"], top)
            torch.cuda.synchronize()
            ref_tok = project_argmax_plain(prep["vocab"], top)
            logits = project_logits(prep["vocab"], top)
            what = "project_argmax %s B=%d" % (dn, B)
            n = check_tokens(what, tok, ref_tok, logits, dtype)
            rows = torch.arange(B, device=device)
            err = (logits[rows, tok.long()] - logits[rows, ref_tok.long()]).abs().max().item()
            if dtype == torch.bfloat16 and B == 64:
                errs["project_argmax"] = err
            phase("kernel", "%s: tokens equal on all %d rows with top-2 gap > %g, %d rows closer; largest logit "
                  "gap between the two picks %.3g" % (what, n, tol[1], B - n, err))

        for _, cell in attention:
            prep, w_emb, state = attn_inputs(rng, 64, dtype, device, cell)
            prep["vocab"]["w"][9000] = prep["vocab"]["w"][7]
            prep["vocab"]["b"][7] = prep["vocab"]["b"][9000] = 100.0
            top = last_h(state)
            toks = [fused_attn_decode_step_cuda(prep, w_emb, state)[0],
                    fused_attn_decode_step_plain(prep, w_emb, state)[0],
                    project_argmax_cuda(prep["vocab"], top), project_argmax_plain(prep["vocab"], top)]
            if not all(bool((t == 7).all()) for t in toks):
                fail("attention %s step / project_argmax: tie of columns 7 and 9000 not resolved to 7 (%s)"
                     % (cell, dn))
            phase("kernel", "attention %s step and project_argmax %s: tie between columns 7 and 9000 -> 7 on all 64 "
                  "rows" % (cell, dn))
    return errs


def serve(cap, requests, counter_fns, launches_each):
    """One warm-up request, then ``requests`` timed on the host clock with
    every kernel count set to 0 just before; returns (ids, seconds, counts)."""
    import torch

    cap.caption_ids(requests[0])  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    for fn in counter_fns:
        fn.launches = 0
    t0 = time.perf_counter()
    served = [cap.caption_ids(imgs) for imgs in requests]
    seconds = time.perf_counter() - t0
    counts = {fn.__name__: fn.launches for fn in counter_fns}
    for name, want in launches_each.items():
        if counts[name] != want:
            fail("main path launched %s %d times, expected %d (counts %s)" % (name, counts[name], want, counts))
    return served, seconds, counts


def check_served(label, served, requests, plain_decode, cap):
    for i, (ids, imgs) in enumerate(zip(served, requests)):
        if ids.shape != (len(imgs), T) or ids.min() < 0 or ids.max() >= V:
            fail("%s request %d: ids of shape %s in [%d, %d]" % (label, i, ids.shape, ids.min(), ids.max()))
        ref_ids, _ = plain_decode(cap, imgs)
        share = float((ids == ref_ids).mean())
        if share < 0.95:
            fail("%s request %d: ids equal the plain step's decode on %.4f of positions (< 0.95)" % (label, i, share))
        phase("main", "%s bf16 request %d: [64,25] ids, equal to the plain step's decode on %.4f of positions"
              % (label, i, share))


def check_f32(label, cap32, imgs, counter, plain_decode):
    counter.launches = 0
    ids32 = cap32.caption_ids(imgs)
    if counter.launches != T:
        fail("%s f32 request launched %s %d times" % (label, counter.__name__, counter.launches))
    ref32, gaps32 = plain_decode(cap32, imgs)
    same = (ids32 == ref32).all(axis=1)
    for r in [int(i) for i in range(len(same)) if not same[i]]:
        phase("main", "%s f32 row %d differs from the plain decode; its smallest top-2 gap is %.3g"
              % (label, r, gaps32[r]))
    if same.mean() < 0.99:
        fail("%s f32 B=%d: %d rows equal the plain decode (< 99%%)" % (label, len(same), int(same.sum())))
    phase("main", "%s f32 B=%d (TF32 off): %d of %d rows equal the plain step's decode"
          % (label, len(same), int(same.sum()), len(same)))


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "show_tell_tpu_torch", "csrc")):
        fail("show_tell_tpu_torch/ is not beside chip_smoke.py; run it from a checkout of the repo")
    sys.path.insert(0, here)
    import numpy as np
    import torch

    # 1. device
    if not torch.cuda.is_available():
        fail("torch finds no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    card = "[%s]" % smi
    device = torch.device("cuda", 0)
    phase("device", "%s | torch %s | CUDA %s | %s" % (smi, torch.__version__, torch.version.cuda,
                                                      torch.cuda.get_device_name(0)))

    # 2. build
    from show_tell_tpu_torch.ops import build

    cached = os.path.isfile(build.library_path())
    t0 = time.perf_counter()
    build.load_library()
    phase("build", "%s in %.2f s (%s)" % (os.path.basename(build.library_path()), time.perf_counter() - t0,
                                          "already built" if cached else "nvcc ran, one process per source"))

    # 3. kernel against plain
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(SEED)
    errs = kernels_against_plain(rng, device)

    from show_tell_tpu_torch.data.transforms import preprocess_images
    from show_tell_tpu_torch.models.attention import init_hidden, last_h, linear_f32, start_embeddings
    from show_tell_tpu_torch.models.captioner import CaptionerConfig, init_captioner
    from show_tell_tpu_torch.models.decoder import greedy_loop
    from show_tell_tpu_torch.models.rnn_cells import init_state
    from show_tell_tpu_torch.ops.attention import (
        attention_context,
        attention_context_cuda,
        attention_context_plain,
        attn_greedy_decode_composite,
        precompute_att1,
    )
    from show_tell_tpu_torch.ops.fused_attn import (
        fused_attn_decode_step,
        fused_attn_decode_step_cuda,
        fused_attn_decode_step_plain,
        fused_attn_lstm_decode_step,
        prepare_attn_decode,
    )
    from show_tell_tpu_torch.ops.fused_step import (
        fused_gru_decode_step,
        fused_gru_decode_step_cuda,
        fused_gru_decode_step_plain,
        fused_lstm_decode_step,
        fused_lstm_decode_step_cuda,
        fused_lstm_decode_step_plain,
    )
    from show_tell_tpu_torch.ops.rnn import stack_plain
    from show_tell_tpu_torch.ops.vocab import project_argmax, project_argmax_cuda, project_argmax_plain, project_logits
    from show_tell_tpu_torch.serve import Captioner

    counters = [fused_gru_decode_step, fused_lstm_decode_step, fused_attn_decode_step, fused_attn_lstm_decode_step,
                attention_context, project_argmax]
    vocab = SyntheticVocab(V)
    img_rng = np.random.RandomState(SEED + 1)

    def features(cap, images_u8):
        x = preprocess_images(torch.from_numpy(images_u8).to(device), augment=False, dtype=cap.dtype)
        return cap.model.encoder(x)

    def plain_loop(step, embedding, x0, state0):
        """greedy_loop over a plain step; returns ids and each row's smallest top-2 logit gap."""
        gaps = []

        def run(x, state):
            tok, state2, logits = step(x, state)
            gaps.append(top2_gap(logits))
            return tok, state2

        ids = greedy_loop(run, embedding, x0, state0, T)
        return ids.cpu().numpy(), torch.stack(gaps, 1).min(1).values.cpu().numpy()

    def show_captions(label, served):
        for row in served[0][:3]:
            phase("main", "%s caption: %s ..." % (label, " ".join(vocab.index_to_word[int(t)] for t in row[:8])))

    def pooled_slice(variant, Ed, counter):
        """Phase 4 for one pooled family; returns (launches, seconds of the three requests)."""
        cfg = CaptionerConfig(variant, 101, Ed, H, V, L)
        params, bn_state = init_captioner(cfg, torch.Generator().manual_seed(SEED))
        plain_step = fused_lstm_decode_step_plain if cfg.cell_type == "lstm" else fused_gru_decode_step_plain

        def pooled_plain(cap, images_u8):
            """The same features, decoded with the plain step on the card."""
            with torch.inference_mode():
                feats = features(cap, images_u8)
                prep = cap.prepared

                def step(xx, state):
                    tok, state2 = plain_step(prep["stacked"], prep["vocab"], xx, state)
                    return tok, state2, project_logits(prep["vocab"], last_h(state2))

                state0 = init_state(cfg.cell_type, L, len(images_u8), H, cap.dtype, device)
                return plain_loop(step, prep["embedding"], feats.to(cap.dtype), state0)

        cap = Captioner(params, bn_state, cfg, vocab, "bfloat16", device="gpu")
        requests = [img_rng.randint(0, 256, (64, 224, 224, 3), dtype=np.uint8) for _ in range(3)]
        served, seconds, counts = serve(cap, requests, counters, {counter.__name__: 3 * T})
        check_served(variant, served, requests, pooled_plain, cap)
        phase("main", "%s: launches in the three requests %s (fused step = 3 x 25)" % (variant, counts))
        show_captions(variant, served)
        cap32 = Captioner(params, bn_state, cfg, vocab, "float32", device="gpu")
        check_f32(variant, cap32, img_rng.randint(0, 256, (8, 224, 224, 3), dtype=np.uint8), counter, pooled_plain)
        return counts[counter.__name__], seconds

    def attention_slice(variant, counter):
        """Phase 5 for one attention family; returns (launches, seconds of the
        three requests, the composite decode's launch counts)."""
        acfg = CaptionerConfig(variant, 101, AE, H, V, L, nos_filters=AC, attn_dim=AA)
        dcfg = acfg.decoder_config()
        params, bn_state = init_captioner(acfg, torch.Generator().manual_seed(SEED))

        def attn_plain(cap, images_u8):
            """The same features, decoded with the fused step's plain twin on the card."""
            with torch.inference_mode():
                feats = features(cap, images_u8)
                dec = cap.model.decoder
                prep = prepare_attn_decode(cap.prepared, dec, feats.transpose(1, 2))

                def step(w_emb, state):
                    tok, state2 = fused_attn_decode_step_plain(prep, w_emb, state)
                    return tok, state2, project_logits(prep["vocab"], last_h(state2))

                w0 = start_embeddings(dec, len(images_u8), acfg.start_token, device)
                return plain_loop(step, dec.embeddings.weight, w0, init_hidden(dec, dcfg, feats))

        acap = Captioner(params, bn_state, acfg, vocab, "bfloat16", device="gpu")
        requests = [img_rng.randint(0, 256, (64, 224, 224, 3), dtype=np.uint8) for _ in range(3)]
        served, seconds, counts = serve(acap, requests, counters, {counter.__name__: 3 * T})
        check_served(variant, served, requests, attn_plain, acap)
        phase("main", "%s: launches in the three requests %s (fused attention step = 3 x 25)" % (variant, counts))
        show_captions(variant, served)

        # the composite path, called directly: the flagship (H <= 2E) takes the fused step
        with torch.inference_mode():
            feats = features(acap, requests[0])
            for fn in counters:
                fn.launches = 0
            comp_ids = attn_greedy_decode_composite(acap.prepared, acap.model.decoder, dcfg, feats,
                                                    acfg.start_token).cpu().numpy()
            comp_counts = {fn.__name__: fn.launches for fn in counters}
            dec = acap.model.decoder
            feats_pm = feats.transpose(1, 2).contiguous()
            att1 = precompute_att1(dec.attn, feats_pm).to(acap.dtype).contiguous()
            weights = acap.prepared
            stack = stack_plain(dcfg.cell_type)

            def comp_step(w_emb, state):
                ctx, _ = attention_context_plain(weights, feats_pm, att1, last_h(state))
                x = torch.cat([w_emb, linear_f32(dec.embed, ctx).to(w_emb.dtype)], dim=-1)
                top, state2 = stack(weights["stacked"], x, state)
                return project_argmax_plain(weights["vocab"], top), state2, project_logits(weights["vocab"], top)

            comp_ref, _ = plain_loop(comp_step, dec.embeddings.weight,
                                     start_embeddings(dec, 64, acfg.start_token, device), init_hidden(dec, dcfg, feats))
        if comp_counts["attention_context"] != T or comp_counts["project_argmax"] != T:
            fail("%s composite decode launched %s, expected 25 context and 25 projection launches"
                 % (variant, comp_counts))
        share = float((comp_ids == comp_ref).mean())
        if share < 0.95:
            fail("%s composite decode: ids equal the plain composite decode on %.4f of positions (< 0.95)"
                 % (variant, share))
        phase("main", "%s composite bf16 B=64: launches %s; ids equal the plain composite decode on %.4f of "
              "positions" % (variant, comp_counts, share))
        acap32 = Captioner(params, bn_state, acfg, vocab, "float32", device="gpu")
        check_f32(variant, acap32, img_rng.randint(0, 256, (8, 224, 224, 3), dtype=np.uint8), counter, attn_plain)
        return counts[counter.__name__], seconds, comp_counts

    # 4. pooled main paths
    launches, slice_s = {}, {}
    for variant, Ed, counter in (("gru", E, fused_gru_decode_step), ("lstm", LE, fused_lstm_decode_step)):
        launches[counter.__name__], slice_s[variant] = pooled_slice(variant, Ed, counter)

    # 5. attention main paths
    comp = {}
    for variant, counter in (("attn", fused_attn_decode_step), ("attn_lstm", fused_attn_lstm_decode_step)):
        launches[counter.__name__], slice_s[variant], comp[variant] = attention_slice(variant, counter)
    for name in ("attention_context", "project_argmax"):
        launches[name] = sum(counts[name] for counts in comp.values())  # both composite decodes

    # 6. times (bf16, flagship widths)
    times = {}
    note = "(median of 30 after 5, CUDA events)"
    for name, cell, Ed, cuda_step, plain_step in (
            ("fused_gru_decode_step", "gru", E, fused_gru_decode_step_cuda, fused_gru_decode_step_plain),
            ("fused_lstm_decode_step", "lstm", LE, fused_lstm_decode_step_cuda, fused_lstm_decode_step_plain)):
        for B in (1, 64, 512):
            stacked, vocab_w, x, state = step_inputs(rng, B, torch.bfloat16, device, Ed, cell)
            times[name, B] = (event_median_ms(lambda: cuda_step(stacked, vocab_w, x, state)),
                              event_median_ms(lambda: plain_step(stacked, vocab_w, x, state)))
    for B in (1, 64, 256):
        for name, cell in (("fused_attn_decode_step", "gru"), ("fused_attn_lstm_decode_step", "lstm")):
            prep, w_emb, state = attn_inputs(rng, B, torch.bfloat16, device, cell)
            times[name, B] = (event_median_ms(lambda: fused_attn_decode_step_cuda(prep, w_emb, state)),
                              event_median_ms(lambda: fused_attn_decode_step_plain(prep, w_emb, state)))
        h = last_h(state)
        feats = uniform(rng, (B, AP, AC), 1.0, torch.bfloat16, device)
        times["attention_context", B] = (
            event_median_ms(lambda: attention_context_cuda(prep, feats, prep["att1"], h)),
            event_median_ms(lambda: attention_context_plain(prep, feats, prep["att1"], h)))
        times["project_argmax", B] = (
            event_median_ms(lambda: project_argmax_cuda(prep["vocab"], h)),
            event_median_ms(lambda: project_argmax_plain(prep["vocab"], h)))
    for (name, B), (k_ms, p_ms) in times.items():
        phase("times", "%s bf16 %s B=%d: kernel %.4f ms, plain %.4f ms %s" % (card, name, B, k_ms, p_ms, note))
    for variant, what in (("gru", "pooled-GRU slice, bf16, ResNet-101"),
                          ("lstm", "pooled-LSTM slice, bf16, ResNet-101"),
                          ("attn", "attention-GRU slice, bf16, spatial ResNet-101"),
                          ("attn_lstm", "attention-LSTM slice, bf16, spatial ResNet-101")):
        phase("times", "%s %s + 25 greedy steps: %.1f captions/s at B=64 (3 requests, %.3f s, host clock to ids on "
              "the host)" % (card, what, 3 * 64 / slice_s[variant], slice_s[variant]))

    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "show_tell_tpu"))
    if leaked:
        fail("the port's path imported %s" % leaked[:5])

    rows = [
        ("fused_gru_decode_step", "fused_step.cu", "show_tell_tpu/ops/fused_step_pallas.py:255"),
        ("fused_lstm_decode_step", "fused_step.cu", "show_tell_tpu/ops/fused_step_pallas.py:277"),
        ("fused_attn_decode_step", "fused_attn_step.cu", "show_tell_tpu/ops/fused_attn_pallas.py:330"),
        ("fused_attn_lstm_decode_step", "fused_attn_step.cu", "show_tell_tpu/ops/fused_attn_pallas.py:330"),
        ("attention_context", "attention_context.cu", "show_tell_tpu/ops/attention_pallas.py:94"),
        ("project_argmax", "project_argmax.cu", "show_tell_tpu/ops/vocab_pallas.py:170"),
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": "show_tell_tpu_torch/csrc/" + src,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": errs[name],
        "ms": times[name, 64][0],
        "plain_ms": times[name, 64][1],
    } for name, src, replaces in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
