#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero with no ok line):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: the CUDA kernels from show_tell_tpu_torch/csrc, with nvcc;
  3. kernel against plain: the fused greedy decode step at the flagship
     widths (L=5, E=256, H=512, V=9,956), B = 1, 64, 512, f32 and bf16,
     plus a cross-block argmax tie;
  4. main path: a flagship pooled-GRU Captioner (ResNet-101, random
     weights from seed 0, bf16) serves three requests of 64 images; the
     fused step must have launched 3 x 25 times and the ids must agree
     with the plain step's decode; then once more in f32 at B=8;
  5. times: per-step kernel and plain times, and captions/s.
The last lines are the card's name and power limit, a JSON line of the
kernels, and {"ok": true, "device": {...}}.
"""

import json
import os
import statistics
import subprocess
import sys
import time

L, E, H, V = 5, 256, 512, 9956
SEED = 0


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


def step_inputs(rng, B, dtype, device):
    """Decode-step inputs at the flagship widths, kernel layout: weights
    U(+-1/sqrt(H)) as the decoder init draws them, layer 0 zero-padded
    from E to H, hidden state in (-1, 1)."""
    import torch

    bound = 1.0 / H ** 0.5
    t = lambda a: torch.from_numpy(a.astype("float32")).to(device=device, dtype=dtype).contiguous()
    w_ih = rng.uniform(-bound, bound, (L, 3 * H, H))
    w_ih[0, :, E:] = 0.0
    stacked = {
        "w_ih": t(w_ih),
        "w_hh": t(rng.uniform(-bound, bound, (L, 3 * H, H))),
        "b_ih": t(rng.uniform(-bound, bound, (L, 3 * H))),
        "b_hh": t(rng.uniform(-bound, bound, (L, 3 * H))),
    }
    vocab = {"w": t(rng.uniform(-bound, bound, (V, H))), "b": t(rng.uniform(-bound, bound, V))}
    x = rng.randn(B, H)
    x[:, E:] = 0.0
    return stacked, vocab, t(x), t(rng.uniform(-1, 1, (L, B, H)))


def top2_gap(logits):
    top = logits.float().topk(2, dim=-1).values
    return top[:, 0] - top[:, 1]


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
                                          "already built" if cached else "nvcc ran"))

    # 3. kernel against plain
    from show_tell_tpu_torch.ops.fused_step import (
        fused_gru_decode_step,
        fused_gru_decode_step_cuda,
        fused_gru_decode_step_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tol = {torch.float32: (1e-5, 1e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2, 5e-2)}  # rtol, atol, token gap
    main_err = None
    rng = np.random.RandomState(SEED)
    for dtype in (torch.float32, torch.bfloat16):
        rtol, atol, gap_min = tol[dtype]
        for B in (1, 64, 512):
            stacked, vocab, x, hs = step_inputs(rng, B, dtype, device)
            tok, new_hs = fused_gru_decode_step_cuda(stacked, vocab, x, hs)
            torch.cuda.synchronize()
            ref_tok, ref_hs = fused_gru_decode_step_plain(stacked, vocab, x, hs)
            err = (new_hs.float() - ref_hs.float()).abs().max().item()
            if not torch.allclose(new_hs.float(), ref_hs.float(), rtol=rtol, atol=atol):
                fail("kernel new_hs differs from plain: %s B=%d max_abs_err %g" % (dtype, B, err))
            logits = ref_hs[-1].float() @ vocab["w"].float().T + vocab["b"].float()
            clear = top2_gap(logits) > gap_min
            bad = int(((tok != ref_tok) & clear).sum())
            if bad:
                fail("kernel tokens differ from plain on %d rows with a top-2 gap > %g (%s B=%d)"
                     % (bad, gap_min, dtype, B))
            if dtype == torch.bfloat16 and B == 64:
                main_err = err
            phase("kernel", "%s B=%d new_hs max_abs_err %.3g (rtol %g atol %g); tokens equal on all %d rows "
                  "with top-2 gap > %g, %d rows closer" % (str(dtype).split(".")[1], B, err, rtol, atol,
                                                            int(clear.sum()), gap_min, B - int(clear.sum())))
        stacked, vocab, x, hs = step_inputs(rng, 64, dtype, device)
        vocab["w"][9000] = vocab["w"][7]
        vocab["b"][7] = vocab["b"][9000] = 100.0
        tok, _ = fused_gru_decode_step_cuda(stacked, vocab, x, hs)
        ref_tok, _ = fused_gru_decode_step_plain(stacked, vocab, x, hs)
        if not (bool((tok == 7).all()) and bool((ref_tok == 7).all())):
            fail("tie of columns 7 and 9000 not resolved to 7 (%s): %s" % (dtype, tok.unique().tolist()))
        phase("kernel", "%s tie between columns 7 and 9000 -> 7 on all 64 rows" % str(dtype).split(".")[1])

    # 4. main path
    from show_tell_tpu_torch.data.transforms import preprocess_images
    from show_tell_tpu_torch.models.captioner import CaptionerConfig, init_captioner
    from show_tell_tpu_torch.models.decoder import greedy_loop
    from show_tell_tpu_torch.ops.rnn import pad_cols
    from show_tell_tpu_torch.serve import Captioner

    cfg = CaptionerConfig("gru", 101, E, H, V, L)
    vocab = SyntheticVocab(V)
    params, bn_state = init_captioner(cfg, torch.Generator().manual_seed(SEED))
    img_rng = np.random.RandomState(SEED + 1)

    def plain_decode(cap, images_u8, B):
        """The same features, decoded with the plain step on the card;
        returns ids and the smallest top-2 logit gap along each row."""
        with torch.inference_mode():
            x = preprocess_images(torch.from_numpy(images_u8).to(device), augment=False, dtype=cap.dtype)
            feats = cap.model.encoder(x)
            prep = cap.prepared
            gaps = []

            def step(xx, hs):
                tok, hs2 = fused_gru_decode_step_plain(prep["stacked"], prep["vocab"], xx, hs)
                logits = hs2[-1].float() @ prep["vocab"]["w"].float().T + prep["vocab"]["b"].float()
                gaps.append(top2_gap(logits))
                return tok, hs2

            x0 = pad_cols(feats.to(cap.dtype), H)
            hs0 = torch.zeros(L, B, H, dtype=cap.dtype, device=device)
            ids = greedy_loop(step, prep["embedding"], x0, hs0, cfg.max_caption_length)
            return ids.cpu().numpy(), torch.stack(gaps, 1).min(1).values.cpu().numpy()

    cap = Captioner(params, bn_state, cfg, vocab, "bfloat16", device="gpu")
    requests = [img_rng.randint(0, 256, (64, 224, 224, 3), dtype=np.uint8) for _ in range(3)]
    cap.caption_ids(requests[0])  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    fused_gru_decode_step.launches = 0
    t0 = time.perf_counter()
    served = [cap.caption_ids(imgs) for imgs in requests]
    serve_s = time.perf_counter() - t0
    launches = fused_gru_decode_step.launches
    if launches != 3 * cfg.max_caption_length:
        fail("main path launched the fused step %d times, expected %d" % (launches, 3 * cfg.max_caption_length))
    for i, (ids, imgs) in enumerate(zip(served, requests)):
        if ids.shape != (64, 25) or ids.min() < 0 or ids.max() >= V:
            fail("request %d: ids of shape %s in [%d, %d]" % (i, ids.shape, ids.min(), ids.max()))
        ref_ids, _ = plain_decode(cap, imgs, 64)
        share = float((ids == ref_ids).mean())
        if share < 0.95:
            fail("request %d: ids equal the plain step's decode on %.4f of positions (< 0.95)" % (i, share))
        phase("main", "bf16 request %d: [64,25] ids, equal to the plain step's decode on %.4f of positions"
              % (i, share))
    phase("main", "fused step launches in the three requests: %d (= 3 x 25)" % launches)
    captions = [" ".join(vocab.index_to_word[int(t)] for t in row[:8]) + " ..." for row in served[0][:3]]
    for c in captions:
        phase("main", "caption: %s" % c)

    cap32 = Captioner(params, bn_state, cfg, vocab, "float32", device="gpu")
    imgs = img_rng.randint(0, 256, (8, 224, 224, 3), dtype=np.uint8)
    fused_gru_decode_step.launches = 0
    ids32 = cap32.caption_ids(imgs)
    if fused_gru_decode_step.launches != cfg.max_caption_length:
        fail("f32 request launched the fused step %d times" % fused_gru_decode_step.launches)
    ref32, gaps32 = plain_decode(cap32, imgs, 8)
    same = (ids32 == ref32).all(axis=1)
    for r in np.flatnonzero(~same):
        phase("main", "f32 row %d differs from the plain decode; its smallest top-2 gap is %.3g" % (r, gaps32[r]))
    if same.mean() < 0.99:
        fail("f32 B=8: %d of 8 rows equal the plain decode (< 99%%)" % int(same.sum()))
    phase("main", "f32 B=8 (TF32 off): %d of 8 rows equal the plain step's decode" % int(same.sum()))
    del cap32

    # 5. times (bf16, flagship widths)
    times = {}
    for B in (1, 64, 512):
        stacked, vocab_w, x, hs = step_inputs(rng, B, torch.bfloat16, device)
        k_ms = event_median_ms(lambda: fused_gru_decode_step_cuda(stacked, vocab_w, x, hs))
        p_ms = event_median_ms(lambda: fused_gru_decode_step_plain(stacked, vocab_w, x, hs))
        times[B] = (k_ms, p_ms)
        phase("times", "%s bf16 decode step B=%d: kernel %.4f ms, plain %.4f ms (median of 30 after 5, CUDA events)"
              % (card, B, k_ms, p_ms))
    phase("times", "%s pooled-GRU slice, bf16, ResNet-101 + 25 greedy steps: %.1f captions/s at B=64 "
          "(3 requests, %.3f s, host clock to ids on the host)" % (card, 3 * 64 / serve_s, serve_s))

    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "show_tell_tpu"))
    if leaked:
        fail("the port's path imported %s" % leaked[:5])

    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "fused_gru_decode_step",
        "route": "cuda",
        "source": "show_tell_tpu_torch/csrc/fused_gru_step.cu",
        "replaces": "show_tell_tpu/ops/fused_step_pallas.py:255",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": times[64][0],
        "plain_ms": times[64][1],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
