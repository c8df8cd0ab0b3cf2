#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and eval paths once on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero with no ok line):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: the CUDA kernels from show_tell_tpu_torch/csrc, with nvcc, and
     beside them the grid-barrier probe (grid_barrier_probe.cu); ptxas's
     registers, stack and spills of the tensor-core instances (the bf16
     projection kernels, vocab_mma.cuh; the bf16 stem, stem.cu; the
     fourteen bf16 instances of dense_mma.cuh: the four dense beam steps,
     the two pooled top-k beam steps, the four greedy steps, pooled and
     attention, GRU and LSTM, the whole decode, the two stack steps and
     the attention context) and the tensor-core (HMMA) instructions in
     their SASS;
  3. kernel against plain, at the flagship widths: the pooled fused step,
     GRU (L=5, E=256, H=512, V=9,956; B = 1, 64, 512; and E=1024 > H) and
     LSTM (E=512, same B); the fused attention step, GRU and LSTM (L=5,
     E=H=A=512, P=49, V=9,956; B = 1, 64, 256); the attention context
     (C=2048, same B); the projection + argmax (H=512, V=9,956, same B);
     f32 and bf16, with cross-block argmax ties;
  3b. beam kernels against plain, same widths, R = B x K beam rows in
     {3, 5, 192, 320} (B in {1, 64}, K in {3, 5}), f32 and bf16: the
     pooled step's dense and top-k forms (both cells), the attention
     step's dense form (both cells), the projection + top-k; logits and
     top-k against the plain projection of the kernel's own new top
     activation, and top-k ties listed lower index first; digests of the
     f32 dense steps' outputs and of the greedy steps that keep the SIMT
     code (every f32 instance), and of the bf16 pooled GRU step, at B = 1
     and 64 (two builds that print the same digests agree bit for bit);
  3c. input kernels against plain, f32 and bf16: the preprocess (C = 3
     and 12, B = 1 and 64, and two odd shapes) bit for bit; the fused stem
     (s2d and RGB layouts, pool on and off, B = 1 and 64) within STEM_TOL,
     bf16 also within one bf16 ulp, with its share of bit-equal values;
  3d. the greedy routes' other kernels, f32 and bf16, B = 1, 64, 512: the
     whole-decode kernel (all 25 steps in one launch) bit-equal to the
     per-step kernel's loop and against its twin, with a cross-block tie
     (columns 7 and 9000) and a tie across the first 64-row vocabulary
     item boundary (63 and 64);
     the GRU (E=256) and LSTM (E=512) stack steps against their twins,
     in bf16 also launched twice (bit-equal) with the arrival counters of
     their K split back at zero;
  3e. the bf16 projection kernels' V-tiles on this card, and a tie across
     the first V-tile boundary in both projection kernels, f32 and bf16;
  4. pooled main paths: a flagship pooled-GRU Captioner (ResNet-101,
     random weights from seed 0, bf16; its default encoder route, the
     BN-folded encoder where ops.fold_bn_default() is on, as on the
     card) serves three requests of 64
     images; the fused step must have launched 3 x 25 times and the ids
     must agree with the plain step's decode; then once more in f32 at
     B=8.  Then the same Captioner serves three requests at beam width 3
     (3 x 24 launches of the dense beam step; ids against a beam decode
     with the plain twins as steps) and one f32 beam request at B=8, and
     the first request's features are decoded by the other fused route
     (top-k or dense: serving takes the one beam_step_default() names)
     and the sparse composite (24 launches each).  Every stock request launches
     the preprocess kernel once, and its greedy ids must equal on every
     row, bf16 and f32, those of the same kernels fed the plain twin's
     preprocess.  Then an s2d Captioner of the same weights serves the
     same pixels (three requests of 64, bf16: 3 stem launches; the
     served stem within one bf16 ulp of its twin at every value, the
     plain decode from it against that from the twin at least as close
     as S2D_CONTROLS one-ulp controls a request, the ids against the
     plain decode from the served stem; the pooled GRU also one f32
     request of 8, every row equal to the twin + the plain decode).  The same for a flagship
     pooled-LSTM Captioner (E=512) and the steps' LSTM instances.  The
     pooled GRU's three requests are decoded once more from their features
     by the whole-decode kernel (one launch a request, the served ids);
     one request of each pooled family goes through the sharded-projection
     route (captioner_greedy_decode(vocab_sharded=True): 25 stack-step
     launches, ids against the plain decode); the f32 GRU Captioner's
     encode, with cuDNN's TF32 flag left at its default, equals an encode
     with TF32 off and differs from one in TF32;
  5. attention main paths: the same for a flagship attention-GRU and an
     attention-LSTM Captioner (spatial ResNet-101, C=2048, E=H=A=512),
     each followed by one composite decode of the same features at B=64
     (25 launches each of the context and projection kernels); beam as
     in 4 (3 x 24 dense-step launches and one context launch a request),
     and a sparse composite beam decode (25 context, 24 top-k launches;
     its ids against the served route's on 0.95 of positions or, where
     lower, the weakest of ROUTE_CONTROLS controls: the served route with
     each step's new state moved at random places by as many values and
     bf16 ulps as the composite step's differs from it on that input,
     itself held within the bf16 state tolerance), and the s2d path as in 4;
  5b. the CLI path: 130 generated JPEGs of COCO's sizes (640 x 480 and
     the like) captioned by the s2d pooled GRU through caption_paths at
     B=64 (two full batches and a padded one), overlapped and serial
     (equal captions), then by serve.main with --s2d 1 --image_cache twice
     from a checkpoint of the same weights: the same captions, and the
     second run all cache hits; then once with --fast_jpeg 1 (the native
     decoder's scaled decode), captions equal to caption_paths' with it.
     Which JPEG decoder ran (native libjpeg or PIL), and why, is printed;
  6. times: per-step kernel and plain times (the tensor-core greedy steps
     also with their operands cold in L2), captions/s of each slice,
     greedy and beam, greedy also over 12 requests a family in turns
     (median [min, max]), and the pooled GRU's beam routes side by side; the
     input kernels against their twins and yardsticks (the stem at B = 1
     and 64), and the stages of a stock and an s2d request; the attention
     context at B = 1, 64, 256 against its twin and its composite yardstick
     (addmm, leaky_relu, a matmul by w_full, softmax, bmm); the A/B behind
     whole_decode_default(): the whole-decode kernel against the per-step
     loop at B = 1, 64, 512, bf16 and f32, in turns, median [quartiles] (min, max) and the rounds each
     route won; the stack steps at B = 1, 64, 512, L2 warm and cold,
     against one torch.nn.GRU / LSTM call, and at every K split S = 1 .. 8
     beside the S that stack_tiles' rule takes; the
     cost of a grid barrier at the whole-decode kernel's grid; the
     projection kernels at B = 1, 64, 256 and R = 3, 192, 320 against
     their twins, bounds and composite yardsticks, L2 warm and cold; the
     dense beam steps at R = 3 and 192, L2 warm and cold, the pooled ones
     at R = 192 beside the stack step (their recurrence alone) and their
     composite yardstick (torch.nn.GRU / LSTM + torch.addmm), the pooled
     top-k steps beside theirs (the same + log_softmax + topk); the pooled
     GRU's and the attention GRU's dense beam decode at B=64; the A/B
     behind beam_step_default(): whole pooled GRU and LSTM beam decodes at
     K=3, B = 1, 64, 256, by the dense and the top-k route in turns;
     (a) a full-width reference-format torch .ckpt (model.N.*, unit.*) of
     the pooled GRU and the attention GRU served at B=64 through
     Captioner.from_checkpoint, ids equal to the Captioner built from the
     same weights; (b) the BN-folded encoder (models/serving.py) against
     the unfolded one for the same two families: f32 features within
     FOLD_F32_RTOL and f32 served ids equal on >= 0.95 of positions; in
     bf16 the unfolded route's three requests against the plain decode of
     its features (>= 0.95), and the folded features within twice the
     unfolded route's error against the f32 features (the bar of "bf16
     ids of the two routes equal on >= 0.95" does not hold on random
     weights: each bf16 route parts from the f32 route's ids on about half
     the positions, PERF.md section 6); and the A/B behind
     fold_bn_default(): the encoder alone from uint8, B = 1 and 64, bf16
     and f32, the routes in turns by CUDA events;
  7. training: train.loop.train, 2 epochs at B=32 (4 steps each) on 130
     generated JPEGs of COCO's sizes with one caption each from the
     synthetic vocabulary (saved as vocab.pkl and loaded by
     get_vocabulary; the dataset tokenizes them with the port's
     word_tokenize, which needs no nltk), for the four flagship families
     in f32 and the pooled GRU and attention GRU in bf16 (TRAIN_RUNS); no
     kernel runs in training.  Each step's loss (finite); the f32 first step on the card
     against the same step on the CPU (the loss; the frozen backbone's
     train-mode output, with a TF32 control; from one backbone output,
     every trainable gradient's norm); the bf16 first loss against the
     f32 one (5% + 0.05); train images/s by CUDA events and the host
     clock; which tokenizer and JPEG decoder ran.  From the pooled GRU's
     model_2.ckpt: an eval step (25 launches of the fused greedy step, ids
     against the plain decode) and one request of 64 served through
     Captioner.from_checkpoint (ids against the plain decode, >= 0.95);
     (c) data parallelism: a one-rank nccl group (the pooled GRU), then two
     gloo ranks on cuda:0 (the pooled and the attention GRU), spawned,
     DP_STEPS f32 steps at global B=32 with flips: the ranks equal, their
     losses, and from one backbone output the loss and every gradient's
     norm, within TRAIN_CPU_RTOL of one process's card steps;
  8. eval, on phase 7's f32 checkpoints (the 130 JPEGs in a test loader:
     B=32, five batches, the last of 2, no flips): evaluation.tester.
     test_model greedy for each family (25 launches of its fused step a
     batch; Candidate_Words_Dict equal, image by image, to the plain-twin
     decode of the same features, but where a choice of that decode has a
     gap <= 1e-4; the scores, and the host-clock split of a batch: the
     step queued, the batch consumed); the pooled GRU in bf16 (every
     score within 0.05 of f32); beam K=3 for the pooled GRU (the dense
     step) and the attention GRU (the dense step, the context at step 0),
     captions against the plain beam; the device syncs of one eval step
     (torch.cuda.set_sync_debug_mode); the faithful beam (the GRU on 8
     single-image batches) against the same decode on the CPU from the
     card's features; which caption scorer runs (native or Python, and
     why), and native scores equal to Python's on the phase's captions;
     train.loop.train(eval_every_epochs=1) for one epoch of the pooled GRU,
     its printed scores equal to a direct test_model call on its
     checkpoint; cli.run.run's test phase, its scores equal; eval
     images/s of each family f32 and the GRU bf16, PIPELINE_SCORING on and
     off in turns; (d) test_model over the two gloo ranks of (c) from the
     GRU's f32 checkpoint: its scores equal the one-process run's (the
     word-level ones exactly, test_loss within 1e-5).  Phase 8's launches
     join the kernels' counts;
  9. mesh serving: two gloo ranks spawned on cuda:0 serve the flagship
     pooled GRU (V=9,956: 4,978 vocabulary rows a rank under mp=2) and
     attention LSTM through Captioner(dp, mp) at (dp, mp) = (1, 2), then
     (2, 1): a bf16 request of 64 greedy and by beam K=3, an f32 request of
     8 greedy; each request's launches (under mp the stack step 25 times
     greedy, 24 beam, and the context 25 in the attention family; under dp
     the one-device routes); the ranks' ids equal; bf16 ids against the same
     route in one process (a one-rank vocabulary shard, or the served route
     on each rank's rows) on >= 0.95 of positions, f32 ids against the
     one-process Captioner's on every row whose top-2 gap exceeds 1e-4; the
     host clock of a request.  Its launches join the kernels' counts;
 10. learn: the demonstration of tools/demo_synthetic_torch.py (400
     generated images of coloured shapes, two captions each, 12 epochs,
     ResNet-18, E=64, H=128, L=1, V=25, B=32, Adam 0.002), trained and
     tested through cli.run.run on the card: (a) the pooled GRU in f32,
     (b) the same in bf16, (c) the attention GRU (C=512, A=64) with
     --next_token; each run's fused-step launches (25 a test batch: the
     GRU CLI's two in-training evals and the test phase); each
     checkpoint captions 64 unseen images (seed 999) in f32, held to
     quality floors on the first 16, fixed from the JAX package's results
     (LEARN_FLOORS), and its f32 ids to the plain-twin decode on every row
     whose choices have top-2 gaps above 1e-4; on (a)'s checkpoint the
     checks that random weights left blind: bf16 served ids against f32,
     s2d bf16 against the stock route, the unfolded encoder against the
     folded one in f32 and bf16 (shares of the caption positions: up to
     each reference row's first <end>), bf16 test_model within 0.05 of
     f32, and the card's f32 test_model against the CPU's (captions equal
     on 0.99 of images, scores within 0.01); the routes, its launches
     (which join the kernels' counts) and its seconds.
The last lines are the card's name and power limit, a JSON line of the
kernels, and {"ok": true, "device": {...}}.
"""

import ctypes
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
K_BEAM = 3  # the beam width of the main paths (the published widths are 3 and 5)
END, PAD = 2, 0  # SyntheticVocab's <end> and <pad>
BEAM_RS = ((3, 3), (5, 5), (192, 3), (320, 5))  # (R, K): R = B x K rows for B in {1, 64}
# Beam kernels: logits and top-k against the plain projection of the
# kernel's own new top activation isolate the f32 summation order: rtol =
# atol = 1e-4, and top-k ids equal on every row whose K+1 best logits are
# more than 1e-4 apart.  New states against the plain twin's: TOL, but
# 2e-5 in f32, as at R = 192 the attention step's f32 new_hs differs from
# cuBLAS's by up to 1.2e-5 (tests/test_torch_cuda.py on the card).
BEAM_TOL = 1e-4
BEAM_STATE_TOL = {"float32": 2e-5, "bfloat16": TOL["bfloat16"][0]}
IMG = 224  # the serving image side
N_FILES = 130  # the CLI phase: two full batches of 64 and one padded batch of 2
COCO_SIZES = ((640, 480), (640, 427), (480, 640), (427, 640))  # (width, height): MS-COCO's most common image sizes
CLI_TURNS = 5  # caption_paths runs in turns, each mode decoding the files and from the cache
# Fused stem against its twin, rtol = atol.  f32: both sum the 192 taps in
# f32 in one order, and the twin rounds each product (the kernel's FMA does
# not).  bf16: each product of a pixel and a bf16 weight is exact in f32,
# but the tensor cores add them in another order, so a value may round to
# the neighbouring bf16: also within one bf16 ulp (bf16_ulp_gaps).
STEM_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
S2D_CONTROLS = 4  # one-ulp controls a request on the s2d path (s2d_against_twin)
ROUTE_CONTROLS = 2  # controls of the attention beam's sparse composite route (route_decodes)
ROUTE_STATE_SHARE = 0.99  # of a composite step's state values within the bf16 tolerance of the served step's
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, the published peak
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
SPIN_CYCLES = 2_000_000  # about 1 ms at the H100's 1.98 GHz boost clock: longer than a wrapper's enqueue
# about 10 ms: longer than the host work of PyTorch's own RNN call, which issues several kernels a layer
LIBRARY_SPIN_CYCLES = 10 * SPIN_CYCLES
AB_ROUNDS, AB_REPS = 10, 5  # an A/B of two routes: rounds in turns, decodes timed together in each
BARRIERS = 1000  # grid barriers in one timed launch of the barrier probe
RATE_ROUNDS = 4  # greedy captions/s: rounds of each family's three requests, the families in turns
TRAIN_B, TRAIN_EPOCHS, TRAIN_TIMED = 32, 2, 4  # config.json's batch; epochs of each run; steps timed by CUDA events
# Phase 7's runs of train.loop.train: (variant, embed, optimizer, lr, train_dtype); lr and momentum 0.9 from
# config.json for SGD, Adam at its reference default 1e-3.  The bf16 runs start from the f32 runs' weights.
TRAIN_RUNS = (("gru", E, "SGD", 0.01, "float32"), ("lstm", LE, "Adam", 1e-3, "float32"),
              ("attn", AE, "SGD", 0.01, "float32"), ("attn_lstm", AE, "Adam", 1e-3, "float32"),
              ("gru", E, "SGD", 0.01, "bfloat16"), ("attn", AE, "SGD", 0.01, "bfloat16"))
# The f32 first step on the card against the CPU: the loss, and (from one backbone output) every trainable
# gradient's norm, within TRAIN_CPU_RTOL.  The frozen ResNet-101's train-mode output is held apart, within
# TRAIN_BACKBONE_RTOL: through 101 layers of batch-statistics BN the card's f32 convolutions and the CPU's part
# by about 1e-3 relative, far below a TF32 run's gap (the smoke measures both), and that spread reaches the
# gradients of the whole step, held within TRAIN_FULL_RTOL.
TRAIN_CPU_RTOL, TRAIN_BACKBONE_RTOL, TRAIN_FULL_RTOL = 1e-4, 5e-3, 1e-2
# The reference .ckpt and the fold A/B (phase 6): the pooled GRU and the attention GRU.  The folded route's f32
# features against the unfolded route's, relative to their largest value (the JAX package's fold bar, 2e-4).
FOLD_VARIANTS = (("gru", 256), ("attn", 512))
FOLD_F32_RTOL = 2e-4
# Phase 7's data-parallel runs: a one-rank nccl group (the pooled GRU) and two gloo ranks on cuda:0 (the pooled and
# the attention GRU), DP_STEPS steps at global B = TRAIN_B from the seeded weights, held to one process's card steps
# (TRAIN_CPU_RTOL: the losses, and from one backbone output the loss and every trainable gradient's norm).
DP_STEPS = 2
DP_TIMEOUT = 600  # seconds for each group of spawned ranks
# Phase 9, mesh serving: two gloo ranks on cuda:0 serve the pooled GRU and the attention LSTM at their flagship widths
# over a dp x mp mesh, first (dp, mp) = (1, 2) (V = 9,956: 4,978 vocabulary rows a rank), then (2, 1): a bf16 request
# of 64 greedy and by beam K_BEAM, and an f32 request of MESH_F32_ROWS greedy.
MESH_VARIANTS = (("gru", E), ("attn_lstm", AE))
MESH_SHAPES = ((1, 2), (2, 1))
MESH_F32_ROWS = 8
# Phase 10, learn: the demonstration of tools/demo_synthetic_torch.py at its defaults (400 images, 12 epochs,
# ResNet-18, E=64, H=128, L=1, Adam 0.002, B=32, no eval flips), trained and tested through cli.run.run on the card:
# (run, variant, --next_token, --train_dtype).
LEARN_RUNS = (("a", "gru", False, "float32"), ("b", "gru", False, "bfloat16"), ("c", "attn", True, "float32"))
LEARN_IMAGES, LEARN_EPOCHS = 400, 12
LEARN_PROBE = 64  # unseen images drawn at the demo's probe seed (999); the first 16 are the JAX tool's probe
# Quality floors, fixed before any card run from the JAX package's results on this task less a margin (README.md,
# BF16_CONV.json: the pooled GRU BLEU-4 0.316 and unseen colour 6/8; the attention GRU with --next_token 0.485,
# 16/16 colour and 16/16 shape): (BLEU-4, colour hits, shape hits) on the first 16 unseen images.
LEARN_FLOORS = {"a": (0.25, 10, 0), "b": (0.25, 0, 0), "c": (0.40, 14, 12)}
LEARN_JAX = {"a": "BLEU-4 0.316, colour 6/8", "b": "BLEU-4 0.337 (f32 0.316)", "c": "BLEU-4 0.485, 16/16, 16/16"}
GAP_TIE = 1e-4  # an f32 row must equal the plain decode where every choice's top-2 logit gap exceeds this


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


def write_coco_jpegs(img_dir, n, seed):
    """``n`` JPEGs of COCO's common sizes (smooth colour fields under grain,
    quality 90) into ``img_dir``; returns their sorted paths."""
    import numpy as np
    from PIL import Image

    frng = np.random.RandomState(seed)
    for i in range(n):
        w, h = COCO_SIZES[i % len(COCO_SIZES)]
        base = Image.fromarray(frng.randint(0, 256, (h // 32, w // 32, 3), dtype=np.uint8))
        field = np.asarray(base.resize((w, h), Image.BILINEAR), np.float32)
        grain = frng.normal(0.0, 12.0, (h, w, 3)).astype(np.float32)
        Image.fromarray(np.clip(field + grain, 0, 255).astype(np.uint8)).save(
            os.path.join(img_dir, "img%03d.jpg" % i), quality=90)
    return sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir))


class Recorder:
    """A loader that records the batches each epoch consumed."""

    def __init__(self, inner):
        self.inner, self.epochs = inner, []

    def __len__(self):
        return len(self.inner)

    def __iter__(self):
        self.epochs.append([])
        for batch in self.inner:
            self.epochs[-1].append(batch)
            yield batch


def event_median_ms(fn, iters=30, warmup=5, spin=SPIN_CYCLES, before=None):
    """Median over ``iters`` launches of the device time between CUDA
    events recorded around each call, after ``warmup`` calls.  Each timed
    call is queued behind a spin of the card (``spin`` cycles), so the host
    has enqueued the events and the call before the card reaches them: the
    events bracket device work, not the host's wrapper and launch time,
    which is most of a call that takes tens of microseconds on the card.
    A call whose host work outlasts the spin reads that work too.
    ``before``, if given, is queued between the spin and the first event
    (an L2 flush: the call then finds its operands in device memory)."""
    import torch

    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        if before is not None:
            before()
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(e0.elapsed_time(e1) for e0, e1 in pairs)


def event_rounds(routes):
    """CUDA-event ms a call of each route ({route: fn}), after one warm-up
    call each: AB_ROUNDS rounds of AB_REPS calls a route, the routes in
    turns (every other round in the reverse order), the card idle between
    routes."""
    import torch

    for fn in routes.values():
        fn()
    names = list(routes)
    ms = {name: [] for name in names}
    for rnd in range(AB_ROUNDS):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(AB_REPS):
                routes[name]()
            e1.record()
            torch.cuda.synchronize()
            ms[name].append(e0.elapsed_time(e1) / AB_REPS)
    return ms


def write_reference_ckpt(params, bn_state, path):
    """The JAX-layout trees as the reference saves a checkpoint
    (utils.py:131-138): the encoder's torchvision layers under their
    nn.Sequential indices (``model.N.*``, cnn.py:34), its head, the
    decoder's own names, torch tensors."""
    import numpy as np
    import torch

    from show_tell_tpu_torch.models.convert import params_from_jax

    seq = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5", "layer3": "6", "layer4": "7"}
    sds = params_from_jax(params, bn_state)
    enc = {}
    for k, v in sds["encoder"].items():
        if k.startswith("resnet."):
            root, _, tail = k[len("resnet."):].partition(".")
            k = "model.%s.%s" % (seq[root], tail)
        enc[k] = torch.from_numpy(np.ascontiguousarray(v))
    enc["last_layer.num_batches_tracked"] = torch.tensor(0)  # torch saves it with a BatchNorm1d
    dec = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sds["decoder"].items()}
    torch.save({"encoder_state_dict": enc, "decoder_state_dict": dec, "optimizer_state_dict": {}, "epoch": 1,
                "step": 0}, path)


def fixed_map(fmap):
    """A backbone module that returns ``fmap`` whatever the images, so that two steps share the frozen ResNet's
    output."""
    import torch

    class FixedMap(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fmap = fmap

        def forward(self, images):
            return self.fmap

    return FixedMap()


def dp_steps(cfg, init, batch, device, mesh, fmap):
    """DP_STEPS f32 SGD train steps (flips on, drawn for the global batch) from ``init`` on ``device``, over
    ``mesh`` (None: one process): their losses; then, from a fresh state whose backbone returns this rank's rows of
    ``fmap``, one step's loss and each trainable gradient's norm (f64 sums)."""
    from show_tell_tpu_torch.models.captioner import trainable_parameters
    from show_tell_tpu_torch.parallel.mesh import shard_rows
    from show_tell_tpu_torch.train.train_step import create_train_state, make_train_step

    ts = create_train_state(cfg, "SGD", 0.01, 0.9, device=device, seed=1, init=init, mesh=mesh)
    step = make_train_step(cfg)
    losses = [float(step(ts, *batch)) for _ in range(DP_STEPS)]
    del ts
    s = create_train_state(cfg, "SGD", 0.01, 0.9, device=device, seed=1, init=init, mesh=mesh)
    rows = slice(None) if mesh is None else shard_rows(mesh, len(fmap))
    s.model.encoder.resnet = fixed_map(fmap[rows].to(device))
    fixed = float(step(s, *batch))
    norms = {n: p.grad.double().norm().item() for n, p in trainable_parameters(s.model).items() if p.grad is not None}
    return {"losses": losses, "fixed_loss": fixed, "norms": norms}


def dp_worker(work):
    """One spawned rank of phase 7's data-parallel runs, in its group on cuda:0: dp_steps for each family in
    WORK/inputs.pkl, and, where the inputs hold phase 8's eval, test_model over the group; returns the results."""
    import pickle

    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from show_tell_tpu_torch.models.captioner import CaptionerConfig, init_captioner
    from show_tell_tpu_torch.parallel import multihost
    from show_tell_tpu_torch.parallel.mesh import make_mesh

    device = torch.device("cuda", 0)
    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    world = multihost.process_count()
    mesh = make_mesh(world, device=device)
    out = {"rank": multihost.process_index(), "backend": torch.distributed.get_backend(), "train": {}}
    for variant, cfg_fields in inputs["cfgs"].items():
        cfg = CaptionerConfig(*cfg_fields)
        init = init_captioner(cfg, torch.Generator().manual_seed(SEED))
        out["train"][variant] = dp_steps(cfg, init, inputs["batch"], device, mesh, inputs["fmaps"][variant])
        torch.cuda.empty_cache()
    if "eval" in inputs:
        from show_tell_tpu_torch.evaluation import tester
        from show_tell_tpu_torch.ops.fused_step import fused_gru_decode_step
        from show_tell_tpu_torch.train.checkpoint import read_checkpoint, restore_train_state
        from show_tell_tpu_torch.train.train_step import create_train_state

        ev = inputs["eval"]
        cfg = CaptionerConfig(*ev["cfg"])
        ts = create_train_state(cfg, "SGD", 0.01, device=device, seed=1)
        restore_train_state(ts, read_checkpoint(ev["ckpt"]))

        class Batches(list):
            batch_size = TRAIN_B

        fused_gru_decode_step.launches = 0
        out["eval"] = tester.test_model(ts, cfg, Batches(ev["batches"]), SyntheticVocab(cfg.vocab_size),
                                        {"output_dir": os.path.join(work, "eval"), "eval_augment": 0,
                                         "compute_dtype": "float32", "dp": world})
        out["eval_launches"] = fused_gru_decode_step.launches
    return out


def kernel_counters():
    """Every kernel wrapper, each counting its launches in ``.launches``."""
    from show_tell_tpu_torch.ops.attention import attention_context
    from show_tell_tpu_torch.ops.fused_attn import (
        fused_attn_decode_step,
        fused_attn_dense_step,
        fused_attn_lstm_decode_step,
        fused_attn_lstm_dense_step,
    )
    from show_tell_tpu_torch.ops.fused_beam import (
        fused_gru_dense_step,
        fused_gru_topk_step,
        fused_lstm_dense_step,
        fused_lstm_topk_step,
    )
    from show_tell_tpu_torch.ops.fused_step import fused_gru_decode_step, fused_lstm_decode_step
    from show_tell_tpu_torch.ops.preprocess import preprocess_u8
    from show_tell_tpu_torch.ops.rnn import gru_stack_step, lstm_stack_step
    from show_tell_tpu_torch.ops.stem import stem_fused
    from show_tell_tpu_torch.ops.vocab import project_argmax, project_topk
    from show_tell_tpu_torch.ops.whole_decode import gru_whole_greedy_decode

    return [fused_gru_decode_step, fused_lstm_decode_step, fused_attn_decode_step, fused_attn_lstm_decode_step,
            attention_context, project_argmax, fused_gru_dense_step, fused_lstm_dense_step, fused_gru_topk_step,
            fused_lstm_topk_step, fused_attn_dense_step, fused_attn_lstm_dense_step, project_topk, preprocess_u8,
            stem_fused, gru_whole_greedy_decode, gru_stack_step, lstm_stack_step]


def mesh_config(variant, Ed):
    from show_tell_tpu_torch.models.captioner import CaptionerConfig

    kw = dict(nos_filters=AC, attn_dim=AA) if variant.startswith("attn") else {}
    return CaptionerConfig(variant, 101, Ed, H, V, L, **kw)


def mesh_worker(work):
    """One spawned rank of phase 9 (mesh serving), in a group of two gloo ranks
    on cuda:0: for each family of MESH_VARIANTS (seeded weights) and each mesh
    of MESH_SHAPES, a bf16 Captioner(dp, mp) serves WORK/inputs.pkl's request
    of 64 greedy and by beam K_BEAM (after one warm-up request each), and an f32
    one its request of MESH_F32_ROWS greedy.  Every kernel count is set to 0
    just before each request and read just after it.  Returns the ids, the
    counts, the host-clock seconds of each bf16 request (to the ids on the
    host) and the vocabulary shard's shapes."""
    import pickle

    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from show_tell_tpu_torch.models.captioner import init_captioner
    from show_tell_tpu_torch.parallel import multihost
    from show_tell_tpu_torch.serve import Captioner

    device = torch.device("cuda", 0)
    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    counters = kernel_counters()
    vocab = SyntheticVocab(V)

    def request(cap, images, beam_size):
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        ids = cap.caption_ids(images, beam_size)
        return {"ids": ids, "seconds": time.perf_counter() - t0, "counts": {fn.__name__: fn.launches for fn in counters}}

    out = {"rank": multihost.process_index(), "backend": torch.distributed.get_backend(), "runs": {}}
    for variant, Ed in MESH_VARIANTS:
        cfg = mesh_config(variant, Ed)
        params, bn_state = init_captioner(cfg, torch.Generator().manual_seed(SEED))
        for dp, mp in MESH_SHAPES:
            cap = Captioner(params, bn_state, cfg, vocab, "bfloat16", device=device, dp=dp, mp=mp)
            dec = cap.model.decoder
            run = {"shapes": (tuple(dec.linear.weight.shape), tuple(dec.linear.bias.shape),
                              tuple(dec.embeddings.weight.shape))}
            for beam_size in (0, K_BEAM):  # warm-up: cuDNN plans, the allocator, the sort, the first collectives
                cap.caption_ids(inputs["request"], beam_size)
            run["greedy"] = request(cap, inputs["request"], 0)
            run["beam"] = request(cap, inputs["request"], K_BEAM)
            del cap
            cap32 = Captioner(params, bn_state, cfg, vocab, "float32", device=device, dp=dp, mp=mp)
            run["f32"] = request(cap32, inputs["request32"], 0)
            del cap32
            torch.cuda.empty_cache()
            out["runs"][variant, dp, mp] = run
    return out


def mesh_launches(variant, dp, mp, beam):
    """{kernel: launches} of one mesh request on each rank: under mp the
    stack step (after the attention context in the attention family) T
    times a greedy request, T - 1 a beam one (its first step is plain, the
    context's is not); under dp the one-device routes on the rank's rows."""
    from show_tell_tpu_torch.ops import beam_step_default, whole_decode_default

    attention, lstm = variant.startswith("attn"), variant.endswith("lstm")
    if mp > 1:
        out = {("lstm" if lstm else "gru") + "_stack_step": T - 1 if beam else T}
        if attention:
            out["attention_context"] = T
    elif beam:
        cell = "attn_lstm" if attention else ("lstm" if lstm else "gru")
        out = {"fused_%s_%s_step" % (cell, "dense" if attention else beam_step_default()): T - 1}
        if attention:
            out["attention_context"] = 1
    elif attention:
        out = {"fused_attn_lstm_decode_step" if lstm else "fused_attn_decode_step": T}
    elif not lstm and whole_decode_default():
        out = {"gru_whole_greedy_decode": 1}
    else:
        out = {"fused_%s_decode_step" % ("lstm" if lstm else "gru"): T}
    out["preprocess_u8"] = 1
    return out


def plain_features(cap, images_u8, stem=None):
    """The encoder through the plain twins: the preprocess's, or under s2d
    ``stem(images, operands)`` (NHWC; by default the fused stem's twin),
    then the ResNet (and head) as served, its f32 convolutions without TF32
    (scoped here: the global stays at its default)."""
    import torch

    from show_tell_tpu_torch.data.transforms import preprocess_images
    from show_tell_tpu_torch.ops.stem import stem_fused_plain

    x = torch.from_numpy(images_u8).to(cap.device)
    enc = cap.model.encoder
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        if cap.s2d:
            y = (stem or stem_fused_plain)(x, enc.stem_operands())
            return enc.head(enc.resnet.forward_from_stem(y.permute(0, 3, 1, 2)))
        return enc(preprocess_images(x, augment=False, dtype=cap.dtype))


def plain_loop(step, embedding, x0, state0):
    """greedy_loop over a plain step; returns ids and each row's smallest top-2 logit gap."""
    import torch

    from show_tell_tpu_torch.models.decoder import greedy_loop

    gaps = []

    def run(x, state):
        tok, state2, logits = step(x, state)
        gaps.append(top2_gap(logits))
        return tok, state2

    ids = greedy_loop(run, embedding, x0, state0, T)
    return ids.cpu().numpy(), torch.stack(gaps, 1).min(1).values.cpu().numpy()


def plain_decode(cap, images_u8, stem=None):
    """The same features as ``cap`` serves (under s2d from ``stem``), decoded
    greedily on the card with the plain twin of its fused step: (ids, each
    row's smallest top-2 logit gap along that decode)."""
    import torch

    from show_tell_tpu_torch.models.attention import init_hidden, last_h, start_embeddings
    from show_tell_tpu_torch.models.rnn_cells import init_state
    from show_tell_tpu_torch.ops.fused_attn import fused_attn_decode_step_plain, prepare_attn_decode
    from show_tell_tpu_torch.ops.fused_step import fused_gru_decode_step_plain, fused_lstm_decode_step_plain
    from show_tell_tpu_torch.ops.vocab import project_logits

    cfg, B = cap.cfg, len(images_u8)
    with torch.inference_mode():
        feats = plain_features(cap, images_u8, stem)
        if cfg.is_attention:
            dec = cap.model.decoder
            prep = prepare_attn_decode(cap.prepared, dec, feats.transpose(1, 2))

            def step(w_emb, state):
                tok, state2 = fused_attn_decode_step_plain(prep, w_emb, state)
                return tok, state2, project_logits(prep["vocab"], last_h(state2))

            w0 = start_embeddings(dec, B, cfg.start_token, cap.device)
            return plain_loop(step, dec.embeddings.weight, w0, init_hidden(dec, cfg.decoder_config(), feats))
        prep = cap.prepared
        plain_step = fused_lstm_decode_step_plain if cfg.cell_type == "lstm" else fused_gru_decode_step_plain

        def step(xx, state):
            tok, state2 = plain_step(prep["stacked"], prep["vocab"], xx, state)
            return tok, state2, project_logits(prep["vocab"], last_h(state2))

        state0 = init_state(cfg.cell_type, cfg.num_layers, B, cfg.hidden_dim, cap.dtype, cap.device)
        return plain_loop(step, prep["embedding"], feats.to(cap.dtype), state0)


def path_gaps(cap, images_u8, ids):
    """Each row's smallest top-2 logit gap along the decode of ``ids``:
    the plain stack (after the context's twin in the attention family) and
    projection in f32 on the card, fed the served features and ``ids``."""
    import torch

    from show_tell_tpu_torch.models.attention import init_hidden, last_h, linear_f32, start_embeddings
    from show_tell_tpu_torch.models.captioner import encode
    from show_tell_tpu_torch.models.rnn_cells import init_state
    from show_tell_tpu_torch.ops.attention import attention_context_plain, precompute_att1
    from show_tell_tpu_torch.ops.rnn import stack_plain
    from show_tell_tpu_torch.ops.vocab import project_logits

    cfg, dec, prep, device = cap.cfg, cap.model.decoder, cap.prepared, cap.device
    with torch.inference_mode():
        feats = encode(cap.model, torch.from_numpy(images_u8).to(device))
        tok = torch.from_numpy(ids).to(device).long()
        B = len(images_u8)
        if cfg.is_attention:
            feats_pm = feats.transpose(1, 2).contiguous()
            att1 = precompute_att1(dec.attn, feats_pm).to(cap.dtype).contiguous()
            state, x = init_hidden(dec, cfg.decoder_config(), feats), start_embeddings(dec, B, cfg.start_token,
                                                                                       device)
        else:
            state, x = init_state(cfg.cell_type, L, B, H, cap.dtype, device), feats.to(cap.dtype)
        gaps = []
        for t in range(T):
            xin = x
            if cfg.is_attention:
                ctx, _ = attention_context_plain(prep, feats_pm, att1, last_h(state))
                xin = torch.cat([x, linear_f32(dec.embed, ctx).to(x.dtype)], dim=-1)
            top, state = stack_plain(cfg.cell_type)(prep["stacked"], xin, state)
            gaps.append(top2_gap(project_logits(prep["vocab"], top)))
            x = dec.embeddings.weight.index_select(0, tok[:, t])
        return torch.stack(gaps, 1).min(1).values.cpu().numpy()


def mesh_phase(card):
    """Phase 9: serving over a dp x mp mesh.  Two gloo ranks spawned on
    cuda:0 (mesh_worker) serve each MESH_VARIANTS family at its flagship
    widths at (dp, mp) = (1, 2), then (2, 1): a bf16 request of 64 greedy
    and by beam K_BEAM, an f32 request of MESH_F32_ROWS greedy.  Held to
    the one-process Captioner on the same card: the ranks return the same
    ids; under mp each holds V/2 vocabulary rows; each request launched
    exactly mesh_launches(); bf16 ids equal on >= 0.95 of positions those
    of the same route in one process (mp: the Captioner with a one-rank
    vocabulary shard, the sharded route without collectives; dp: the
    served route on each rank's 32 rows as a request of its own), their
    share of the served route's ids printed beside; f32 ids equal the
    served route's on every row whose top-2 logit gap on its way exceeds
    1e-4.  ``card``: the card's name and power limit, printed beside the
    times.  Returns the launches of the ranks' requests, summed over the
    ranks.  No step is skipped or caught."""
    import pickle
    import shutil
    import tempfile

    import numpy as np
    import torch

    from show_tell_tpu_torch.models.captioner import init_captioner, prepare_decode
    from show_tell_tpu_torch.parallel import multihost
    from show_tell_tpu_torch.parallel.mesh import decoder_vocab_shard, make_mesh
    from show_tell_tpu_torch.serve import Captioner

    device = torch.device("cuda", 0)
    vocab = SyntheticVocab(V)

    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        rq = np.random.RandomState(SEED + 9)
        inputs = {"request": rq.randint(0, 256, (64, IMG, IMG, 3), dtype=np.uint8),
                  "request32": rq.randint(0, 256, (MESH_F32_ROWS, IMG, IMG, 3), dtype=np.uint8)}
        with open(os.path.join(work, "inputs.pkl"), "wb") as f:
            pickle.dump(inputs, f)
        t0 = time.perf_counter()
        try:
            results = multihost.spawn(mesh_worker, 2, (work,), device, "gloo", timeout=DP_TIMEOUT)
        except TimeoutError as e:
            fail("mesh serving ranks: %s" % e)
        seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    totals = {fn.__name__: 0 for fn in kernel_counters()}
    request = inputs["request"]
    for variant, Ed in MESH_VARIANTS:
        cfg = mesh_config(variant, Ed)
        params, bn_state = init_captioner(cfg, torch.Generator().manual_seed(SEED))
        cap = Captioner(params, bn_state, cfg, vocab, "bfloat16", device="gpu")
        twin = Captioner(params, bn_state, cfg, vocab, "bfloat16", device="gpu")
        decoder_vocab_shard(make_mesh(1, 1), twin.model.decoder)
        twin.prepared = prepare_decode(twin.model, twin.dtype)
        served, refs = {}, {}
        for name, k in (("greedy", 0), ("beam", K_BEAM)):
            served[name] = cap.caption_ids(request, k)
            refs[name, 1, 2] = twin.caption_ids(request, k)
            refs[name, 2, 1] = np.concatenate([cap.caption_ids(request[:32], k), cap.caption_ids(request[32:], k)])
        del cap, twin
        cap32 = Captioner(params, bn_state, cfg, vocab, "float32", device="gpu")
        ids32 = cap32.caption_ids(inputs["request32"])
        gaps32 = path_gaps(cap32, inputs["request32"], ids32)
        del cap32
        torch.cuda.empty_cache()
        for dp, mp in MESH_SHAPES:
            runs = [r["runs"][variant, dp, mp] for r in results]
            label = "%s (dp, mp) = (%d, %d)" % (variant, dp, mp)
            rows = -(-V // mp)
            for r, run in zip(results, runs):
                if run["shapes"] != ((rows, H), (rows,), (rows, Ed)):
                    fail("%s rank %d holds vocabulary tensors of shapes %s, expected %d rows"
                         % (label, r["rank"], run["shapes"], rows))
                for name in ("greedy", "beam", "f32"):
                    want = mesh_launches(variant, dp, mp, name == "beam")
                    got = {k: n for k, n in run[name]["counts"].items() if n}
                    if got != want:
                        fail("%s rank %d %s request launched %s, expected %s" % (label, r["rank"], name, got, want))
                    for k, n in got.items():
                        totals[k] += n
            for name in ("greedy", "beam", "f32"):
                if any((run[name]["ids"] != runs[0][name]["ids"]).any() for run in runs[1:]):
                    fail("%s %s: the ranks returned different ids" % (label, name))
            shares = {}
            for name in ("greedy", "beam"):
                ids = runs[0][name]["ids"]
                if ids.shape != (64, T) or ids.min() < 0 or ids.max() >= V:
                    fail("%s %s: ids of shape %s in [%d, %d]" % (label, name, ids.shape, ids.min(), ids.max()))
                shares[name] = (float((ids == refs[name, dp, mp]).mean()), float((ids == served[name]).mean()))
                if shares[name][0] < 0.95:
                    fail("%s bf16 %s: ids equal the one-process route's on %.4f of positions (< 0.95)"
                         % (label, name, shares[name][0]))
            got32 = runs[0]["f32"]["ids"]
            differ = [i for i in range(MESH_F32_ROWS) if (got32[i] != ids32[i]).any()]
            for i in differ:
                phase("mesh", "%s f32 row %d differs from the one-process Captioner's at %d of %d positions; its "
                      "smallest top-2 gap is %.3g" % (label, i, int((got32[i] != ids32[i]).sum()), T, gaps32[i]))
                if gaps32[i] > 1e-4:
                    fail("%s f32 row %d differs from the one-process Captioner's with a top-2 gap of %.3g (> 1e-4)"
                         % (label, i, gaps32[i]))
            phase("mesh", "%s %s two gloo ranks on cuda:0, bf16 B=64: launches a request on each rank greedy %s, "
                  "beam K=%d %s; vocabulary rows a rank %d; greedy ids equal the one-process route's on %.4f of "
                  "positions (the served route's %.4f), beam %.4f (%.4f); f32 B=%d: %d of %d rows equal the "
                  "one-process Captioner's; host clock a request (to the ids on the host, rank 0) greedy %.3f s, "
                  "beam %.3f s" % (
                      card, label, mesh_launches(variant, dp, mp, False), K_BEAM,
                      mesh_launches(variant, dp, mp, True), rows, shares["greedy"][0], shares["greedy"][1],
                      shares["beam"][0], shares["beam"][1], MESH_F32_ROWS, MESH_F32_ROWS - len(differ),
                      MESH_F32_ROWS, runs[0]["greedy"]["seconds"], runs[0]["beam"]["seconds"]))
    phase("mesh", "the two ranks took %.1f s (spawn, weights, build, requests)" % seconds)
    return totals


def caption_mask(ref, end):
    """Each row's caption positions: up to and including its first ``end`` (all T where it has none)."""
    import numpy as np

    mask = np.zeros(ref.shape, bool)
    for r, row in enumerate(ref):
        hits = np.flatnonzero(row == end)
        mask[r, : hits[0] + 1 if len(hits) else T] = True
    return mask


def id_shares(got, ref, end):
    """(share of ``ref``'s caption positions where ``got`` equals it, share of all [B, T] positions)."""
    mask = caption_mask(ref, end)
    return float((got == ref)[mask].mean()), float((got == ref).mean())


def learn_phase(card, counters):
    """Phase 10: the port learns the repo's demonstration task on the card.
    LEARN_RUNS train and test through cli.run.run, each run's launches read
    around it; each checkpoint captions LEARN_PROBE unseen images in f32
    (the quality floors on the first 16), its ids held to the plain-twin
    decode; then the checks that random weights left blind, on (a)'s
    checkpoint.  Returns the launch counts of its main-path runs."""
    import contextlib
    import io
    import pickle
    import re
    import shutil
    import tempfile

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import demo_synthetic_torch as demo
    from show_tell_tpu_torch.cli.run import run
    from show_tell_tpu_torch.ops import fold_bn_default, whole_decode_default
    from show_tell_tpu_torch.ops.fused_attn import fused_attn_decode_step, fused_attn_fits
    from show_tell_tpu_torch.ops.fused_step import fused_gru_decode_step
    from show_tell_tpu_torch.ops.preprocess import preprocess_u8
    from show_tell_tpu_torch.ops.stem import stem_fused
    from show_tell_tpu_torch.serve import Captioner, create_caption_word_format
    from show_tell_tpu_torch.vocab import tokenizer_name

    t_phase = time.perf_counter()
    step_of = {"gru": fused_gru_decode_step, "attn": fused_attn_decode_step}
    main_counts = []

    def counted(call, expected):
        """``call()`` with every count set to 0 just before and read just after (fails unless as ``expected``)."""
        for fn in counters:
            fn.launches = 0
        out = call()
        main_counts.append(read_counts(counters, {fn.__name__: n for fn, n in expected.items()}))
        return out

    def cli(variant, argv, dev, expected_steps):
        """cli.run.run on ``dev`` with its output kept; its decode kernel's launches counted (T a test batch)."""
        log = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(log):
                res = counted(lambda: run(variant, argv, device=dev),
                              {step_of[variant]: T * expected_steps} if dev == "gpu" else {})
        except BaseException:
            print(log.getvalue()[-4000:], flush=True)
            raise
        return res, log.getvalue(), time.perf_counter() - t0

    def served(cap, imgs):
        expected = {step_of[cap.cfg.variant]: T, (stem_fused if cap.s2d else preprocess_u8): 1}
        return counted(lambda: cap.caption_ids(imgs), expected)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_learn_")
    try:
        data = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        demo.build_dataset(data, LEARN_IMAGES)
        with open(os.path.join(data, demo.ANN_PATH)) as f:
            n_captions = len(json.load(f)["annotations"])
        batches = -(-n_captions // TRAIN_B)  # the test loader's batches (the last one short)
        probe_imgs, truths = demo.probe_images(LEARN_PROBE)
        phase("learn", "tokenizer: %s; the demo set: %d images, %d captions (%.1f s to draw and write); %d unseen "
              "images at seed %d" % (tokenizer_name(), LEARN_IMAGES, n_captions, time.perf_counter() - t0,
                                      LEARN_PROBE, demo.PROBE_SEED))
        Ed, Hd = demo.WIDTHS["embed_dim"], demo.WIDTHS["hidden_dim"]
        if not fused_attn_fits(Hd, Ed) or fused_attn_fits(Hd + 8, Ed):
            fail("fused_attn_fits(H=%d, E=%d) = %s and at H=%d %s: the rule is H <= 2E"
                 % (Hd, Ed, fused_attn_fits(Hd, Ed), Hd + 8, fused_attn_fits(Hd + 8, Ed)))
        phase("learn", "routes at E=%d, H=%d, L=1: the pooled GRU's greedy decode by the fused step a step "
              "(whole_decode_default() = %s); the attention GRU's by the fused attention step: fused_attn_fits(H=%d, "
              "E=%d) = True (H = 2E), and at H=%d > 2E False (the composite: the context and project_argmax kernels)"
              % (Ed, Hd, whole_decode_default(), Hd, Ed, Hd + 8))

        results = {}
        for label, variant, next_token, dtype in LEARN_RUNS:
            out = os.path.join(tmp, label)
            os.makedirs(out)
            argv = demo.cli_argv(variant, data, out, LEARN_EPOCHS, next_token, ["--train_dtype", dtype])
            # the GRU CLI's in-training eval: sub_batch_test (10) batches every 5 epochs, then the test phase
            steps = batches + (LEARN_EPOCHS // 5 * 10 if variant == "gru" else 0)
            res, log, seconds = cli(variant, argv, "gpu", steps)
            scores = res["scores"]
            losses = [float(x) for x in re.findall(r"^Epoch \d+ - ([0-9.]+) loss", log, re.M)]
            if len(losses) != LEARN_EPOCHS or not all(np.isfinite(v) for v in scores.values()):
                fail("learn (%s): epoch losses %s, scores %s; the log ends %r" % (label, losses, scores, log[-2000:]))
            cap32 = Captioner.from_checkpoint(os.path.join(out, "model_%d.ckpt" % LEARN_EPOCHS),
                                              os.path.join(out, "vocab.pkl"), variant=variant,
                                              compute_dtype="float32", device="gpu", **demo.WIDTHS)
            ids32 = served(cap32, probe_imgs)
            words = [" ".join(w) for w in create_caption_word_format(ids32, cap32.vocab)]
            color16, shape16 = demo.attribute_hits(truths[:16], words[:16])
            color, shape = demo.attribute_hits(truths, words)
            results[label] = scores
            phase("learn", "(%s) %s %s%s: cli.run.run trained %d epochs (loss %.4f -> %.4f) and tested in %.1f s "
                  "(host clock); %s launches %d; test phase BLEU-1 %.4f BLEU-4 %.4f ROUGE-L %.4f CIDEr %.4f "
                  "test_loss %.4f; unseen images, f32: colour %d/16, shape %d/16 (of %d: %d, %d); first caption: %s"
                  % (label, variant, dtype, " --next_token" if next_token else "", LEARN_EPOCHS, losses[0], losses[-1],
                     seconds, step_of[variant].__name__, T * steps, scores["Bleu_1"], scores["Bleu_4"],
                     scores["ROUGE_L"], scores["CIDEr"], scores["test_loss"], color16, shape16, LEARN_PROBE, color,
                     shape, words[0]))
            bleu, want_color, want_shape = LEARN_FLOORS[label]
            if scores["Bleu_4"] < bleu or color16 < want_color or shape16 < want_shape:
                fail("learn (%s): BLEU-4 %.4f, colour %d/16, shape %d/16 below the floors %.2f, %d, %d (JAX: %s)"
                     % (label, scores["Bleu_4"], color16, shape16, bleu, want_color, want_shape, LEARN_JAX[label]))
            phase("learn", "(%s) floors met: BLEU-4 >= %.2f, colour >= %d/16, shape >= %d/16 (the JAX package: %s)"
                  % (label, bleu, want_color, want_shape, LEARN_JAX[label]))
            # f32 served ids against the plain twin's decode of the same features
            ref, gaps = plain_decode(cap32, probe_imgs)
            same, sure = (ids32 == ref).all(axis=1), gaps > GAP_TIE
            if not same[sure].all():
                fail("learn (%s): f32 served ids differ from the plain decode on %d rows whose every choice has a "
                     "top-2 gap > %g" % (label, int((~same & sure).sum()), GAP_TIE))
            phase("learn", "(%s) f32 B=%d: served ids equal the plain-twin decode on %d of %d rows (every row whose "
                  "choices all have a top-2 gap > %g: %d; the smallest gap %.3g)"
                  % (label, LEARN_PROBE, int(same.sum()), LEARN_PROBE, GAP_TIE, int(sure.sum()), float(gaps.min())))
            if label == "a":
                trained = (cap32, ids32, out)
            del cap32
            torch.cuda.empty_cache()
        a, b = results["a"], results["b"]
        phase("learn", "(b) - (a), bf16 training against f32: %s" % ", ".join(
            "%s %+.4f" % (k, b[k] - a[k]) for k in ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L", "CIDEr",
                                                    "test_loss")))

        # the checks that random weights left blind, on (a)'s checkpoint
        cap32, ids32, out = trained
        end = cap32.end_idx
        ckpt, vocab_pkl = os.path.join(out, "model_%d.ckpt" % LEARN_EPOCHS), os.path.join(out, "vocab.pkl")

        def load(dtype, **kw):
            return Captioner.from_checkpoint(ckpt, vocab_pkl, variant="gru", compute_dtype=dtype, device="gpu",
                                             **demo.WIDTHS, **kw)

        def hold(what, got, ref, bar):
            caption, whole = id_shares(got, ref, end)
            if caption < bar:
                fail("learn: %s equal on %.4f of the caption positions (< %.2f; %.4f of all [%d, %d])"
                     % (what, caption, bar, whole, LEARN_PROBE, T))
            phase("learn", "%s: equal on %.4f of the caption positions (bar %.2f; on %.4f of all [%d, %d] positions)"
                  % (what, caption, bar, whole, LEARN_PROBE, T))

        cap16 = load("bfloat16")
        ids16 = served(cap16, probe_imgs)
        hold("(a) bf16 served ids against f32 served ids", ids16, ids32, 0.95)
        s2d16 = served(load("bfloat16", s2d=True), probe_imgs)
        hold("(a) s2d bf16 ids (the stem kernel) against the stock route's bf16 ids", s2d16, ids16, 0.95)
        other = not fold_bn_default()
        for dtype, ref, bar in (("float32", ids32, 0.99), ("bfloat16", ids16, 0.95)):
            got = served(load(dtype, fold_bn=other), probe_imgs)
            hold("(a) %s ids of the %s encoder against the %s one (the default)"
                 % (dtype, "folded" if other else "unfolded", "unfolded" if other else "folded"), got, ref, bar)
        del cap16, cap32, trained
        torch.cuda.empty_cache()

        # test_model: bf16 against f32 on the card, and the card's f32 against the CPU's, through the CLI's test phase
        def test_phase(name, extra, dev):
            d = os.path.join(tmp, name)
            os.makedirs(d)
            for f in ("model_%d.ckpt" % LEARN_EPOCHS, "vocab.pkl"):
                shutil.copy(os.path.join(out, f), os.path.join(d, f))
            argv = demo.cli_argv("gru", data, d, LEARN_EPOCHS, extra=["--is_training", "0"] + extra)
            res, _, seconds = cli("gru", argv, dev, batches)
            with open(os.path.join(d, "Candidate_Words_Dict.pickle"), "rb") as f:
                return res["scores"], pickle.load(f), seconds

        s16, _, sec16 = test_phase("a_bf16", ["--compute_dtype", "bfloat16"], "gpu")
        gap = {k: abs(s16[k] - a[k]) for k in a}
        worst = max(gap, key=gap.get)
        if gap[worst] > 0.05:
            fail("learn: bf16 test_model on (a)'s checkpoint: %s %.4f against f32 %.4f (bar 0.05)"
                 % (worst, s16[worst], a[worst]))
        phase("learn", "(a) bf16 test_model (cli.run.run --compute_dtype bfloat16, %.1f s): every score within %.4f "
              "of f32 (bar 0.05, the JAX package's; the farthest %s: %.4f against %.4f)"
              % (sec16, gap[worst], worst, s16[worst], a[worst]))
        scpu, cand_cpu, sec_cpu = test_phase("a_cpu", [], "cpu")
        with open(os.path.join(out, "Candidate_Words_Dict.pickle"), "rb") as f:
            cand_card = pickle.load(f)
        if sorted(cand_cpu) != sorted(cand_card):
            fail("learn: the CPU's test_model captioned other images than the card's")
        equal = sum(cand_cpu[k] == cand_card[k] for k in cand_card) / len(cand_card)
        gap = {k: abs(scpu[k] - a[k]) for k in a}
        worst = max(gap, key=gap.get)
        if equal < 0.99 or gap[worst] > 0.01:
            fail("learn: the card's f32 test_model against the CPU's: candidates equal on %.4f of images (bar 0.99); "
                 "%s %.4f against %.4f (bar 0.01)" % (equal, worst, a[worst], scpu[worst]))
        phase("learn", "(a) f32 test_model, card against CPU (cli.run.run --device cpu, %.1f s): candidate captions "
              "equal on %.4f of %d images (bar 0.99); every score within %.2g (bar 0.01; the farthest %s)"
              % (sec_cpu, equal, len(cand_card), gap[worst], worst))
        totals = {}
        for counts in main_counts:
            for name, n in counts.items():
                totals[name] = totals.get(name, 0) + n
        phase("learn", "%s launches in the phase's main-path runs %s; the phase took %.1f s"
              % (card, {k: v for k, v in totals.items() if v}, time.perf_counter() - t_phase))
        return totals
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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


def context_inputs(rng, B, dtype, device):
    """attention_context's operands at the attention flagship's widths: the
    weights (wdec [A, H], bdec, wfull), feats [B, P, C], att1 [B, P, A] and h [B, H]."""
    weights = {"wdec": uniform(rng, (AA, H), H ** -0.5, dtype, device),
               "bdec": uniform(rng, (AA,), H ** -0.5, dtype, device),
               "wfull": uniform(rng, (AA,), AA ** -0.5, dtype, device)}
    return (weights, uniform(rng, (B, AP, AC), 1.0, dtype, device), uniform(rng, (B, AP, AA), 1.0, dtype, device),
            uniform(rng, (B, H), 1.0, dtype, device))


def top2_gap(logits):
    top = logits.float().topk(2, dim=-1).values
    return top[:, 0] - top[:, 1]


def bf16_ulp_gaps(got, ref):
    """How many bf16 values lie more than one bf16 ulp (of the larger of the
    two) from the reference; below 2^-9, where an ulp is finer than the f32
    sums' order differences around relu's zero, more than 2^-16."""
    import torch

    g, r = got.float(), ref.float()
    ulp = torch.ldexp(torch.ones_like(g), torch.frexp(torch.maximum(g.abs(), r.abs())).exponent - 8)
    return int(((g - r).abs() > torch.clamp(ulp, min=2.0 ** -16)).sum())


def ulp_nudges(y, n, seed, ulps=None):
    """bf16 ``y`` with ``n`` of its positive values, at seeded random
    places, moved to the neighbouring bf16 value, up or down at random: a
    control with as many one-ulp differences as a kernel shows.  ``ulps``
    (int32, one a value moved; then n = its length): move each that many
    bf16 values instead, staying positive."""
    import torch

    g = torch.Generator(device=y.device).manual_seed(seed)
    flat = y.reshape(-1).clone()
    pos = (flat > 0).nonzero().squeeze(1)
    n = n if ulps is None else len(ulps)
    pick = pos[torch.randperm(len(pos), generator=g, device=y.device)[:n]]
    sign = torch.randint(0, 2, (len(pick),), generator=g, device=y.device) * 2 - 1
    bits = flat.view(torch.int16)  # positive bf16 values: the bit pattern +- k is the k-th neighbour above or below
    if ulps is None:
        bits[pick] += sign.to(torch.int16)
    else:
        moved = bits[pick].int() + sign * ulps[: len(pick)].to(y.device)
        bits[pick] = moved.clamp(1, 0x7F7F).to(torch.int16)
    return flat.view(y.shape)


def ulp_distances(got, ref):
    """For each value of bf16 ``got`` that differs from ``ref``: how many
    bf16 ulps (of the larger magnitude's binade) apart they are, int32."""
    import torch

    g, r = got.float(), ref.float()
    differ = g != r
    ulp = torch.ldexp(torch.ones_like(g), torch.frexp(torch.maximum(g.abs(), r.abs())).exponent - 8)
    return torch.round((g - r).abs()[differ] / ulp[differ]).clamp(min=1).to(torch.int32)


def check_states(what, got, ref, dtype, tol=None):
    import torch

    tol = tol or TOL[dname(dtype)][0]
    err = (got.float() - ref.float()).abs().max().item()
    if not torch.allclose(got.float(), ref.float(), rtol=tol, atol=tol):
        fail("%s differs from plain: max_abs_err %g (rtol = atol = %g)" % (what, err, tol))
    return err


def check_state(what, got, ref, dtype, tol=None):
    """new_hs, and for the LSTM new_cs, against the plain twin's; returns the larger error."""
    if isinstance(got, tuple):
        return max(check_states(what + " new_hs", got[0], ref[0], dtype, tol),
                   check_states(what + " new_cs", got[1], ref[1], dtype, tol))
    return check_states(what + " new_hs", got, ref, dtype, tol)


def check_tokens(what, tok, ref_tok, logits, dtype):
    gap_min = TOL[dname(dtype)][1]
    clear = top2_gap(logits) > gap_min
    bad = int(((tok != ref_tok) & clear).sum())
    if bad:
        fail("%s: tokens differ from plain on %d rows with a top-2 gap > %g" % (what, bad, gap_min))
    return int(clear.sum())


def greedy_rates(served, rounds):
    """Greedy captions/s of each family, {name: (Captioner, requests)}:
    after one warm-up request each, ``rounds`` rounds in which every family
    serves each of its requests once (the families in turns, reversed every
    other round), each request timed alone on the host clock, to ids on the
    host.  Returns {name: [captions/s of each request]}."""
    for cap, requests in served.values():
        cap.caption_ids(requests[0])
    rates = {name: [] for name in served}
    for rnd in range(rounds):
        for name in list(served) if rnd % 2 == 0 else list(served)[::-1]:
            cap, requests = served[name]
            for imgs in requests:
                t0 = time.perf_counter()
                cap.caption_ids(imgs)
                rates[name].append(len(imgs) / (time.perf_counter() - t0))
    return rates


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


# (kernel, source, the TPU kernel it replaces): every instance, greedy then beam
KERNEL_ROWS = [
    ("fused_gru_decode_step", "fused_step.cu", "show_tell_tpu/ops/fused_step_pallas.py:255"),
    ("fused_lstm_decode_step", "fused_step.cu", "show_tell_tpu/ops/fused_step_pallas.py:277"),
    ("fused_attn_decode_step", "fused_attn_step.cu", "show_tell_tpu/ops/fused_attn_pallas.py:330"),
    ("fused_attn_lstm_decode_step", "fused_attn_step.cu", "show_tell_tpu/ops/fused_attn_pallas.py:330"),
    ("attention_context", "attention_context.cu", "show_tell_tpu/ops/attention_pallas.py:94"),
    ("project_argmax", "project_argmax.cu", "show_tell_tpu/ops/vocab_pallas.py:170"),
    ("fused_gru_dense_step", "fused_step.cu", "show_tell_tpu/ops/fused_beam_pallas.py:347"),
    ("fused_lstm_dense_step", "fused_step.cu", "show_tell_tpu/ops/fused_beam_pallas.py:347"),
    ("fused_gru_topk_step", "fused_step.cu", "show_tell_tpu/ops/fused_beam_pallas.py:377"),
    ("fused_lstm_topk_step", "fused_step.cu", "show_tell_tpu/ops/fused_beam_pallas.py:377"),
    ("fused_attn_dense_step", "fused_attn_step.cu", "show_tell_tpu/ops/fused_attn_pallas.py:353"),
    ("fused_attn_lstm_dense_step", "fused_attn_step.cu", "show_tell_tpu/ops/fused_attn_pallas.py:353"),
    ("project_topk", "project_topk.cu", "show_tell_tpu/ops/vocab_pallas.py:296"),
    ("preprocess_images", "preprocess.cu", "show_tell_tpu/ops/preprocess_pallas.py:41"),
    ("stem_fused", "stem.cu", "show_tell_tpu/ops/stem_pallas.py:167"),
    ("gru_whole_greedy_decode", "whole_decode.cu", "show_tell_tpu/ops/whole_decode_pallas.py:240"),
    ("gru_stack_step", "fused_step.cu", "show_tell_tpu/ops/rnn_pallas.py:247"),
    ("lstm_stack_step", "fused_step.cu", "show_tell_tpu/ops/rnn_pallas.py:221"),
]
BEAM_KERNELS = {name for name, _, _ in KERNEL_ROWS[6:13]}
LIBRARY_CALLS = {  # what a row's library_ms times
    "project_argmax": "composite: torch.addmm + argmax",
    "project_topk": "composite: torch.addmm + log_softmax + topk",
    "fused_gru_dense_step": "composite: torch.nn.GRU + torch.addmm",
    "fused_lstm_dense_step": "composite: torch.nn.LSTM + torch.addmm",
    "fused_gru_topk_step": "composite: torch.nn.GRU + torch.addmm + log_softmax + topk",
    "fused_lstm_topk_step": "composite: torch.nn.LSTM + torch.addmm + log_softmax + topk",
    "gru_stack_step": "torch.nn.GRU",
    "lstm_stack_step": "torch.nn.LSTM",
    "stem_fused": "composite: cuDNN conv2d + relu + max_pool2d",
    "attention_context": "composite: torch.addmm + leaky_relu + matmul + softmax + bmm",
}
COUNTER_OF = {"preprocess_images": "preprocess_u8"}  # a row's launch counter, where its name differs


def check_logits(what, logits, top, vocab):
    """Dense logits against the plain projection of the kernel's own top."""
    import torch

    from show_tell_tpu_torch.ops.vocab import project_logits

    ref = project_logits(vocab, top)
    err = (logits - ref).abs().max().item()
    if not torch.allclose(logits, ref, rtol=BEAM_TOL, atol=BEAM_TOL):
        fail("%s logits differ from the plain projection: max_abs_err %g (rtol = atol = %g)" % (what, err, BEAM_TOL))
    return err


def check_topk(what, logp, ids, top, vocab, k):
    """(logp, ids) against the plain top-k of the projection of the kernel's
    own top; returns (logp max_abs_err, rows whose ids had to be equal)."""
    import torch

    from show_tell_tpu_torch.ops.vocab import project_logits, project_topk_plain

    ref_logp, ref_ids = project_topk_plain(vocab, top, k)
    err = (logp - ref_logp).abs().max().item()
    if not torch.allclose(logp, ref_logp, rtol=BEAM_TOL, atol=BEAM_TOL):
        fail("%s logp differs from the plain top-k: max_abs_err %g (rtol = atol = %g)" % (what, err, BEAM_TOL))
    best = project_logits(vocab, top).topk(k + 1, dim=-1).values
    clear = (best[:, :-1] - best[:, 1:]).min(dim=1).values > BEAM_TOL
    bad = int((ids != ref_ids)[clear].any(dim=1).sum())
    if bad:
        fail("%s: top-%d ids differ from plain on %d rows whose %d best logits are > %g apart"
             % (what, k, bad, k + 1, BEAM_TOL))
    return err, int(clear.sum())


def projection_tile_ties(rng, device):
    """Phase 3e.  Columns mv - 1 and mv, on either side of the first V-tile
    boundary of the bf16 projection kernels at the flagship V (the tile
    vocab_tiles picks on this card), equal and top in every row:
    project_argmax gives mv - 1 and project_topk lists mv - 1 then mv, f32
    and bf16, at B = 64 and R = 192 rows."""
    import torch

    from show_tell_tpu_torch.ops.vocab import project_argmax_cuda, project_topk_cuda, vocab_tiles

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    g = vocab_tiles(H, V, sms)
    phase("kernel", "bf16 projection tiles at H=%d, V=%d on %d SMs: %d rows a V-tile, %d tiles, %d bytes of shared "
          "memory a block" % (H, V, sms, g.mv, g.tiles, g.smem))
    pair = torch.tensor([g.mv - 1, g.mv], device=device)
    for dtype in (torch.float32, torch.bfloat16):
        for rows in (64, 192):
            vocab = vocab_inputs(rng, H, dtype, device)
            vocab["w"][g.mv] = vocab["w"][g.mv - 1]
            vocab["b"][g.mv - 1] = vocab["b"][g.mv] = 100.0
            top = uniform(rng, (rows, H), 1.0, dtype, device)
            tok = project_argmax_cuda(vocab, top)
            ids = project_topk_cuda(vocab, top, K_BEAM)[1]
            if not bool((tok == g.mv - 1).all()) or not bool((ids[:, :2] == pair).all()):
                fail("project_argmax / project_topk %s rows=%d: tie of columns %d and %d across the first V-tile "
                     "boundary not resolved to %d / listed as [%d, %d]"
                     % (dname(dtype), rows, g.mv - 1, g.mv, g.mv - 1, g.mv - 1, g.mv))
            phase("kernel", "project_argmax and project_topk %s rows=%d: tie between columns %d and %d, across the "
                  "first V-tile boundary -> %d and [%d, %d, ...] on every row"
                  % (dname(dtype), rows, g.mv - 1, g.mv, g.mv - 1, g.mv - 1, g.mv))


# the bf16 projection kernels (vocab_mma.cuh) and the bf16 stem (stem.cu)
TILE_KERNELS = ("project_argmax_tiles_kernel", "project_topk_tiles_kernel", "stem_mma_kernel")
# the bf16 instances on the tensor cores (csrc/dense_mma.cuh: mma_step(), and the attention context's att2 phase):
# entry point -> (kernel template, cell, vocab end: kArgmax = 0, kDense = 1, kTopk = 2, kNone = 3; None where the
# template names neither: the whole decode, GRU and argmax; the attention context)
MMA_STEPS = {
    "st_fused_gru_dense_step": ("fused_step_kernel", "GruCell", 1),
    "st_fused_lstm_dense_step": ("fused_step_kernel", "LstmCell", 1),
    "st_fused_gru_topk_step": ("fused_step_kernel", "GruCell", 2),
    "st_fused_lstm_topk_step": ("fused_step_kernel", "LstmCell", 2),
    "st_fused_attn_dense_step": ("fused_attn_step_kernel", "GruCell", 1),
    "st_fused_attn_lstm_dense_step": ("fused_attn_step_kernel", "LstmCell", 1),
    "st_fused_gru_step": ("fused_step_kernel", "GruCell", 0),
    "st_fused_lstm_step": ("fused_step_kernel", "LstmCell", 0),
    "st_fused_attn_step": ("fused_attn_step_kernel", "GruCell", 0),
    "st_fused_attn_lstm_step": ("fused_attn_step_kernel", "LstmCell", 0),
    "st_whole_gru_decode": ("whole_gru_kernel", None, None),
    "st_gru_stack_step": ("fused_step_kernel", "GruCell", 3),
    "st_lstm_stack_step": ("fused_step_kernel", "LstmCell", 3),
    "st_attention_context": ("attention_context_kernel", None, None),
}
NO_SPILL = set(MMA_STEPS) | {"stem_mma_kernel"}  # instances that fail the build phase with a stack frame or spills


def tensor_core_kernel(name):
    """The label of a kernel name (mangled, as cuobjdump prints it, or
    demangled, as ptxas_report does) among the tensor-core instances, or None."""
    import re

    tile = next((k for k in TILE_KERNELS if k in name), None)
    if tile:
        return tile
    for label, (base, cell, mode) in MMA_STEPS.items():
        if ((base + "<" in name or base + "I" in name) and "__nv_bfloat16" in name and (cell is None or cell in name)
                and (mode is None or re.search(r"(, (\(int\))?%d>|ELi%dE)" % (mode, mode), name))):
            return label
    return None


PTXAS_SOURCES = ["project_argmax.cu", "project_topk.cu", "fused_step.cu", "fused_attn_step.cu", "whole_decode.cu",
                 "stem.cu", "attention_context.cu"]  # the sources of the tensor-core instances


def tile_kernel_report(build, ptxas_lines):
    """ptxas's registers, stack frame and spills of the tensor-core kernel
    instances (the two bf16 projection kernels, the bf16 stem and the
    fourteen bf16 instances of MMA_STEPS), from ``ptxas_lines``
    (build.ptxas_report of PTXAS_SOURCES), and, where the toolkit has
    cuobjdump, the tensor-core (HMMA) instructions in their SASS in the
    library; fails if one has none, if ptxas names none of them, or if one
    of NO_SPILL has a stack frame or spills."""
    import re

    labels = TILE_KERNELS + tuple(MMA_STEPS)
    reported = set()
    for line in ptxas_lines:
        label = tensor_core_kernel(line.rsplit(": ", 1)[0])
        if label:
            phase("build", "ptxas -v " + line)
            reported.add(label)
            frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if label in NO_SPILL and (not frame or any(int(b) for b in frame.groups())):
                fail("the tensor-core instance %s has a stack frame or spills: %s" % (label, line))
    if reported != set(labels):
        fail("ptxas reported no line for the tensor-core instances %s" % sorted(set(labels) - reported))
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    if not os.access(cuobjdump, os.X_OK):
        phase("build", "no cuobjdump beside nvcc: the HMMA count is not taken")
        return
    proc = subprocess.run([cuobjdump, "-sass", build.library_path()], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        phase("build", "cuobjdump -sass failed (exit %d), the HMMA count is not taken: %s"
              % (proc.returncode, proc.stderr.strip()[-300:]))
        return
    counts, current = dict.fromkeys(labels, 0), None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = tensor_core_kernel(m.group(1))
        elif current and re.search(r"\bHMMA\b", line):
            counts[current] += 1
    if not all(counts.values()):
        fail("a tensor-core kernel instance's SASS holds no tensor-core instruction: HMMA counts %s" % counts)
    phase("build", "cuobjdump -sass: HMMA instructions %s" % counts)


def beam_kernels_against_plain(rng, device):
    """Phase 3b.  Returns each beam kernel's bf16 R=192 max_abs_err (the
    largest of its outputs' against their references)."""
    import torch

    from show_tell_tpu_torch.models.attention import last_h
    from show_tell_tpu_torch.ops.fused_attn import fused_attn_dense_step_cuda, fused_attn_dense_step_plain
    from show_tell_tpu_torch.ops.fused_beam import (
        fused_dense_step_cuda,
        fused_dense_step_plain,
        fused_topk_step_cuda,
        fused_topk_step_plain,
    )
    from show_tell_tpu_torch.ops.vocab import project_topk_cuda

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = dname(dtype)
        tol = BEAM_STATE_TOL[dn]
        for R, k in BEAM_RS:
            for cell, Ec in (("gru", E), ("lstm", LE)):
                stacked, vocab, x, state = step_inputs(rng, R, dtype, device, Ec, cell)
                what = "beam %s dense step %s R=%d" % (cell, dn, R)
                logits, new_state = fused_dense_step_cuda(stacked, vocab, x, state)
                torch.cuda.synchronize()
                err = check_state(what, new_state, fused_dense_step_plain(stacked, vocab, x, state)[1], dtype, tol)
                l_err = check_logits(what, logits, last_h(new_state), vocab)
                if dtype == torch.bfloat16 and R == 192:
                    errs["fused_%s_dense_step" % cell] = max(err, l_err)
                phase("kernel", "%s: state max_abs_err %.3g (rtol atol %g); logits max_abs_err %.3g (rtol atol %g)"
                      % (what, err, tol, l_err, BEAM_TOL))
                what = "beam %s top-%d step %s R=%d" % (cell, k, dn, R)
                (logp, ids), new_state = fused_topk_step_cuda(stacked, vocab, x, state, k)
                torch.cuda.synchronize()
                err = check_state(what, new_state, fused_topk_step_plain(stacked, vocab, x, state, k)[1], dtype, tol)
                k_err, n = check_topk(what, logp, ids, last_h(new_state), vocab, k)
                if dtype == torch.bfloat16 and R == 192:
                    errs["fused_%s_topk_step" % cell] = max(err, k_err)
                phase("kernel", "%s: state max_abs_err %.3g; logp max_abs_err %.3g (rtol atol %g); ids equal on all "
                      "%d rows whose %d best logits are > %g apart, %d rows closer"
                      % (what, err, k_err, BEAM_TOL, n, k + 1, BEAM_TOL, R - n))
            for cell in ("gru", "lstm"):
                prep, w_emb, state = attn_inputs(rng, R, dtype, device, cell)
                what = "beam attention %s dense step %s R=%d" % (cell, dn, R)
                logits, new_state = fused_attn_dense_step_cuda(prep, w_emb, state)
                torch.cuda.synchronize()
                err = check_state(what, new_state, fused_attn_dense_step_plain(prep, w_emb, state)[1], dtype, tol)
                l_err = check_logits(what, logits, last_h(new_state), prep["vocab"])
                if dtype == torch.bfloat16 and R == 192:
                    errs["fused_%sdense_step" % ("attn_lstm_" if cell == "lstm" else "attn_")] = max(err, l_err)
                phase("kernel", "%s: state max_abs_err %.3g (rtol atol %g); logits max_abs_err %.3g (rtol atol %g)"
                      % (what, err, tol, l_err, BEAM_TOL))
            top = last_h(state)
            what = "project_topk k=%d %s R=%d" % (k, dn, R)
            logp, ids = project_topk_cuda(prep["vocab"], top, k)
            torch.cuda.synchronize()
            k_err, n = check_topk(what, logp, ids, top, prep["vocab"], k)
            if dtype == torch.bfloat16 and R == 192:
                errs["project_topk"] = k_err
            phase("kernel", "%s: logp max_abs_err %.3g (rtol atol %g); ids equal on all %d rows whose %d best logits "
                  "are > %g apart, %d rows closer" % (what, k_err, BEAM_TOL, n, k + 1, BEAM_TOL, R - n))

        # ties: columns 7 and 9000 equal and top in every row
        for cell, Ec in (("gru", E), ("lstm", LE)):
            stacked, vocab, x, state = step_inputs(rng, 192, dtype, device, Ec, cell)
            vocab["w"][9000] = vocab["w"][7]
            vocab["b"][7] = vocab["b"][9000] = 100.0
            (_, ids), new_state = fused_topk_step_cuda(stacked, vocab, x, state, 5)
            tie_ids = [ids, project_topk_cuda(vocab, last_h(new_state), 3)[1]]
            logits, _ = fused_dense_step_cuda(stacked, vocab, x, state)
            if not all(bool((i[:, :2] == torch.tensor([7, 9000], device=device)).all()) for i in tie_ids):
                fail("beam %s top-k / project_topk %s: tie of columns 7 and 9000 not listed as [7, 9000]" % (cell, dn))
            if not torch.equal(logits[:, 7], logits[:, 9000]) or not bool((logits.argmax(1) == 7).all()):
                fail("beam %s dense step %s: columns 7 and 9000 not tied at the top" % (cell, dn))
            phase("kernel", "beam %s top-5 step and project_topk %s: tie between columns 7 and 9000 -> [7, 9000, ...] "
                  "on all 192 rows; the dense step's logits tie there" % (cell, dn))
    return errs


def f32_dense_digests(device):
    """Phase 3b.  sha256 digests of the f32 dense steps' logits and new
    states at R = 3 and 192, from inputs of their own seed: the f32
    instances run the SIMT path, so two builds that print the same digests
    gave bit-equal outputs."""
    import hashlib

    import numpy as np
    import torch

    from show_tell_tpu_torch.ops.fused_attn import fused_attn_dense_step_cuda
    from show_tell_tpu_torch.ops.fused_beam import fused_dense_step_cuda

    rng = np.random.RandomState(SEED + 1)
    digest = lambda ts: hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in ts)).hexdigest()[:16]
    for R in (3, 192):
        for cell, Ec in (("gru", E), ("lstm", LE)):
            stacked, vocab, x, state = step_inputs(rng, R, torch.float32, device, Ec, cell)
            logits, new_state = fused_dense_step_cuda(stacked, vocab, x, state)
            states = new_state if isinstance(new_state, tuple) else (new_state,)
            phase("kernel", "beam %s dense step float32 R=%d: sha256 of the logits %s, of the new state %s"
                  % (cell, R, digest([logits]), digest(states)))
        for cell in ("gru", "lstm"):
            prep, w_emb, state = attn_inputs(rng, R, torch.float32, device, cell)
            logits, new_state = fused_attn_dense_step_cuda(prep, w_emb, state)
            states = new_state if isinstance(new_state, tuple) else (new_state,)
            phase("kernel", "beam attention %s dense step float32 R=%d: sha256 of the logits %s, of the new state %s"
                  % (cell, R, digest([logits]), digest(states)))


def simt_greedy_digests(device):
    """Phase 3.  sha256 digests of the greedy steps' tokens and new states
    that keep the SIMT code, at B = 1 and 64, from inputs of their own
    seed: every f32 instance (pooled GRU and LSTM, attention GRU and LSTM),
    so that two builds that print the same digests gave bit-equal outputs
    on those paths.  After them, the bf16 pooled GRU's (the tensor cores
    since it moved with the whole decode; its draws keep the B=64 f32
    inputs those of earlier builds)."""
    import hashlib

    import numpy as np
    import torch

    from show_tell_tpu_torch.ops.fused_attn import fused_attn_decode_step_cuda
    from show_tell_tpu_torch.ops.fused_step import fused_gru_decode_step_cuda, fused_lstm_decode_step_cuda

    rng = np.random.RandomState(SEED + 3)
    raw = lambda t: t.cpu().view(torch.uint8).numpy().tobytes()  # bf16 has no numpy type: its bytes
    digest = lambda ts: hashlib.sha256(b"".join(raw(t) for t in ts)).hexdigest()[:16]
    for B in (1, 64):
        runs = [("pooled gru", torch.float32), ("pooled lstm", torch.float32), ("attention gru", torch.float32),
                ("attention lstm", torch.float32), ("pooled gru", torch.bfloat16)]
        for family, dtype in runs:
            cell = family.split()[1]
            if family.startswith("pooled"):
                stacked, vocab, x, state = step_inputs(rng, B, dtype, device, LE if cell == "lstm" else E, cell)
                step = fused_lstm_decode_step_cuda if cell == "lstm" else fused_gru_decode_step_cuda
                tok, new_state = step(stacked, vocab, x, state)
            else:
                prep, w_emb, state = attn_inputs(rng, B, dtype, device, cell)
                tok, new_state = fused_attn_decode_step_cuda(prep, w_emb, state)
            states = new_state if isinstance(new_state, tuple) else (new_state,)
            phase("kernel", "%s greedy step %s B=%d (%s): sha256 of the tokens %s, of the new state %s"
                  % (family, dname(dtype), B, "SIMT" if dtype == torch.float32 else "tensor cores", digest([tok]),
                     digest(states)))


def u8_images(rng, shape, device):
    import torch

    return torch.from_numpy(rng.randint(0, 256, shape, dtype="uint8")).to(device)


def stem_stub(rng, device):
    """conv1 and bn1 as prepare_stem reads them: kaiming-scaled weights, BN
    statistics off the identity so that folding them is exercised."""
    import types

    import torch

    t = lambda a: torch.from_numpy(a.astype("float32")).to(device)
    return types.SimpleNamespace(
        conv1=types.SimpleNamespace(weight=t(rng.randn(64, 3, 7, 7) * (2.0 / (49 * 64)) ** 0.5)),
        bn1=types.SimpleNamespace(weight=t(rng.uniform(0.5, 1.5, 64)), bias=t(rng.uniform(-0.2, 0.2, 64)),
                                  running_mean=t(rng.uniform(-0.2, 0.2, 64)), running_var=t(rng.uniform(0.5, 1.5, 64))))


def input_kernels_against_plain(rng, device):
    """Phase 3c.  Returns the bf16 B=64 max_abs_err of the preprocess
    (stock layout) and the fused stem (s2d layout, pooled)."""
    import torch

    from show_tell_tpu_torch.ops.preprocess import preprocess_u8_cuda, preprocess_u8_plain
    from show_tell_tpu_torch.ops.s2d_stem import space_to_depth
    from show_tell_tpu_torch.ops.stem import prepare_stem, stem_fused_cuda, stem_fused_plain

    errs = {"preprocess_images": 0.0}
    side = IMG // 2
    for dtype in (torch.float32, torch.bfloat16):
        dn = dname(dtype)
        shapes = ((1, IMG, IMG, 3), (64, IMG, IMG, 3), (1, side, side, 12), (64, side, side, 12), (3, 100, 60, 3),
                  (3, 50, 30, 12))
        for shape in shapes:
            x = u8_images(rng, shape, device)
            got = preprocess_u8_cuda(x, dtype)
            torch.cuda.synchronize()
            ref = preprocess_u8_plain(x, dtype)
            if not torch.equal(got, ref):
                fail("preprocess %s %s differs from plain on %d elements, max_abs_err %g (expected bit-equal)"
                     % (dn, shape, int((got != ref).sum()), (got.float() - ref.float()).abs().max().item()))
        phase("kernel", "preprocess %s: bit-equal to the plain twin at %s" % (dn, ", ".join(str(sh) for sh in shapes)))
        prepared = prepare_stem(stem_stub(rng, device), dtype)
        tol = STEM_TOL[dn]
        for B in (1, 64):
            rgb = u8_images(rng, (B, IMG, IMG, 3), device)
            for layout, x in (("s2d", space_to_depth(rgb).contiguous()), ("rgb", rgb)):
                for pool in (True, False):
                    got = stem_fused_cuda(x, prepared, pool)
                    torch.cuda.synchronize()
                    ref = stem_fused_plain(x, prepared, pool)
                    what = "stem %s B=%d %s layout, %s" % (dn, B, layout, "pool" if pool else "no pool")
                    err = check_states(what, got, ref, dtype, tol)
                    if dtype == torch.bfloat16:
                        wide = bf16_ulp_gaps(got, ref)
                        if wide:
                            fail("%s: %d values more than one bf16 ulp from the twin" % (what, wide))
                    if dtype == torch.bfloat16 and B == 64 and layout == "rgb" and pool:  # the served input
                        errs["stem_fused"] = err
                    phase("kernel", "%s: %s max_abs_err %.3g (rtol atol %g; |plain| <= %.3g%s); %d of %d values "
                          "differ, %.6f bit-equal" % (what, tuple(got.shape), err, tol, ref.float().abs().max().item(),
                                                      ", each within one bf16 ulp" if dtype == torch.bfloat16 else "",
                                                      int((got != ref).sum()), got.numel(),
                                                      (got == ref).float().mean().item()))
    return errs


def whole_inputs(rng, B, dtype, device):
    """The greedy decode's operands at the pooled-GRU flagship widths:
    prepare_greedy's dict (an N(0, 1) embedding, as the decoder init draws
    it) and f32 features [B, E]."""
    import torch

    stacked, vocab, x, _ = step_inputs(rng, B, dtype, device)
    emb = torch.from_numpy(rng.randn(V, E).astype("float32")).to(device, dtype)
    return {"stacked": stacked, "vocab": vocab, "embedding": emb}, x.float()


def library_rnn(cell, stacked, Ed):
    """The one PyTorch call that computes a stack step: a torch.nn.GRU or
    LSTM of L layers (input Ed, hidden H), whose cells are the port's
    (PyTorch's gate order, both biases), holding the stacked weights."""
    import torch

    w_hh = stacked["w_hh"]
    rnn = (torch.nn.LSTM if cell == "lstm" else torch.nn.GRU)(Ed, H, L).to(w_hh.device, w_hh.dtype)
    with torch.no_grad():
        for l in range(L):
            getattr(rnn, "weight_ih_l%d" % l).copy_(stacked["w_ih0"] if l == 0 else stacked["w_ihU"][l - 1])
            getattr(rnn, "weight_hh_l%d" % l).copy_(w_hh[l])
            getattr(rnn, "bias_ih_l%d" % l).copy_(stacked["b_ih"][l])
            getattr(rnn, "bias_hh_l%d" % l).copy_(stacked["b_hh"][l])
    rnn.flatten_parameters()  # cuDNN's one weight buffer, where cuDNN takes the dtype
    return rnn


def plain_greedy(prepared, feats):
    """The whole decode's plain twin on the card, step by step: ids [B, T]
    and each row's smallest top-2 logit gap on its way."""
    import torch

    from show_tell_tpu_torch.models.decoder import greedy_loop
    from show_tell_tpu_torch.ops.rnn import gru_stack_plain
    from show_tell_tpu_torch.ops.vocab import first_max_argmax, project_logits

    emb = prepared["embedding"]
    gaps = []

    def step(x, hs):
        top, hs2 = gru_stack_plain(prepared["stacked"], x, hs)
        logits = project_logits(prepared["vocab"], top)
        gaps.append(top2_gap(logits))
        return first_max_argmax(logits), hs2

    hs0 = torch.zeros(L, feats.shape[0], H, dtype=emb.dtype, device=feats.device)
    ids = greedy_loop(step, emb, feats.to(emb.dtype), hs0, T)
    return ids, torch.stack(gaps, 1).min(1).values


def decode_kernels_against_plain(rng, device):
    """Phase 3d.  Returns the bf16 B=64 max_abs_err of the whole decode
    (the largest gap, in the twin's step-0 logits, between the twin's pick
    and the kernel's) and of the stack steps (their states)."""
    import torch

    from show_tell_tpu_torch.models.attention import last_h
    from show_tell_tpu_torch.ops.fused_step import arrival_counters, sm_count, stack_tiles
    from show_tell_tpu_torch.ops.rnn import (
        greedy_decode_kernel,
        gru_stack_plain,
        gru_stack_step_cuda,
        lstm_stack_plain,
        lstm_stack_step_cuda,
    )
    from show_tell_tpu_torch.ops.vocab import project_logits
    from show_tell_tpu_torch.ops.whole_decode import gru_whole_greedy_decode_cuda

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn, tol = dname(dtype), TOL[dname(dtype)]
        for B in (1, 64, 512):
            prepared, feats = whole_inputs(rng, B, dtype, device)
            ids = gru_whole_greedy_decode_cuda(prepared, feats, T)
            torch.cuda.synchronize()
            loop = greedy_decode_kernel(prepared, feats, T, whole_decode=False)
            what = "whole decode %s B=%d T=%d" % (dn, B, T)
            if not torch.equal(ids, loop):
                fail("%s: ids differ from the per-step kernel's loop on %d of %d rows"
                     % (what, int((ids != loop).any(1).sum()), B))
            ref, gaps = plain_greedy(prepared, feats)
            clear = gaps > tol[1]
            bad = int(((ids != ref).any(1) & clear).sum())
            if bad:
                fail("%s: ids differ from the plain twin's on %d rows whose top-2 gaps all exceed %g" % (what, bad, tol[1]))
            top0, _ = gru_stack_plain(prepared["stacked"], feats.to(dtype), torch.zeros(L, B, H, dtype=dtype,
                                                                                         device=device))
            logits0 = project_logits(prepared["vocab"], top0)
            rows = torch.arange(B, device=device)
            err = (logits0[rows, ref[:, 0].long()] - logits0[rows, ids[:, 0].long()]).abs().max().item()
            if dtype == torch.bfloat16 and B == 64:
                errs["gru_whole_greedy_decode"] = err
            phase("kernel", "%s: ids bit-equal to the per-step kernel's loop; equal to the plain twin's on all %d rows "
                  "whose top-2 gaps all exceed %g (%d rows closer, %d of them equal anyway); step-0 logit gap between "
                  "the picks %.3g" % (what, int(clear.sum()), tol[1], B - int(clear.sum()),
                                      int(((ids == ref).all(1) & ~clear).sum()), err))
        # ties across blocks (7, 9000) and across the first 64-row vocabulary item boundary of the tensor-core end
        for lo, hi in ((7, 9000), (63, 64)):
            prepared, feats = whole_inputs(rng, 64, dtype, device)
            prepared["vocab"]["w"][hi] = prepared["vocab"]["w"][lo]
            prepared["vocab"]["b"][lo] = prepared["vocab"]["b"][hi] = 100.0
            toks = [gru_whole_greedy_decode_cuda(prepared, feats, T), greedy_decode_kernel(prepared, feats, T,
                                                                                            whole_decode=False)]
            if not all(bool((t == lo).all()) for t in toks):
                fail("whole decode / per-step loop %s: tie of columns %d and %d not resolved to %d at every step"
                     % (dn, lo, hi, lo))
            phase("kernel", "whole decode and per-step loop %s: tie between columns %d and %d -> %d at all 25 steps "
                  "of all 64 rows in both routes" % (dn, lo, hi, lo))
        for name, cell, Ec, cuda_step, plain_step in (
                ("gru_stack_step", "gru", E, gru_stack_step_cuda, gru_stack_plain),
                ("lstm_stack_step", "lstm", LE, lstm_stack_step_cuda, lstm_stack_plain)):
            for B in (1, 64, 512):
                stacked, _, x, state = step_inputs(rng, B, dtype, device, Ec, cell)
                top, new_state = cuda_step(stacked, x, state)
                torch.cuda.synchronize()
                _, ref_state = plain_step(stacked, x, state)
                what = "%s %s B=%d E=%d" % (name, dn, B, Ec)
                err = check_state(what, new_state, ref_state, dtype)
                if not torch.equal(top, last_h(new_state)):
                    fail("%s: the top activation is not new_hs[L-1]" % what)
                if dtype == torch.bfloat16 and B == 64:
                    errs[name] = err
                split = ""
                if dtype == torch.bfloat16:  # the K split: the same bits again, its counters left at zero
                    tiles = stack_tiles(B, Ec, H, sm_count(device))
                    again = cuda_step(stacked, x, state)[1]
                    torch.cuda.synchronize()
                    pairs = zip(*(st if isinstance(st, tuple) else (st,) for st in (new_state, again)))
                    if not all(torch.equal(a, b) for a, b in pairs):
                        fail("%s: a second launch on the same inputs gave other bits" % what)
                    if int(arrival_counters(device, tiles.items).abs().sum()):
                        fail("%s: the K split's arrival counters are not back at zero" % what)
                    split = "; K split S = %d (layer 0), %d (above): a second launch bit-equal, counters at zero" % (
                        tiles.splits)
                phase("kernel", "%s: state max_abs_err %.3g (rtol atol %g); top = new_hs[L-1]%s"
                      % (what, err, tol[0], split))
    return errs


def work(name, R, k=K_BEAM, emb_rows=0):
    """(bytes, operations) that one call of kernel ``name`` at R rows must
    move and do in bf16 at the flagship widths: each input read once, each
    output written once, two operations a multiply-add.  emb_rows: the
    embedding rows a whole decode fed back (what its data needs)."""
    if name == "preprocess_images":  # u8 in, bf16 out; a multiply, a subtract and a divide an element
        n = R * IMG * IMG * 3
        return 3 * n, 3 * n
    if name == "stem_fused":  # u8 image, w (bf16) and the class table tc (f32) in, pooled bf16 out
        # conv1's 7 x 7 x 3 = 147 taps a position: the 192 of the 4 x 4 x 12 s2d form hold 45 structural zeros
        side = IMG // 2
        return (R * side * side * 12 + 2 * 192 * 64 + 4 * 4 * 4 * 64 + 2 * R * (side // 2) ** 2 * 64,
                2 * R * side * side * 64 * 147)
    cell = "lstm" if "lstm" in name else "gru"
    G = GATES[cell] * H
    attn = name.startswith("fused_attn")
    I0 = 2 * AE if attn else (LE if cell == "lstm" else E)
    vocab_el, vocab_ops = V * H + V, 2 * R * V * H
    if name == "attention_context":  # feats, att1, h, wdec, bdec, wfull -> ctx, alpha (f32)
        return (2 * (R * AP * (AC + AA) + R * H + AA * H + 2 * AA + R * AC) + 4 * R * AP,
                2 * R * (AA * H + AP * AA + AP * AC))
    end_bytes = 8 * R * k if "topk" in name else 4 * R * V if "dense" in name else 4 * R  # logp + ids, logits, tok
    if name.startswith("project_"):
        return 2 * (R * H + vocab_el) + end_bytes, vocab_ops
    stack_el = G * I0 + (2 * L - 1) * G * H + 2 * L * G  # w_ih0, w_ihU and w_hh, the biases
    state_el = 2 * (2 if cell == "lstm" else 1) * L * R * H  # hs (and cs), in and out
    rec_ops = 2 * R * (G * I0 + (2 * L - 1) * G * H)
    if name.endswith("stack_step"):  # x, the weights, the state in and out
        return 2 * (R * I0 + stack_el + state_el), rec_ops
    if name == "gru_whole_greedy_decode":  # features, weights, projection, the rows fed back; T tokens a row out
        return 2 * (R * I0 + stack_el + vocab_el + emb_rows * I0) + 4 * R * T, T * (rec_ops + vocab_ops)
    x_el = R * AE + R * AP * (AE + AA) + AA * H + 2 * AA + AE if attn else R * I0  # w_emb, feats_e, att1, ... or x
    ops = rec_ops + vocab_ops
    if attn:
        ops += 2 * R * (AA * H + AP * AA + AP * AE)  # att2, the scores, the context
    return 2 * (stack_el + state_el + vocab_el + x_el) + end_bytes, ops


def bound(name, R, emb_rows=0):
    """(least ms the card could take for one call, what bounds it)."""
    nbytes, ops = work(name, R, emb_rows=emb_rows)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def ab_rounds(decodes):
    """Host-clock ms a call of each of two routes ({route: fn}, each call
    ending on the host), after one warm-up call each: AB_ROUNDS rounds of
    AB_REPS calls a route, the routes in turns (every other round in the
    reverse order)."""
    import torch

    for fn in decodes.values():
        fn()
    routes = list(decodes)
    ms = {route: [] for route in routes}
    for rnd in range(AB_ROUNDS):
        for route in (routes if rnd % 2 == 0 else routes[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(AB_REPS):
                decodes[route]()
            torch.cuda.synchronize()
            ms[route].append(1e3 * (time.perf_counter() - t0) / AB_REPS)
    return ms


def ab_verdict(ms, labels, calls="decodes"):
    """The winner of two routes' rounds (ab_rounds, event_rounds), or None,
    and a line that reports them: a route wins when it is faster in at
    least nine tenths of the rounds and the medians differ by more than the
    larger interquartile range.  labels: {route: what it is}; calls: what
    a timed call is."""
    a, b = list(ms)
    (a1, _, a3), (b1, _, b3) = statistics.quantiles(ms[a], n=4), statistics.quantiles(ms[b], n=4)
    spread, gap = max(a3 - a1, b3 - b1), statistics.median(ms[b]) - statistics.median(ms[a])
    a_won = sum(x < y for x, y in zip(ms[a], ms[b]))
    b_won = sum(y < x for x, y in zip(ms[a], ms[b]))
    need = 0.9 * AB_ROUNDS
    winner = a if a_won >= need and gap > spread else b if b_won >= need and -gap > spread else None
    text = ("median [quartiles] (min, max) of %d rounds of %d %s in turns: %s %.4f ms [%.4f, %.4f] (%.4f, %.4f), "
            "%s %.4f ms [%.4f, %.4f] (%.4f, %.4f); %s / %s %.3f; medians %.4f ms apart, spread (larger interquartile "
            "range) %.4f ms; %s faster in %d of %d rounds, %s in %d: %s; rounds (ms a call) %s %s, %s %s"
            % (AB_ROUNDS, AB_REPS, calls, labels[a], statistics.median(ms[a]), a1, a3, min(ms[a]), max(ms[a]), labels[b],
               statistics.median(ms[b]), b1, b3, min(ms[b]), max(ms[b]), b, a,
               statistics.median(ms[b]) / statistics.median(ms[a]), gap, spread, a, a_won, AB_ROUNDS, b, b_won,
               "the %s route wins" % winner if winner else "no winner", a, " ".join("%.4f" % x for x in ms[a]), b,
               " ".join("%.4f" % x for x in ms[b])))
    return winner, text


def serve(cap, requests, counter_fns, launches_each, beam_size=0):
    """One warm-up request, then ``requests`` timed on the host clock with
    every kernel count set to 0 just before; returns (ids, seconds, counts).
    Every count not in launches_each must stay 0."""
    import torch

    cap.caption_ids(requests[0], beam_size)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    for fn in counter_fns:
        fn.launches = 0
    t0 = time.perf_counter()
    served = [cap.caption_ids(imgs, beam_size) for imgs in requests]
    seconds = time.perf_counter() - t0
    counts = read_counts(counter_fns, launches_each)
    return served, seconds, counts


def read_counts(counter_fns, launches_each):
    """Every kernel's launch count; fails unless each named one is as
    expected and the others are 0."""
    counts = {fn.__name__: fn.launches for fn in counter_fns}
    for name, got in counts.items():
        if got != launches_each.get(name, 0):
            fail("main path launched %s %d times, expected %d (counts %s)"
                 % (name, got, launches_each.get(name, 0), counts))
    return counts


def request_share(label, i, ids, rows, ref_ids):
    """Fails unless a request's ids are [rows, T] in [0, V) and equal
    ``ref_ids`` on at least 0.95 of positions; returns that share."""
    if ids.shape != (rows, T) or ids.min() < 0 or ids.max() >= V:
        fail("%s request %d: ids of shape %s in [%d, %d]" % (label, i, ids.shape, ids.min(), ids.max()))
    share = float((ids == ref_ids).mean())
    if share < 0.95:
        fail("%s request %d: ids equal the plain step's decode on %.4f of positions (< 0.95)" % (label, i, share))
    return share


def check_served(label, served, requests, cap, reference=plain_decode):
    """Returns the smallest share of positions equal to ``reference``'s decode (by default the plain twin's)."""
    shares = []
    for i, (ids, imgs) in enumerate(zip(served, requests)):
        share = request_share(label, i, ids, len(imgs), reference(cap, imgs)[0])
        phase("main", "%s bf16 request %d: [64,25] ids, equal to the plain step's decode on %.4f of positions"
              % (label, i, share))
        shares.append(share)
    return min(shares)


def check_f32(label, cap32, imgs, counter, reference=plain_decode, beam_size=0, expected=None):
    """One f32 request against ``reference``'s decode of its features (by default the plain twin's).  Greedy:
    ``counter`` launched T times and every row equal; beam: the counts in
    ``expected`` and at least 7 of 8 rows equal."""
    counters = list(expected) if expected else [counter]
    for fn in counters:
        fn.launches = 0
    ids32 = cap32.caption_ids(imgs, beam_size)
    for fn in counters:
        want = expected[fn] if expected else T
        if fn.launches != want:
            fail("%s f32 request launched %s %d times, expected %d" % (label, fn.__name__, fn.launches, want))
    ref32, gaps32 = reference(cap32, imgs)
    same = (ids32 == ref32).all(axis=1)
    gap = "score gap (K-th to (K+1)-th candidate, best to second final beam)" if beam_size else "top-2 gap"
    for r in [int(i) for i in range(len(same)) if not same[i]]:
        phase("main", "%s f32 row %d differs from the plain decode at %d of %d positions; its smallest %s is %.3g"
              % (label, r, int((ids32[r] != ref32[r]).sum()), T, gap, gaps32[r]))
    need = 7 / 8 if beam_size else 0.99
    if same.mean() < need:
        fail("%s f32 B=%d: %d rows equal the plain decode (< %.3f)" % (label, len(same), int(same.sum()), need))
    phase("main", "%s f32 B=%d (TF32 off): %d of %d rows equal the plain step's decode"
          % (label, len(same), int(same.sum()), len(same)))
    return ids32


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "show_tell_tpu_torch", "csrc")):
        fail("show_tell_tpu_torch/ is not beside chip_smoke.py; run it from a checkout of the repo")
    sys.path.insert(0, here)
    import numpy as np
    import torch

    marks = [("1-2 device, build", time.perf_counter())]
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
    # the grid-barrier probe (phase 6) builds beside the library, started first so the two compile together
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    probe_so = os.path.join(build.BUILD_DIR, "libgrid_barrier_probe.%d.so" % os.getpid())
    probe_cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-I", here,
                 os.path.join(here, "grid_barrier_probe.cu"), "-o", probe_so]
    probe_proc = subprocess.Popen(probe_cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    # ptxas's report compiles the tensor-core sources once more with -v, alongside the library's own nvcc processes
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        ptxas = pool.submit(build.ptxas_report, PTXAS_SOURCES)
        build.load_library()
        ptxas_lines = ptxas.result()
    probe_err = probe_proc.communicate()[1]
    if probe_proc.returncode != 0:
        fail("nvcc failed on grid_barrier_probe.cu (exit %d): %s" % (probe_proc.returncode, probe_err))
    probe = ctypes.CDLL(probe_so)
    os.remove(probe_so)  # loaded; nothing else reads it
    probe.st_grid_barriers.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    probe.st_grid_barriers.restype = ctypes.c_int
    phase("build", "%s, the grid-barrier probe and ptxas's report in %.2f s (%s)"
          % (os.path.basename(build.library_path()), time.perf_counter() - t0,
             "library already built" if cached else "nvcc ran, one process per source"))
    tile_kernel_report(build, ptxas_lines)

    marks.append(("3 kernels", time.perf_counter()))
    # 3. kernel against plain.  cuDNN's TF32 flag stays at its default: the
    # port scopes it off for f32 encodes, and plain_features() for its own.
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(SEED)
    errs = kernels_against_plain(rng, device)
    errs.update(beam_kernels_against_plain(rng, device))
    f32_dense_digests(device)
    simt_greedy_digests(device)
    errs.update(input_kernels_against_plain(rng, device))
    errs.update(decode_kernels_against_plain(rng, device))
    projection_tile_ties(rng, device)

    import torch.nn.functional as F

    from show_tell_tpu_torch.data.transforms import preprocess_images
    from show_tell_tpu_torch.native import fastimage
    from show_tell_tpu_torch.decode.beam import attn_beam_search_decode, beam_engine, beam_search_decode, rnn_state_helpers
    from show_tell_tpu_torch.models.attention import init_hidden, last_h, linear_f32, start_embeddings
    from show_tell_tpu_torch.models.captioner import (
        CaptionerConfig,
        captioner_greedy_decode,
        encode,
        init_captioner,
        prepare_decode,
    )
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
        fused_attn_dense_step,
        fused_attn_dense_step_cuda,
        fused_attn_dense_step_plain,
        fused_attn_lstm_decode_step,
        fused_attn_lstm_dense_step,
        prepare_attn_decode,
    )
    from show_tell_tpu_torch.ops.fused_beam import (
        fused_dense_step_cuda,
        fused_dense_step_plain,
        fused_gru_dense_step,
        fused_gru_topk_step,
        fused_lstm_dense_step,
        fused_lstm_topk_step,
        fused_topk_step_cuda,
        fused_topk_step_plain,
    )
    from show_tell_tpu_torch.ops.fused_step import (
        MAX_SPLITS,
        fused_gru_decode_step,
        fused_gru_decode_step_cuda,
        fused_gru_decode_step_plain,
        fused_lstm_decode_step,
        fused_lstm_decode_step_cuda,
        fused_lstm_decode_step_plain,
        sm_count,
        stack_tiles,
    )
    from show_tell_tpu_torch.ops.preprocess import preprocess_u8, preprocess_u8_cuda, preprocess_u8_plain
    from show_tell_tpu_torch.models.serving import FoldedEncoder
    from show_tell_tpu_torch.ops import (
        beam_step_default,
        dtype_code,
        fold_bn_default,
        raise_on_error,
        stream_arg,
        whole_decode_default,
    )
    from show_tell_tpu_torch.ops.rnn import (
        greedy_decode_kernel,
        gru_stack_plain,
        gru_stack_step,
        gru_stack_step_cuda,
        lstm_stack_plain,
        lstm_stack_step,
        lstm_stack_step_cuda,
        stack_plain,
    )
    from show_tell_tpu_torch.ops.whole_decode import (
        gru_whole_greedy_decode,
        gru_whole_greedy_decode_cuda,
        gru_whole_greedy_decode_plain,
    )
    from show_tell_tpu_torch.ops.s2d_stem import S2D_PAD, space_to_depth, transform_conv1_weight
    from show_tell_tpu_torch.ops.stem import stem_fused, stem_fused_cuda, stem_fused_plain
    from show_tell_tpu_torch.ops.vocab import (
        project_argmax,
        project_argmax_cuda,
        project_argmax_plain,
        project_logits,
        project_topk,
        project_topk_cuda,
        project_topk_plain,
    )
    from show_tell_tpu_torch.serve import Captioner

    counters = kernel_counters()
    vocab = SyntheticVocab(V)
    img_rng = np.random.RandomState(SEED + 1)
    whole_default = whole_decode_default()
    beam_default = beam_step_default()

    def greedy_launches(counter, requests):
        """{kernel counter: launches} of ``requests`` greedy requests of a
        family whose per-step kernel counts in ``counter``: the pooled GRU
        takes the whole-decode kernel, once a request, where
        whole_decode_default() says so; else T steps a request."""
        if counter is fused_gru_decode_step and whole_default:
            return {gru_whole_greedy_decode: requests}
        return {counter: requests * T}

    def by_name(expected):
        return {fn.__name__: n for fn, n in expected.items()}

    def tf32_check(label, cap32, imgs):
        """An f32 Captioner's encode, with cuDNN's TF32 flag at its default,
        against encodes with TF32 scoped off and on: equal to the first
        within 1e-5 of the largest feature, farther than that from the
        second; the global flag unchanged."""
        if not torch.backends.cudnn.allow_tf32:
            fail("torch.backends.cudnn.allow_tf32 is not at its default (True)")
        x = torch.from_numpy(imgs).to(device)
        with torch.inference_mode():
            served = encode(cap32.model, x)
            if not torch.backends.cudnn.allow_tf32:
                fail("%s f32 encode left torch.backends.cudnn.allow_tf32 off" % label)
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                exact = cap32.model.encoder.encode_u8(x)
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
                tf32 = cap32.model.encoder.encode_u8(x)
        scale = exact.abs().max().item()
        e_exact, e_tf32 = ((served - exact).abs().max().item(), (served - tf32).abs().max().item())
        if e_exact > 1e-5 * scale or e_tf32 <= 1e-5 * scale:
            fail("%s f32 encode: max_abs_err %g against TF32 off, %g against TF32 on (|features| <= %g; expected "
                 "<= 1e-5 and > 1e-5 of it)" % (label, e_exact, e_tf32, scale))
        phase("main", "%s f32 encode B=%d, cudnn.allow_tf32 at its default (True) before and after: max_abs_err %.3g "
              "against an encode with TF32 off, %.3g against one in TF32 (|features| <= %.4g; limit 1e-5 of it)"
              % (label, len(imgs), e_exact, e_tf32, scale))

    def check_plain_preprocess(label, cap, imgs, ids):
        """The stock path's greedy ids against the same kernels fed the
        plain twin's preprocess: the preprocess kernel is bit-equal to its
        twin, so every row must be equal."""
        with torch.inference_mode():
            x = preprocess_images(torch.from_numpy(imgs).to(device), augment=False, dtype=cap.dtype)
            ref = captioner_greedy_decode(cap.model, cap.cfg, x, cap.prepared).cpu().numpy()
        rows = int((ref == ids).all(axis=1).sum())
        if rows != len(ids):
            fail("%s %s B=%d: served ids equal the plain-preprocess decode on %d of %d rows"
                 % (label, dname(cap.dtype), len(ids), rows, len(ids)))
        phase("main", "%s %s B=%d: served ids equal the plain-preprocess decode on all %d rows"
              % (label, dname(cap.dtype), len(ids), len(ids)))

    def s2d_against_twin(label, scap, served, requests):
        """The bf16 s2d requests against the stem's twin.  For each request:
        the stem as served (Encoder.stem_u8) within one bf16 ulp of its twin
        at every value; the plain decode (ResNet, head and step) of the
        served stem's output against that of the twin's, on at least the
        share of equal positions that the smallest of S2D_CONTROLS controls
        reaches over the three requests, each control the twin's output
        with as many values as the served stem changed moved one bf16 ulp
        at seeded random places (a random-weight ResNet-101 carries one-ulp
        differences into many tokens: tools/s2d_sensitivity.py); the served
        ids against the plain decode of the served stem's output at 0.95,
        as check_served.  Also prints the served ids against the twin's
        decode.  Returns the smallest of the last shares."""
        enc = scap.model.encoder
        ops = enc.stem_operands()
        rows = []
        for i, imgs in enumerate(requests):
            x = torch.from_numpy(imgs).to(device)
            with torch.inference_mode():
                y_served = enc.stem_u8(x, s2d=True).permute(0, 2, 3, 1)
                y_twin = stem_fused_plain(x, ops)
            wide, n = bf16_ulp_gaps(y_served, y_twin), int((y_served != y_twin).sum())
            if wide:
                fail("%s s2d request %d: the served stem has %d values more than one bf16 ulp from its twin"
                     % (label, i, wide))
            twin_ids = plain_decode(scap, imgs)[0]
            own_ids = plain_decode(scap, imgs, stem=lambda *_: y_served)[0]
            controls = [float((plain_decode(scap, imgs, stem=lambda *_: ulp_nudges(y_twin, n, k))[0] == twin_ids)
                              .mean()) for k in range(S2D_CONTROLS)]
            own = float((own_ids == twin_ids).mean())
            down = request_share(label + " s2d", i, served[i], len(imgs), own_ids)
            phase("main", "%s s2d bf16 request %d: the served stem within one bf16 ulp of its twin (%d of %d values "
                  "differ); plain decode from the served stem against that from the twin on %.4f of positions, "
                  "controls with %d one-ulp moves %s; served [64,25] ids equal to the plain decode from the served "
                  "stem on %.4f of positions, to that from the twin on %.4f"
                  % (label, i, n, y_twin.numel(), own, n, " ".join("%.4f" % c for c in controls), down,
                     float((served[i] == twin_ids).mean())))
            rows.append((own, min(controls), down))
        bar = min(r[1] for r in rows)
        for i, (own, _, _) in enumerate(rows):
            if own < bar:
                fail("%s s2d request %d: the plain decode from the served stem equals that from its twin on %.4f of "
                     "positions, below every one-ulp control's %.4f" % (label, i, own, bar))
        phase("main", "%s s2d: on every request the decode from the served stem agrees with the twin's at least as "
              "well as the weakest one-ulp control (%.4f)" % (label, bar))
        return min(r[2] for r in rows)

    def s2d_path(label, params, bn_state, cfg, requests, counter, f32_request=False):
        """The s2d Captioner of the same weights serves the same pixels:
        three bf16 requests with the counts read around them (the stem
        once a request, the decode as on the stock path), held to the
        stem's twin by s2d_against_twin; optionally one f32 request of 8,
        every row equal to the stem's twin + the plain decode."""
        scap = Captioner(params, bn_state, cfg, vocab, "bfloat16", device="gpu", s2d=True)
        served, seconds, counts = serve(scap, requests, counters, dict(by_name(greedy_launches(counter, 3)),
                                                                        stem_fused=3))
        share = s2d_against_twin(label, scap, served, requests)
        phase("main", "%s s2d: launches in the three requests %s (stem = 3 x 1)"
              % (label, {k: v for k, v in counts.items() if v}))
        show_captions(label + " s2d", served)
        if f32_request:
            scap32 = Captioner(params, bn_state, cfg, vocab, "float32", device="gpu", s2d=True)
            imgs32 = img_rng.randint(0, 256, (8, IMG, IMG, 3), dtype=np.uint8)
            check_f32(label + " s2d", scap32, imgs32, None,
                      expected={**greedy_launches(counter, 1), stem_fused: 1})
        return {"seconds": seconds, "counts": counts, "share": share, "cap": scap}

    def plain_beam(logp0, state1, step, Bq):
        """beam_engine over plain steps; returns ids and each image's
        smallest score gap at a choice (beam_engine's ``gaps``)."""
        tile, gather = rnn_state_helpers(Bq, K_BEAM)
        gaps = []
        ids = beam_engine(logp0, state1, step, tile, gather, K_BEAM, T, END, PAD, gaps=gaps)
        return ids.cpu().numpy(), torch.stack(gaps, 1).min(1).values.cpu().numpy()

    def route_decodes(label, served_ids, decodes):
        """Each (route, launches expected, decode(), controls) on the same
        features: counts zeroed just before, read just after; ids against
        the served route's on at least 0.95 of positions, or, where the
        route has ``controls()`` (the shares of positions equal to the
        served ids that controls of its rounding reach), on at least the
        weakest control's share where that is lower.  Returns {route: counts}."""
        out = {}
        for route, expected, decode, controls in decodes:
            for fn in counters:
                fn.launches = 0
            with torch.inference_mode():
                ids = decode().cpu().numpy()
            out[route] = read_counts(counters, expected)
            share = float((ids == served_ids).mean())
            shares = controls() if controls else []
            bar = min([0.95] + shares)
            if share < bar:
                fail("%s beam %s decode: ids equal the served route's on %.4f of positions (< %.4f: 0.95 or the "
                     "weakest control, %s)" % (label, route, share, bar, " ".join("%.4f" % c for c in shares)))
            phase("main", "%s beam %s bf16 B=64 K=%d: launches %s; ids equal the served route's on %.4f of positions "
                  "(bar %.4f%s)" % (label, route, K_BEAM, {k: v for k, v in out[route].items() if v}, share, bar,
                                    "; controls %s" % " ".join("%.4f" % c for c in shares) if shares else ""))
        return out

    def composite_controls(cap, dcfg, feats, start_token, dense, served_ids, label):
        """The controls of the attention beam's sparse composite route
        against the served (fused dense step) route, ROUTE_CONTROLS of them:
        the served route's beam decode of ``feats`` again, with the
        composite route's step (the context kernel, embed and the plain
        stack) also run on each step's input, and the served step's new
        state then moved, at seeded random places, by as many values and
        as many bf16 ulps as the composite's differs from it.  So each
        control carries the composite's rounding, placed at random, into
        the served route.  A composite step must have at least
        ROUTE_STATE_SHARE of its new state's values within the bf16 state
        tolerance of the served step's (a faulty step parts on most values;
        on random weights the state reaches |h| ~ 1e4-1e5, and where a
        gate's input lies near its switch, rounding alone moves a value by
        as much as itself).  Returns the shares of positions equal to
        ``served_ids``."""
        dec, weights = cap.model.decoder, cap.prepared
        emb = dec.embeddings.weight
        feats_pm = feats.transpose(1, 2).contiguous()
        att1 = precompute_att1(dec.attn, feats_pm).to(emb.dtype).contiguous()
        stack = stack_plain(dcfg.cell_type)

        def trunk(w_emb, f, a1, state):
            ctx, _ = attention_context(weights, f, a1, last_h(state))
            return stack(weights["stacked"], torch.cat([w_emb, linear_f32(dec.embed, ctx).to(w_emb.dtype)], -1), state)

        with torch.inference_mode():
            top0, state1 = trunk(start_embeddings(dec, len(feats), start_token, device), feats_pm, att1,
                                 init_hidden(dec, dcfg, feats))
            logp0 = torch.log_softmax(project_logits(weights["vocab"], top0), dim=-1)
            prep = prepare_attn_decode(weights, dec, feats_pm)
            rows = dict(prep, feats_e=prep["feats_e"].repeat_interleave(K_BEAM, dim=0),
                        att1=prep["att1"].repeat_interleave(K_BEAM, dim=0))
            f_rows, a_rows = feats_pm.repeat_interleave(K_BEAM, dim=0), att1.repeat_interleave(K_BEAM, dim=0)
            tile, gather = rnn_state_helpers(len(feats), K_BEAM)
            tol = TOL["bfloat16"][0]
            shares, moved, close, err = [], [], [], 0.0
            for seed in range(ROUTE_CONTROLS):
                calls = [0]

                def step(tokens, state):
                    nonlocal err
                    w = emb.index_select(0, tokens)
                    _, comp = trunk(w, f_rows, a_rows, state)
                    logits, state2 = dense(rows, w, state)
                    parts, out = (state2, comp) if isinstance(state2, tuple) else ((state2,), (comp,)), []
                    for i, (got, ref) in enumerate(zip(*parts)):
                        err = max(err, (got.float() - ref.float()).abs().max().item())
                        close.append(torch.isclose(ref.float(), got.float(), rtol=tol, atol=tol).float().mean().item())
                        ulps = ulp_distances(ref, got)
                        moved.append(len(ulps))
                        out.append(ulp_nudges(got, 0, 1000 * seed + 2 * calls[0] + i, ulps))
                    calls[0] += 1
                    return torch.log_softmax(logits, dim=-1), tuple(out) if isinstance(state2, tuple) else out[0]

                ids = beam_engine(logp0, state1, step, tile, gather, K_BEAM, T, END, PAD)
                shares.append(float((ids.cpu().numpy() == served_ids).mean()))
        if min(close) < ROUTE_STATE_SHARE:
            fail("%s beam: a composite step's new state has %.4f of its values within the bf16 tolerance (rtol = atol "
                 "= %g) of the served step's on the same input (< %g)" % (label, min(close), tol, ROUTE_STATE_SHARE))
        phase("main", "%s beam sparse composite controls: on each step's input the composite step's new state has "
              "%.5f-%.5f of its values within rtol = atol = %g of the served step's (bar %g; largest gap %.4g), "
              "%d-%d values apart a step; the served route with those moves at random places: ids equal the "
              "served ids on %s of positions"
              % (label, min(close), max(close), tol, ROUTE_STATE_SHARE, err, min(moved), max(moved),
                 " ".join("%.4f" % c for c in shares)))
        return shares

    def encoder_route(label, cap):
        """The serving default's encoder route: the folded one where ops.fold_bn_default() says so."""
        want = fold_bn_default()
        if cap.fold_bn != want or isinstance(cap.model.encoder, FoldedEncoder) != want:
            fail("%s: the Captioner's fold_bn is %s, its encoder a %s; fold_bn_default() is %s"
                 % (label, cap.fold_bn, type(cap.model.encoder).__name__, want))
        phase("main", "%s: the Captioner's default encoder route on the card is %s (ops.fold_bn_default() = %s)"
              % (label, type(cap.model.encoder).__name__, want))

    def show_captions(label, served):
        for row in served[0][:3]:
            phase("main", "%s caption: %s ..." % (label, " ".join(vocab.index_to_word[int(t)] for t in row[:8])))

    def pooled_slice(variant, Ed, counter):
        """Phase 4 for one pooled family; returns (launches, seconds of the three requests)."""
        cfg = CaptionerConfig(variant, 101, Ed, H, V, L)
        params, bn_state = init_captioner(cfg, torch.Generator().manual_seed(SEED))
        cap = Captioner(params, bn_state, cfg, vocab, "bfloat16", device="gpu")
        encoder_route(variant, cap)
        requests = [img_rng.randint(0, 256, (64, 224, 224, 3), dtype=np.uint8) for _ in range(3)]
        served, seconds, counts = serve(cap, requests, counters,
                                        dict(by_name(greedy_launches(counter, 3)), preprocess_u8=3))
        check_served(variant, served, requests, cap)
        phase("main", "%s: launches in the three requests %s (greedy decode %s, preprocess = 3 x 1)"
              % (variant, {k: v for k, v in counts.items() if v}, by_name(greedy_launches(counter, 3))))
        show_captions(variant, served)
        check_plain_preprocess(variant, cap, requests[0], served[0])
        other = {}  # the greedy routes that serving does not take, on the same weights
        if cfg.cell_type == "gru":  # the three requests' features by the other of the whole decode and the loop
            with torch.inference_mode():
                feats3 = [plain_features(cap, imgs) for imgs in requests]
                for fn in counters:
                    fn.launches = 0
                ids3 = [greedy_decode_kernel(cap.prepared, f, T, whole_decode=not whole_default).cpu().numpy()
                        for f in feats3]
            other["whole"] = read_counts(counters, by_name(
                {gru_whole_greedy_decode: 3} if not whole_default else {fused_gru_decode_step: 3 * T}))
            rows = sum(int((a == b).all(axis=1).sum()) for a, b in zip(ids3, served))
            if rows != 3 * 64:
                fail("gru: the %s route's ids equal the served ids on %d of %d rows"
                     % ("per-step" if whole_default else "whole-decode", rows, 3 * 64))
            phase("main", "gru bf16 B=64: the three requests' features through greedy_decode_kernel(whole_decode=%s): "
                  "launches %s; ids equal the served ids on all %d rows"
                  % (not whole_default, {k: v for k, v in other["whole"].items() if v}, rows))
        stack_step = lstm_stack_step if cfg.cell_type == "lstm" else gru_stack_step
        for fn in counters:
            fn.launches = 0
        with torch.inference_mode():
            sharded = captioner_greedy_decode(cap.model, cfg, torch.from_numpy(requests[0]).to(device), cap.prepared,
                                              vocab_sharded=True).cpu().numpy()
        other["sharded"] = read_counts(counters, {stack_step.__name__: T, "preprocess_u8": 1})
        ref_ids, _ = plain_decode(cap, requests[0])
        share, share_served = float((sharded == ref_ids).mean()), float((sharded == served[0]).mean())
        if share < 0.95:
            fail("%s sharded-projection request: ids equal the plain decode on %.4f of positions (< 0.95)"
                 % (variant, share))
        phase("main", "%s bf16 B=64 through captioner_greedy_decode(vocab_sharded=True): launches %s; ids equal the "
              "plain decode on %.4f of positions, the served (fused-step) ids on %.4f"
              % (variant, {k: v for k, v in other["sharded"].items() if v}, share, share_served))
        cap32 = Captioner(params, bn_state, cfg, vocab, "float32", device="gpu")
        imgs32 = img_rng.randint(0, 256, (8, 224, 224, 3), dtype=np.uint8)
        if cfg.cell_type == "gru":
            tf32_check(variant, cap32, imgs32)
        check_plain_preprocess(variant, cap32, imgs32, check_f32(variant, cap32, imgs32, None,
                                                                 expected=greedy_launches(counter, 1)))

        # beam, width 3: the step route beam_step_default() names, this cell's instance, 24 launches a request
        dense = fused_lstm_dense_step if cfg.cell_type == "lstm" else fused_gru_dense_step
        topk = fused_lstm_topk_step if cfg.cell_type == "lstm" else fused_gru_topk_step
        served_step, other_step = (topk, dense) if beam_default == "topk" else (dense, topk)

        def pooled_beam_plain(cap, images_u8):
            """The same features, beam-decoded with the plain twins as steps on the card."""
            with torch.inference_mode():
                feats = plain_features(cap, images_u8)
                prep = cap.prepared
                state0 = init_state(cfg.cell_type, L, len(images_u8), H, cap.dtype, device)
                top, state1 = stack_plain(cfg.cell_type)(prep["stacked"], feats.to(cap.dtype), state0)

                def step(tokens, state):
                    x = prep["embedding"].index_select(0, tokens)
                    logits, state2 = fused_dense_step_plain(prep["stacked"], prep["vocab"], x, state)
                    return torch.log_softmax(logits, dim=-1), state2

                return plain_beam(torch.log_softmax(project_logits(prep["vocab"], top), dim=-1), state1, step,
                                  len(images_u8))

        beam_served, beam_s, beam_counts = serve(cap, requests, counters,
                                                 {served_step.__name__: 3 * (T - 1), "preprocess_u8": 3}, K_BEAM)
        beam_share = check_served(variant + " beam", beam_served, requests, cap, pooled_beam_plain)
        phase("main", "%s beam (the %s route, beam_step_default()): launches in the three requests %s (beam step = "
              "3 x 24)" % (variant, beam_default, {k: v for k, v in beam_counts.items() if v}))
        show_captions(variant + " beam", beam_served)
        check_f32(variant + " beam", cap32, img_rng.randint(0, 256, (8, 224, 224, 3), dtype=np.uint8), served_step,
                  pooled_beam_plain, K_BEAM, {served_step: T - 1})
        with torch.inference_mode():
            feats = plain_features(cap, requests[0])
        dcfg = cfg.decoder_config()
        other_route = "dense" if beam_default == "topk" else "topk"
        routes = route_decodes(variant, beam_served[0], [
            (other_route, {other_step.__name__: T - 1},
             lambda: beam_search_decode(cap.prepared, dcfg, feats, K_BEAM, END, PAD, fused_step=other_route), None),
            ("sparse composite", {"project_topk": T - 1},
             lambda: beam_search_decode(cap.prepared, dcfg, feats, K_BEAM, END, PAD, fused_step=None, sparse=True),
             None),
        ])
        s2d = s2d_path(variant, params, bn_state, cfg, requests, counter, f32_request=variant == "gru")
        return {"seconds": seconds, "beam_seconds": beam_s, "counts": counts, "other": other,
                "beam_counts": beam_counts, "routes": routes, "beam_share": beam_share, "cap": cap, "feats": feats,
                "requests": requests, "s2d": s2d, "params": (params, bn_state)}

    def attention_slice(variant, counter):
        """Phase 5 for one attention family; returns (launches, seconds of the
        three requests, the composite decode's launch counts)."""
        acfg = CaptionerConfig(variant, 101, AE, H, V, L, nos_filters=AC, attn_dim=AA)
        dcfg = acfg.decoder_config()
        params, bn_state = init_captioner(acfg, torch.Generator().manual_seed(SEED))

        acap = Captioner(params, bn_state, acfg, vocab, "bfloat16", device="gpu")
        encoder_route(variant, acap)
        requests = [img_rng.randint(0, 256, (64, 224, 224, 3), dtype=np.uint8) for _ in range(3)]
        served, seconds, counts = serve(acap, requests, counters, {counter.__name__: 3 * T, "preprocess_u8": 3})
        check_served(variant, served, requests, acap)
        phase("main", "%s: launches in the three requests %s (fused attention step = 3 x 25, preprocess = 3 x 1)"
              % (variant, {k: v for k, v in counts.items() if v}))
        show_captions(variant, served)
        check_plain_preprocess(variant, acap, requests[0], served[0])

        # the composite path, called directly: the flagship (H <= 2E) takes the fused step
        with torch.inference_mode():
            feats = plain_features(acap, requests[0])
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
        imgs32 = img_rng.randint(0, 256, (8, 224, 224, 3), dtype=np.uint8)
        check_plain_preprocess(variant, acap32, imgs32, check_f32(variant, acap32, imgs32, counter))

        # beam, width 3: the dense attention step's instance, 24 launches and one context launch a request
        dense = fused_attn_lstm_dense_step if dcfg.cell_type == "lstm" else fused_attn_dense_step

        def attn_beam_plain(cap, images_u8):
            """The same features, beam-decoded with the plain twins (the context's at step 0) on the card."""
            with torch.inference_mode():
                feats = plain_features(cap, images_u8)
                dec, weights = cap.model.decoder, cap.prepared
                prep = prepare_attn_decode(weights, dec, feats.transpose(1, 2).contiguous())
                state0 = init_hidden(dec, dcfg, feats)
                ctx, _ = attention_context_plain(weights, feats.transpose(1, 2).contiguous(), prep["att1"],
                                                 last_h(state0))
                w0 = start_embeddings(dec, len(images_u8), acfg.start_token, device)
                x = torch.cat([w0, linear_f32(dec.embed, ctx).to(w0.dtype)], dim=-1)
                top, state1 = stack_plain(dcfg.cell_type)(weights["stacked"], x, state0)
                rows = dict(prep, feats_e=prep["feats_e"].repeat_interleave(K_BEAM, dim=0),
                            att1=prep["att1"].repeat_interleave(K_BEAM, dim=0))

                def step(tokens, state):
                    logits, state2 = fused_attn_dense_step_plain(rows, dec.embeddings.weight.index_select(0, tokens),
                                                                 state)
                    return torch.log_softmax(logits, dim=-1), state2

                return plain_beam(torch.log_softmax(project_logits(weights["vocab"], top), dim=-1), state1, step,
                                  len(images_u8))

        beam_served, beam_s, beam_counts = serve(
            acap, requests, counters, {dense.__name__: 3 * (T - 1), "attention_context": 3, "preprocess_u8": 3}, K_BEAM)
        beam_share = check_served(variant + " beam", beam_served, requests, acap, attn_beam_plain)
        phase("main", "%s beam: launches in the three requests %s (dense beam step = 3 x 24, context = 3 x 1)"
              % (variant, {k: v for k, v in beam_counts.items() if v}))
        show_captions(variant + " beam", beam_served)
        imgs32 = img_rng.randint(0, 256, (8, 224, 224, 3), dtype=np.uint8)
        check_f32(variant + " beam", acap32, imgs32, dense, attn_beam_plain, K_BEAM, {dense: T - 1, attention_context: 1})
        with torch.inference_mode():  # the scale at which f32 summation orders part
            h0 = last_h(init_hidden(acap32.model.decoder, dcfg, plain_features(acap32, imgs32)))
        phase("main", "%s f32 B=8: the initial state init_h(mean of the untrained encoder's features) reaches |h| = %.4g"
              % (variant, h0.abs().max().item()))
        routes = route_decodes(variant, beam_served[0], [
            ("sparse composite", {"attention_context": T, "project_topk": T - 1},
             lambda: attn_beam_search_decode(acap.prepared, acap.model.decoder, dcfg, feats, K_BEAM, acfg.start_token,
                                             END, PAD, fused_step=None, sparse=True),
             lambda: composite_controls(acap, dcfg, feats, acfg.start_token, dense, beam_served[0], variant)),
        ])
        s2d = s2d_path(variant, params, bn_state, acfg, requests, counter)
        return {"seconds": seconds, "comp_counts": comp_counts, "counts": counts, "other": {}, "cap": acap,
                "requests": requests, "beam_seconds": beam_s, "beam_counts": beam_counts, "routes": routes, "beam_share": beam_share,
                "s2d": s2d, "beam_decode": lambda: attn_beam_search_decode(
                    acap.prepared, acap.model.decoder, dcfg, feats, K_BEAM, acfg.start_token, END, PAD)}

    def cli_path(gru):
        """Phase 5b: N_FILES generated JPEGs through caption_paths (the s2d
        pooled GRU, B=64, overlapped then serial) and twice through the CLI
        with --s2d 1 --image_cache, from a checkpoint of the same weights;
        then caption_paths timed in turns, and its parts."""
        import contextlib
        import io
        import pickle
        import shutil
        import tempfile

        from show_tell_tpu_torch import serve as port_serve
        from show_tell_tpu_torch.data.serve_cache import ServeImageCache
        from show_tell_tpu_torch.serve import caption_paths
        from show_tell_tpu_torch.vocab import DatasetVocabulary

        tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
        try:
            img_dir = os.path.join(tmp, "images")
            os.makedirs(img_dir)
            paths = write_coco_jpegs(img_dir, N_FILES, SEED + 2)
            jpeg_kb = sum(os.path.getsize(p) for p in paths) / len(paths) / 1024
            scap = gru["s2d"]["cap"]
            for fn in counters:
                fn.launches = 0
            t0 = time.perf_counter()
            over = list(caption_paths(scap, paths, 64, overlap=True))
            t_over = time.perf_counter() - t0
            counts = read_counts(counters, dict(by_name(greedy_launches(fused_gru_decode_step, 3)), stem_fused=3))
            t0 = time.perf_counter()
            serial = list(caption_paths(scap, paths, 64, overlap=False))
            t_serial = time.perf_counter() - t0
            if [p for p, _ in over] != paths or over != serial:
                fail("caption_paths: the overlapped run's (path, caption) pairs differ from the serial run's")
            phase("main", "caption_paths, s2d pooled GRU bf16, %d JPEGs of %s pixels (%.1f KiB each on average) at "
                  "B=64 (3 batches, the last padded from 2): launches %s; overlapped %.3f s, serial %.3f s (host "
                  "clock, decode and load included); equal captions"
                  % (N_FILES, "/".join("%dx%d" % wh for wh in COCO_SIZES), jpeg_kb,
                     {k: v for k, v in counts.items() if v}, t_over, t_serial))

            params, bn_state = gru["params"]
            ckpt = {"format": "show_tell_tpu_torch", "decoder_state_dict": params["decoder"], "encoder_state_dict": {
                "frozen": {"resnet": params["encoder"]["resnet"]}, "bn_state": bn_state,
                "trainable": {k: params["encoder"][k] for k in ("linear_secondlast_layer", "last_layer")}}}
            ckpt_path, vocab_path = os.path.join(tmp, "model.ckpt"), os.path.join(tmp, "vocab.pkl")
            pv = DatasetVocabulary()
            pv.word_to_index, pv.index_to_word, pv.index = dict(vocab.word_to_index), dict(vocab.index_to_word), V
            with open(ckpt_path, "wb") as f:
                pickle.dump(ckpt, f)
            with open(vocab_path, "wb") as f:
                pickle.dump(pv, f)
            cache_dir = os.path.join(tmp, "cache")
            argv = ["--ckpt", ckpt_path, "--vocab", vocab_path, "--s2d", "1", "--image_cache", cache_dir, img_dir]
            expected = ["%s\t%s" % pair for pair in over]
            for run, report in enumerate(("0 hits, %d misses" % N_FILES, "%d hits, 0 misses" % N_FILES)):
                out, err = io.StringIO(), io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                    rc = port_serve.main(argv)
                seconds = time.perf_counter() - t0
                if rc != 0 or report not in err.getvalue():
                    fail("serve.main run %d: exit %d, expected the cache report %r, stderr %r"
                         % (run + 1, rc, report, err.getvalue()[-500:]))
                lines = out.getvalue().splitlines()
                if lines != expected:
                    n = sum(a == b for a, b in zip(lines, expected))
                    fail("serve.main run %d: %d lines, %d equal to caption_paths' %d" % (run + 1, len(lines), n,
                                                                                       len(expected)))
                phase("main", "serve.main --s2d 1 --image_cache, run %d: %d captions equal to caption_paths'; %s; "
                      "%.3f s with the checkpoint load (host clock)" % (run + 1, len(lines), report, seconds))
            phase("main", "JPEG decoder of data/images.load_images: %s" % fastimage.status())
            fast = ["%s\t%s" % pair for pair in caption_paths(scap, paths, 64, fast_jpeg=True)]
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = port_serve.main(["--ckpt", ckpt_path, "--vocab", vocab_path, "--s2d", "1", "--fast_jpeg", "1",
                                      img_dir])
            seconds = time.perf_counter() - t0
            lines = out.getvalue().splitlines()
            if rc != 0 or lines != fast:
                fail("serve.main --fast_jpeg 1: exit %d, %d lines, %d equal to caption_paths(fast_jpeg=True)'s %d"
                     % (rc, len(lines), sum(a == b for a, b in zip(lines, fast)), len(fast)))
            phase("main", "serve.main --s2d 1 --fast_jpeg 1: %d captions equal to caption_paths(fast_jpeg=True)'s, %d "
                  "of them equal to the full decode's; %.3f s with the checkpoint load (host clock)"
                  % (len(lines), sum(a == b for a, b in zip(lines, expected)), seconds))

            # In turns: overlapped and serial runs alternate which goes first, decoding the files and from
            # the (now full) cache; one file alone (a batch of 1); and one batch's load + stage and its captioning
            # alone, the pipeline's two parts.
            runs = {}
            for turn in range(CLI_TURNS):
                for cached in (False, True):
                    for overlap in ((True, False) if turn % 2 else (False, True)):
                        cache = ServeImageCache(cache_dir, IMG) if cached else None
                        t0 = time.perf_counter()
                        list(caption_paths(scap, paths, 64, cache=cache, overlap=overlap))
                        runs.setdefault((cached, overlap), []).append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                list(caption_paths(scap, paths[turn : turn + 1], 64))
                runs.setdefault("one file", []).append(time.perf_counter() - t0)
            parts = {}
            for _ in range(3):
                for name, load in (("load + stage, decode", lambda: scap.load_files(paths[:64])),
                                   ("load + stage, decode --fast_jpeg", lambda: scap.load_files(paths[:64], True)),
                                   ("load + stage, cache", lambda: np.stack(
                                       [ServeImageCache(cache_dir, IMG).get(q) for q in paths[:64]]))):
                    t0 = time.perf_counter()
                    staged = scap.stage(load())
                    torch.cuda.synchronize()
                    parts.setdefault(name, []).append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                scap.caption(staged)
                parts.setdefault("captioning", []).append(time.perf_counter() - t0)
            return {"counts": counts, "overlap_s": t_over, "serial_s": t_serial, "runs": runs, "parts": parts}
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def train_params(variant, Ed, optimizer, lr, **over):
        """The params dict of a flagship training run on the card (phases 7 and 8)."""
        return dict({"variant": variant, "resnet_version": 101, "embedding_length": Ed, "num_hidden_units": H,
                     "num_layers": L, "nos_cnn_filters": AC, "attn_dim": AA, "optimizer_type": optimizer, "lr": lr,
                     "momentum": 0.9, "batch_size": TRAIN_B, "device": "gpu", "seed": 1}, **over)

    def training_phase():
        """Phase 7: train.loop.train for every run of TRAIN_RUNS on N_FILES
        generated JPEGs with one synthetic caption each; the f32 card step
        against the CPU step, bf16 against f32; then an eval step and a
        served request from the pooled GRU's checkpoint."""
        import contextlib
        import io
        import pickle
        import shutil
        import tempfile

        from show_tell_tpu_torch.data.dataset import MSCOCO, DataLoader
        from show_tell_tpu_torch.data.images import load_images
        from show_tell_tpu_torch.models.captioner import exact_f32_math, trainable_parameters
        from show_tell_tpu_torch.train.checkpoint import read_checkpoint, restore_train_state
        from show_tell_tpu_torch.train.loop import captioner_config_from_params, train
        from show_tell_tpu_torch.train.train_step import create_train_state, make_eval_step, make_train_step
        from show_tell_tpu_torch.vocab import DatasetVocabulary, get_vocabulary, save_vocab, tokenizer_name

        tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
        try:
            img_dir = os.path.join(tmp, "train2014")
            os.makedirs(img_dir)
            paths = write_coco_jpegs(img_dir, N_FILES, SEED + 3)
            crng = np.random.RandomState(SEED + 4)  # one caption an image, 8-16 words of the synthetic vocabulary
            anns = [{"id": 1000 + i, "image_id": i, "caption": " ".join(
                vocab.index_to_word[int(j)] for j in crng.randint(4, V, crng.randint(8, 17)))} for i in range(N_FILES)]
            ann_path = os.path.join(tmp, "captions_train2014.json")
            with open(ann_path, "w") as f:
                json.dump({"images": [{"id": i, "file_name": os.path.basename(p)} for i, p in enumerate(paths)],
                           "annotations": anns}, f)
            vocab_path = os.path.join(tmp, "vocab.pkl")
            built = DatasetVocabulary()
            for i in range(V):
                built.add_new_word(vocab.index_to_word[i])
            save_vocab(built, vocab_path)
            tvocab = get_vocabulary("MSCOCO", {"vocab_path": vocab_path})  # loads the file: no tokenizing
            if len(tvocab) != V or tvocab.word_to_index != vocab.word_to_index:
                fail("get_vocabulary read %d words from vocab.pkl, not the %d saved" % (len(tvocab), V))
            phase("train", "tokenizer: %s" % tokenizer_name())
            dataset = MSCOCO(ann_path, img_dir, tvocab)
            phase("train", "JPEG decoder of data/dataset.MSCOCO: %s; %d images of %s pixels, one caption each, B=%d: "
                  "%d steps an epoch (drop_last)" % (dataset.decoder, N_FILES, "/".join("%dx%d" % wh for wh in COCO_SIZES),
                                                     TRAIN_B, N_FILES // TRAIN_B))
            def first_step(dev, cfg, optimizer, lr, init, batch, fmap=None):
                """The loop's first step again on ``dev`` from the same weights and flips: (loss, {trainable
                parameter: its gradient's norm}); with ``fmap``, the backbone's output is that map."""
                s = create_train_state(cfg, optimizer, lr, 0.9, device=dev, seed=1, init=init)
                if fmap is not None:
                    s.model.encoder.resnet = fixed_map(fmap.to(s.device))
                loss = float(make_train_step(cfg)(s, *batch[1:]))
                # norms summed in f64: on the CPU an f32 sum over the projection gradient's 5.1M values drifts
                # by more than TRAIN_CPU_RTOL
                return loss, {n: p.grad.double().norm().item() for n, p in trainable_parameters(s.model).items()
                              if p.grad is not None}

            def norm_gaps(card, cpu):
                """Each gradient norm's relative difference, with a floor of 1e-3 of the largest norm: the
                Linear bias in front of the head's train-mode BN1d has a gradient of roundoff alone."""
                if sorted(card) != sorted(cpu):
                    fail("the card's step has gradients for %s, the CPU's for %s" % (sorted(card), sorted(cpu)))
                floor = 1e-3 * max(cpu.values())
                rel = {n: abs(card[n] - cpu[n]) / max(cpu[n], floor) for n in cpu}
                return rel, max(rel, key=rel.get)

            def cpu_against_card(label, cfg, optimizer, lr, init, batch, loop_loss):
                """The f32 first step on the card against the CPU: the whole step (loss within TRAIN_CPU_RTOL,
                gradient norms within TRAIN_FULL_RTOL), the frozen backbone's train-mode output (within
                TRAIN_BACKBONE_RTOL), and the trainable part of the step from the CPU's backbone output on both
                (loss and every gradient norm within TRAIN_CPU_RTOL)."""
                (gl, gn), (cl, cn) = first_step("gpu", cfg, optimizer, lr, init, batch), \
                    first_step("cpu", cfg, optimizer, lr, init, batch)
                rel, worst = norm_gaps(gn, cn)
                if abs(gl - cl) > TRAIN_CPU_RTOL * abs(cl) or abs(gl - loop_loss) > TRAIN_CPU_RTOL * abs(cl):
                    fail("%s: the first step's loss %.7f on the card, %.7f on the CPU, %.7f in the loop"
                         % (label, gl, cl, loop_loss))
                if rel[worst] > TRAIN_FULL_RTOL:
                    fail("%s: the first step's gradient norm of %s %.6g on the card, %.6g on the CPU (bar %g)"
                         % (label, worst, gn[worst], cn[worst], TRAIN_FULL_RTOL))
                maps = {}
                for dev, tf32 in (("gpu", False), ("gpu", True), ("cpu", False)):
                    s = create_train_state(cfg, optimizer, lr, 0.9, device=dev, seed=1, init=init)
                    s.model.train()
                    with torch.no_grad(), exact_f32_math(s.device):
                        x = preprocess_images(torch.from_numpy(batch[1]).to(s.device), s.generator)
                        with torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32):  # TF32: the control
                            maps[dev, tf32] = s.model.encoder.resnet(x).double().cpu()
                    del s
                cpu_map = maps["cpu", False]
                fmap = cpu_map.float()
                backbone, tf32_gap = (((maps["gpu", t] - cpu_map).norm() / cpu_map.norm()).item() for t in (False, True))
                if backbone > TRAIN_BACKBONE_RTOL or tf32_gap <= TRAIN_BACKBONE_RTOL:
                    fail("%s: the backbone's train-mode output on the card is %.3g from the CPU's, relative, and %.3g "
                         "with TF32 (bar %g, which TF32 must exceed)" % (label, backbone, tf32_gap, TRAIN_BACKBONE_RTOL))
                (tl, tn), (ul, un) = first_step("gpu", cfg, optimizer, lr, init, batch, fmap), \
                    first_step("cpu", cfg, optimizer, lr, init, batch, fmap)
                trel, tworst = norm_gaps(tn, un)
                if abs(tl - ul) > TRAIN_CPU_RTOL * abs(ul) or trel[tworst] > TRAIN_CPU_RTOL:
                    fail("%s: from one backbone output, the first step's loss %.7f on the card, %.7f on the CPU; "
                         "gradient norm of %s %.6g / %.6g (bar %g)" % (label, tl, ul, tworst, tn[tworst], un[tworst],
                                                                       TRAIN_CPU_RTOL))
                phase("train", "%s: the first step on the card against the CPU: loss %.7f / %.7f (relative %.2e, "
                      "bar %g; the loop's %.7f); %d gradient norms within %.2e (bar %g; the farthest %s); the "
                      "frozen ResNet-101's train-mode output %.2e apart (bar %g; with cuDNN's TF32 on, %.3g); from "
                      "one backbone output, the loss %.2e and every gradient norm within %.2e relative (bar %g; the "
                      "farthest %s)" % (label, gl, cl, abs(gl - cl) / abs(cl), TRAIN_CPU_RTOL, loop_loss, len(cn),
                                        rel[worst], TRAIN_FULL_RTOL, worst, backbone, TRAIN_BACKBONE_RTOL, tf32_gap,
                                        abs(tl - ul) / abs(ul), trel[tworst], TRAIN_CPU_RTOL, tworst))

            first_losses, out = {}, {}
            for variant, Ed, optimizer, lr, dtype in TRAIN_RUNS:
                label = "%s %s %s" % (variant, dtype, optimizer)
                params = train_params(variant, Ed, optimizer, lr, num_epochs=TRAIN_EPOCHS, train_dtype=dtype,
                                      output_dir=os.path.join(tmp, "%s_%s" % (variant, dtype)))
                cfg = captioner_config_from_params(params, V)
                init = init_captioner(cfg, torch.Generator().manual_seed(SEED))
                loader = Recorder(DataLoader(dataset, TRAIN_B, shuffle=True, drop_last=True, num_workers=8, seed=1))
                for fn in counters:
                    fn.launches = 0
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()) as log:
                    ts = train(params, tvocab, loader, init_params_state=init)
                seconds = time.perf_counter() - t0
                read_counts(counters, {})  # no TPU kernel runs in training (the JAX package's train step is XLA)
                losses = []
                for epoch in range(1, TRAIN_EPOCHS + 1):
                    with open(os.path.join(params["output_dir"], "model_%d_metrics.ckpt" % epoch), "rb") as f:
                        losses += pickle.load(f)["train_loss"]
                if len(losses) != TRAIN_EPOCHS * (N_FILES // TRAIN_B) or not np.isfinite(losses).all():
                    fail("%s: losses %s (loop output %r)" % (label, losses, log.getvalue()[-500:]))
                with open(os.path.join(params["output_dir"], "metrics.jsonl")) as f:
                    last_epoch = [json.loads(line) for line in f][-1]
                host_s = last_epoch["timing"]["step"]["total_s"]
                steps = last_epoch["timing"]["step"]["count"]
                phase("train", "%s: losses %s; %.1f s for %d epochs with model build and checkpoints (host clock)"
                      % (label, " ".join("%.4f" % x for x in losses), seconds, TRAIN_EPOCHS))
                # CUDA events: TRAIN_TIMED more steps over the last epoch's batches, staged on the card beforehand
                step = make_train_step(cfg, compute_dtype=dtype)
                staged = [[torch.from_numpy(a).to(device) for a in b[1:]] for b in loader.epochs[-1][:TRAIN_TIMED]]
                step(ts, *staged[0])
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                for b in staged:
                    step(ts, *b)
                end.record()
                torch.cuda.synchronize()
                step_ms = start.elapsed_time(end) / len(staged)
                out[variant, dtype] = {"step_ms": step_ms, "host_ms": host_s / steps * 1e3}
                phase("train", "%s %s ResNet-101 B=%d: %.1f train images/s by CUDA events (%d steps, %.2f ms a step, "
                      "batches on the card), %.1f by the host clock (the loop's last epoch, %d steps, %.2f ms a step "
                      "to float(loss))" % (card, label, TRAIN_B, TRAIN_B / step_ms * 1e3, len(staged), step_ms,
                                           TRAIN_B / host_s * steps, steps, host_s / steps * 1e3))
                del ts, step, staged
                loader.inner.close()
                first_batch = loader.epochs[0][0]
                if dtype == "float32":
                    first_losses[variant] = losses[0]
                    cpu_against_card(label, cfg, optimizer, lr, init, first_batch, losses[0])
                else:
                    ref = first_losses[variant]
                    if abs(losses[0] - ref) > 0.05 * abs(ref) + 0.05:
                        fail("%s: first loss %.4f against f32 %.4f (bar 5%% + 0.05)" % (label, losses[0], ref))
                    phase("train", "%s: first loss %.4f against the f32 run's %.4f (bar 5%% + 0.05: %.4f)"
                          % (label, losses[0], ref, abs(losses[0] - ref)))
                    if losses[-1] >= losses[0]:
                        phase("train", "%s: note: the last loss %.4f is not below the first" % (label, losses[-1]))
                out[variant, dtype]["first_batch"] = first_batch
                torch.cuda.empty_cache()

            # the pooled GRU's f32 checkpoint: an eval step (the decode kernels), and one served request of 64
            cfg = CaptionerConfig("gru", 101, E, H, V, L)
            ckpt = os.path.join(tmp, "gru_float32", "model_%d.ckpt" % TRAIN_EPOCHS)
            ts = create_train_state(cfg, "SGD", 0.01, device="gpu", seed=2)
            restore_train_state(ts, read_checkpoint(ckpt))
            _, images, captions, lengths = out["gru", "float32"]["first_batch"]
            expected = greedy_launches(fused_gru_decode_step, 1)
            for fn in counters:
                fn.launches = 0
            loss, ids = make_eval_step(cfg)(ts, images, captions, lengths, torch.Generator().manual_seed(SEED))
            counts = read_counts(counters, by_name(expected))
            ids = ids.cpu().numpy()
            with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                ts.model.eval()
                x = preprocess_images(torch.from_numpy(images).to(device), torch.Generator().manual_seed(SEED))
                feats = ts.model.encoder(x)
                prep = prepare_decode(ts.model, torch.float32)

                def step32(xx, state):
                    tok, state2 = fused_gru_decode_step_plain(prep["stacked"], prep["vocab"], xx, state)
                    return tok, state2, project_logits(prep["vocab"], last_h(state2))

                ref_ids, _ = plain_loop(step32, prep["embedding"], feats, init_state("gru", L, len(images), H,
                                                                                       torch.float32, device))
            rows = int((ids == ref_ids).all(axis=1).sum())
            if not np.isfinite(float(loss)) or ids.shape != (TRAIN_B, T) or rows < 0.99 * TRAIN_B:
                fail("gru eval step from model_%d.ckpt: loss %s, ids %s, %d of %d rows equal the plain decode"
                     % (TRAIN_EPOCHS, float(loss), ids.shape, rows, TRAIN_B))
            phase("train", "gru f32 eval step from model_%d.ckpt (eval BN, flips as the reference): loss %.4f; launches "
                  "%s; %d of %d rows of ids equal the plain step's decode of its features"
                  % (TRAIN_EPOCHS, float(loss), {k: v for k, v in counts.items() if v}, rows, TRAIN_B))
            del ts
            cap = Captioner.from_checkpoint(ckpt, vocab_path, variant="gru", resnet_version=101, embed_dim=E,
                                            hidden_dim=H, num_layers=L, device="gpu")
            request = load_images(paths[:64])
            served, seconds, counts = serve(cap, [request], counters,
                                            dict(by_name(greedy_launches(fused_gru_decode_step, 1)), preprocess_u8=1))

            def trained_plain(c, imgs):
                with torch.inference_mode():
                    f = plain_features(c, imgs)
                    p = c.prepared

                    def step16(xx, state):
                        tok, state2 = fused_gru_decode_step_plain(p["stacked"], p["vocab"], xx, state)
                        return tok, state2, project_logits(p["vocab"], last_h(state2))

                    return plain_loop(step16, p["embedding"], f.to(c.dtype),
                                      init_state("gru", L, len(imgs), H, c.dtype, device))

            share = request_share("trained gru", 0, served[0], len(request), trained_plain(cap, request)[0])
            phase("train", "Captioner.from_checkpoint(model_%d.ckpt), bf16: one request of 64 of the training JPEGs, "
                  "launches %s, %.3f s (host clock); ids equal the plain step's decode on %.4f of positions (>= 0.95)"
                  % (TRAIN_EPOCHS, {k: v for k, v in counts.items() if v}, seconds, share))
            del cap
            torch.cuda.empty_cache()
            # 8. eval, on these checkpoints
            return eval_phase(tmp, dataset, tvocab, out["gru", "float32"]["first_batch"][1:])
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def eval_phase(tmp, dataset, tvocab, train_batch):
        """Phase 8: test_model on phase 7's f32 checkpoints of the four families (and the pooled GRU in bf16, by
        beam and by the faithful beam), the native scorer against the Python one, the loop's in-training eval
        against a direct call, and eval images/s.  Returns the launch counts of its main-path runs."""
        import contextlib
        import io
        import pickle
        import re
        import shutil

        from show_tell_tpu_torch.data.dataset import DataLoader
        from show_tell_tpu_torch.decode.faithful_beam import faithful_beam_decode
        from show_tell_tpu_torch.evaluation import tester
        from show_tell_tpu_torch.evaluation.metrics import evaluate, nltk_bleu4_method4
        from show_tell_tpu_torch.models.captioner import exact_f32_math
        from show_tell_tpu_torch.native import fastmetrics
        from show_tell_tpu_torch.train.checkpoint import read_checkpoint, restore_train_state
        from show_tell_tpu_torch.train.loop import captioner_config_from_params, train
        from show_tell_tpu_torch.train.train_step import create_train_state
        from show_tell_tpu_torch.utils import StepTimer

        loader = DataLoader(dataset, TRAIN_B, shuffle=False, drop_last=False, num_workers=8)
        batches = list(loader)  # decoded once (PIL's decode is phase 7's data stage); every eval reads these
        loader.close()
        n_images = sum(len(b[0]) for b in batches)
        if [len(b[0]) for b in batches] != [TRAIN_B] * (N_FILES // TRAIN_B) + [N_FILES % TRAIN_B]:
            fail("the test loader gave batches of %s" % [len(b[0]) for b in batches])
        out_dir = os.path.join(tmp, "eval")
        os.makedirs(out_dir)
        greedy_step = {"gru": fused_gru_decode_step, "lstm": fused_lstm_decode_step, "attn": fused_attn_decode_step,
                       "attn_lstm": fused_attn_lstm_decode_step}
        main_counts = []

        def run_eval(ts, cfg, data, expected, **kw):
            """test_model with every count zeroed just before and read just after (``expected``: {kernel:
            launches}, None for timing runs); its printed output kept apart.  Returns (scores, the
            Candidate_Words_Dict it pickled, counts, printed text)."""
            params = {"output_dir": out_dir, "eval_augment": 0, "compute_dtype": kw.pop("dtype", "float32")}
            for fn in counters:
                fn.launches = 0
            with contextlib.redirect_stdout(io.StringIO()) as log:
                scores = tester.test_model(ts, cfg, data, tvocab, params, **kw)
            counts = read_counts(counters, by_name(expected)) if expected is not None else None
            with open(os.path.join(out_dir, "Candidate_Words_Dict.pickle"), "rb") as f:
                return scores, pickle.load(f), counts, log.getvalue()

        def eval_features(ts, imgs):
            """The features test_model's step decodes: no flips, f32, TF32 off, eval mode."""
            ts.model.eval()
            try:
                with torch.no_grad(), exact_f32_math(device):
                    return encode(ts.model, preprocess_images(torch.from_numpy(imgs).to(device), None, False))
            finally:
                ts.model.train()

        def plain_greedy(cfg, ts, prepared, feats):
            """The features decoded greedily with the fused step's plain twin on the card: (ids, top-2 gaps)."""
            B = feats.shape[0]
            if cfg.is_attention:
                dec = ts.model.decoder
                prep = prepare_attn_decode(prepared, dec, feats.transpose(1, 2))

                def astep(w_emb, state):
                    tok, state2 = fused_attn_decode_step_plain(prep, w_emb, state)
                    return tok, state2, project_logits(prep["vocab"], last_h(state2))

                return plain_loop(astep, dec.embeddings.weight, start_embeddings(dec, B, cfg.start_token, device),
                                  init_hidden(dec, cfg.decoder_config(), feats))
            plain = fused_lstm_decode_step_plain if cfg.cell_type == "lstm" else fused_gru_decode_step_plain

            def pstep(x, state):
                tok, state2 = plain(prepared["stacked"], prepared["vocab"], x, state)
                return tok, state2, project_logits(prepared["vocab"], last_h(state2))

            return plain_loop(pstep, prepared["embedding"], feats,
                              init_state(cfg.cell_type, L, B, H, torch.float32, device))

        def plain_beam_decode(cfg, ts, prepared, feats):
            """The features beam-decoded (K_BEAM) with the plain twins as steps (the context's at step 0) on the
            card: (ids, score gaps)."""
            B, dcfg = feats.shape[0], cfg.decoder_config()
            if cfg.is_attention:
                dec = ts.model.decoder
                feats_pm = feats.transpose(1, 2).contiguous()
                prep = prepare_attn_decode(prepared, dec, feats_pm)
                state0 = init_hidden(dec, dcfg, feats)
                ctx, _ = attention_context_plain(prepared, feats_pm, prep["att1"], last_h(state0))
                w0 = start_embeddings(dec, B, cfg.start_token, device)
                x = torch.cat([w0, linear_f32(dec.embed, ctx).to(w0.dtype)], dim=-1)
                top, state1 = stack_plain(dcfg.cell_type)(prepared["stacked"], x, state0)
                rows = dict(prep, feats_e=prep["feats_e"].repeat_interleave(K_BEAM, dim=0),
                            att1=prep["att1"].repeat_interleave(K_BEAM, dim=0))

                def step(tokens, state):
                    logits, state2 = fused_attn_dense_step_plain(rows, dec.embeddings.weight.index_select(0, tokens),
                                                                 state)
                    return torch.log_softmax(logits, dim=-1), state2
            else:
                state0 = init_state(cfg.cell_type, L, B, H, torch.float32, device)
                top, state1 = stack_plain(cfg.cell_type)(prepared["stacked"], feats, state0)

                def step(tokens, state):
                    logits, state2 = fused_dense_step_plain(prepared["stacked"], prepared["vocab"],
                                                            prepared["embedding"].index_select(0, tokens), state)
                    return torch.log_softmax(logits, dim=-1), state2

            return plain_beam(torch.log_softmax(project_logits(prepared["vocab"], top), dim=-1), state1, step, B)

        def hold(label, cands, data, decode):
            """Fails unless test_model's Candidate_Words_Dict equals, image by image, the dict of ``decode``'s ids
            (batch by batch over ``data``), but where the plain decode's smallest gap at a choice is at most
            1e-4 (phase 3's f32 tie bar: there another summation order may choose otherwise).  Returns the
            reference ids."""
            ref, gaps, ids_all = {}, {}, []
            for paths, _, _, _, ids, gap in decode(data):
                ids_all.append(ids)
                for p, words, g in zip(paths, tester.create_caption_word_format(ids, tvocab), gap):
                    ref.setdefault(p, []).append(words)
                    gaps[p] = min(gaps.get(p, np.inf), float(g))
            if sorted(cands) != sorted(ref):
                fail("%s: test_model captioned %d images, the plain decode %d" % (label, len(cands), len(ref)))
            differ = [p for p in ref if cands[p] != ref[p]]
            ties = [p for p in differ if gaps[p] <= 1e-4]
            if len(differ) > len(ties):
                fail("%s: Candidate_Words_Dict differs from the plain decode's on %d of %d images, %d of them with "
                     "no gap at or below 1e-4 (e.g. %s: %s against %s)" % (
                         label, len(differ), len(ref), len(differ) - len(ties), differ[0], cands[differ[0]],
                         ref[differ[0]]))
            phase("eval", "%s: Candidate_Words_Dict equals the plain decode's on %d of %d images%s" % (
                label, len(ref) - len(differ), len(ref),
                "; %d differ where a choice of the plain decode has a gap <= 1e-4 (smallest %.3g)"
                % (len(ties), min(gaps[p] for p in ties)) if ties else ""))
            return ids_all

        def decoded(ts, cfg, plain):
            prepared = prepare_decode(ts.model, torch.float32)

            def decode(data):
                for paths, imgs, captions, lengths in data:
                    with torch.no_grad(), exact_f32_math(device):
                        ids, gap = plain(cfg, ts, prepared, eval_features(ts, imgs))
                    yield paths, imgs, captions, lengths, ids, gap

            return decode

        def step_syncs(label, ts, cfg, beam_size=0):
            """One eval step (test_model's: flips, loss and decode) of the first batch, staged on the card, queued
            under torch.cuda.set_sync_debug_mode("warn"); fails if it synced the device (test_model reads nothing
            of a batch before the next one is queued)."""
            import warnings

            imgs, caps, lens = (torch.from_numpy(a).to(device) for a in batches[0][1:])
            step = tester.make_test_step(cfg, beam_size, augment=True)
            prepared = prepare_decode(ts.model, torch.float32)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    step(ts, imgs, caps, lens, torch.Generator().manual_seed(SEED), prepared,
                         int(batches[0][3].max()))
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            syncs = [w for w in caught if "synchroniz" in str(w.message)]
            if syncs:
                fail("%s: one eval step synced the device %d times, first at %s:%d"
                     % (label, len(syncs), syncs[0].filename, syncs[0].lineno))
            phase("eval", "%s: one eval step (flips on) queued with no device sync (torch.cuda.set_sync_debug_mode)"
                  % label)
            # the same step once more under torch.profiler: the card's kernel time against the host's wall time
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step(ts, imgs, caps, lens, torch.Generator().manual_seed(SEED), prepared, int(batches[0][3].max()))
                queued = time.perf_counter() - t0
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
            busy_us = sum(getattr(e, "self_device_time_total", 0) for e in kernels)
            if busy_us <= 0:
                phase("eval", "%s %s: the profiler saw no device time: the step's device busy share is not measured"
                      % (card, label))
            else:
                phase("eval", "%s %s B=%d: one eval step under torch.profiler: %d kernel launches, %.2f ms of kernel "
                      "time on the card, queued in %.2f ms and done in %.2f ms (host clock, profiler on): the card "
                      "busy %.1f%% of it" % (card, label, TRAIN_B, sum(e.count for e in kernels), busy_us / 1e3,
                                             queued * 1e3, wall * 1e3, busy_us / 1e3 / (wall * 1e3) * 100))

        # greedy, f32, each family: 25 launches of its fused step a batch; captions against the plain decode
        states, greedy_ids = {}, {}
        for variant, Ed, optimizer, lr, dtype in TRAIN_RUNS:
            if dtype != "float32":
                continue
            cfg = captioner_config_from_params(train_params(variant, Ed, optimizer, lr), V)
            ts = create_train_state(cfg, optimizer, lr, device="gpu", seed=1)
            restore_train_state(ts, read_checkpoint(os.path.join(tmp, "%s_float32" % variant,
                                                                 "model_%d.ckpt" % TRAIN_EPOCHS)))
            states[variant] = cfg, ts
            timer = StepTimer()
            expected = {greedy_step[variant]: len(batches) * T}
            scores, cands, counts, _ = run_eval(ts, cfg, batches, expected, timer=timer)
            main_counts.append(counts)
            split = timer.summary()
            phase("eval", "%s f32 test_model from model_%d.ckpt, B=%d (%d batches, %d images, no flips): launches %s "
                  "(25 a batch); test loss %.4f; %s; host clock a batch: step queued in %.2f ms, consumed (loss and "
                  "ids read, captions, scoring handed to the pool) in %.2f ms" % (
                      variant, TRAIN_EPOCHS, TRAIN_B, len(batches), n_images, {k: v for k, v in counts.items() if v},
                      scores["test_loss"], ", ".join("%s %.4f" % (k, v) for k, v in scores.items() if k != "test_loss"),
                      split["step"]["mean_ms"], split["score"]["mean_ms"]))
            greedy_ids[variant] = hold("%s f32 greedy" % variant, cands, batches, decoded(ts, cfg, plain_greedy))
            step_syncs("%s f32 greedy" % variant, ts, cfg)
            if variant == "gru":
                f32_scores = scores

        # the pooled GRU in bf16: the tensor-core instance of the greedy step; every score within 0.05 of f32
        cfg, ts = states["gru"]
        scores16, _, counts, _ = run_eval(ts, cfg, batches, {fused_gru_decode_step: len(batches) * T}, dtype="bfloat16")
        main_counts.append(counts)
        worst = max(("Bleu_1", "Bleu_4", "CIDEr", "ROUGE_L", "test_loss"), key=lambda k: abs(scores16[k] - f32_scores[k]))
        if abs(scores16[worst] - f32_scores[worst]) > 0.05:
            fail("gru bf16 test_model: %s %.4f against f32 %.4f (bar 0.05)" % (worst, scores16[worst], f32_scores[worst]))
        phase("eval", "gru bf16 test_model: launches %s; every score within %.4f of f32 (bar 0.05; the farthest %s: "
              "%.4f / %.4f)" % ({k: v for k, v in counts.items() if v}, abs(scores16[worst] - f32_scores[worst]), worst,
                                scores16[worst], f32_scores[worst]))

        # beam, K_BEAM, f32: the pooled GRU (dense step) and the attention GRU (dense step, the context at step 0)
        for variant, expected in (("gru", {fused_gru_dense_step: len(batches) * (T - 1)}),
                                  ("attn", {fused_attn_dense_step: len(batches) * (T - 1),
                                            attention_context: len(batches)})):
            cfg, ts = states[variant]
            _, cands, counts, _ = run_eval(ts, cfg, batches, expected, beam_size=K_BEAM)
            main_counts.append(counts)
            phase("eval", "%s f32 test_model, beam K=%d: launches %s" % (variant, K_BEAM,
                                                                          {k: v for k, v in counts.items() if v}))
            hold("%s f32 beam K=%d" % (variant, K_BEAM), cands, batches, decoded(ts, cfg, plain_beam_decode))
            step_syncs("%s f32 beam K=%d" % (variant, K_BEAM), ts, cfg, K_BEAM)

        # the faithful beam: the pooled GRU on 8 single-image batches, against the same decode on the CPU from the
        # card's features
        cfg, ts = states["gru"]
        singles = [((p,), im[None], c[None], n[None]) for b in batches for p, im, c, n in zip(*b)][:8]
        _, cands, counts, _ = run_eval(ts, cfg, singles, {}, beam_size=K_BEAM, faithful_beam=True)
        prep_cpu = {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict) else v.cpu())
                    for k, v in prepare_decode(ts.model, torch.float32).items()}

        def faithful_on_cpu(data):
            for paths, imgs, captions, lengths in data:
                gaps = []
                ids = faithful_beam_decode(prep_cpu, cfg.decoder_config(), eval_features(ts, imgs).cpu(), K_BEAM, gaps)
                yield paths, imgs, captions, lengths, ids[None], [min(gaps)]

        hold("gru f32 faithful beam K=%d (8 single-image batches, the card against the CPU)" % K_BEAM, cands, singles,
             faithful_on_cpu)

        # the native scorer against the Python path on this phase's captions (each f32 family's greedy captions)
        phase("eval", "caption scorer: %s" % fastmetrics.status())
        weights = [(1.0, 0, 0, 0), (0.5, 0.5, 0, 0), (0.34, 0.33, 0.33, 0), (0.25, 0.25, 0.25, 0.25)]
        score_s = {}
        for path_name, env in (("native", None), ("Python", "0")):
            if env is not None:
                os.environ["ST_FASTMETRICS"] = env
            try:
                t0 = time.perf_counter()
                rows, sums = [], []
                for variant, id_batches in greedy_ids.items():
                    for (paths, _, captions, _), ids in zip(batches, id_batches):
                        target = tester.create_caption_word_format(captions, tvocab, True)
                        predicted = tester.create_caption_word_format(ids, tvocab)
                        rows.append(evaluate(target, predicted))
                        for refs, cand in zip(target, predicted):
                            got = fastmetrics.corpus_bleu4_sums(refs, [cand], weights)
                            sums.append(list(got) if got is not None else nltk_bleu4_method4(refs, cand, weights))
                score_s[path_name] = (time.perf_counter() - t0, rows, sums)
            finally:
                os.environ.pop("ST_FASTMETRICS", None)
        (ns, nrows, nsums), (ps, prows, psums) = score_s["native"], score_s["Python"]
        if nrows != prows or nsums != psums:
            fail("native and Python scores differ: %s" % [(a, b) for a, b in zip(nrows, prows) if a != b][:2])
        phase("eval", "native and Python scores equal on %d batches and %d images' corpus BLEU (4 families' greedy "
              "captions): %.2f ms a batch native, %.2f ms Python, with the corpus pass (host clock)"
              % (len(nrows), len(nsums), ns / len(nrows) * 1e3, ps / len(prows) * 1e3))

        # the loop's in-training eval: one epoch of the pooled GRU, test_model on sub_batch_test=2 batches (flips
        # on, as the reference), against a direct call on that epoch's checkpoint
        Ed, optimizer, lr = E, "SGD", 0.01
        params = train_params("gru", Ed, optimizer, lr, num_epochs=1, sub_batch_test=2,
                              output_dir=os.path.join(tmp, "gru_in_training"))
        cfg = captioner_config_from_params(params, V)
        init = init_captioner(cfg, torch.Generator().manual_seed(SEED))
        train_loader = DataLoader(dataset, TRAIN_B, shuffle=True, drop_last=True, num_workers=8, seed=1)
        for fn in counters:
            fn.launches = 0
        with contextlib.redirect_stdout(io.StringIO()) as log:
            train(params, tvocab, train_loader, batches, eval_every_epochs=1, init_params_state=init)
        train_loader.close()
        main_counts.append(read_counts(counters, by_name({fused_gru_decode_step: 2 * T})))
        ts = create_train_state(cfg, optimizer, lr, device="gpu", seed=1)
        restore_train_state(ts, read_checkpoint(os.path.join(params["output_dir"], "model_1.ckpt")))
        with contextlib.redirect_stdout(io.StringIO()) as direct:
            tester.test_model(ts, cfg, batches, tvocab, params, sub_batch_size=2)
        lines = [[re.sub(r"[0-9.]+ time", "<t> time", x) for x in text.splitlines() if "test loss" in x]
                 for text in (log.getvalue(), direct.getvalue())]
        if len(lines[0]) != 2 or lines[0] != lines[1]:
            fail("the in-training eval printed %s, a direct test_model call %s" % (lines[0], lines[1]))
        phase("eval", "gru f32 train(eval_every_epochs=1, sub_batch_test=2): launches {'fused_gru_decode_step': %d}; "
              "its printed scores equal a direct test_model call on model_1.ckpt: %s" % (2 * T, lines[0][0]))
        del ts

        # the CLI's test phase on the card: its loader tokenizes the captions (tokenizer_name(), phase 7)
        from show_tell_tpu_torch.cli.run import run

        gru_dir = os.path.join(tmp, "gru_float32")
        shutil.copy(os.path.join(tmp, "vocab.pkl"), os.path.join(gru_dir, "vocab.pkl"))
        argv = ["--data_dir", tmp, "--output_dir", gru_dir, "--test_ann_path", "captions_train2014.json",
                "--train_ann_path", "captions_train2014.json", "--train_img_dir", "train2014",
                "--test_img_dir", "train2014", "--resnet_version", "101", "--embedding_length", str(E),
                "--num_hidden_units", str(H),
                "--num_layers", str(L), "--batch_size", str(TRAIN_B), "--is_training", "0", "--is_testing", "1",
                "--load_model_test", "model_%d" % TRAIN_EPOCHS, "--eval_augment", "0", "--device", "gpu"]
        with contextlib.redirect_stdout(io.StringIO()):
            cli_scores = run("gru", argv)["scores"]
        if any(cli_scores[k] != f32_scores[k] for k in f32_scores if k != "test_loss"):
            fail("cli.run.run's test phase scored %s, test_model %s" % (cli_scores, f32_scores))
        phase("eval", "cli.run.run('gru', ... --device gpu) test phase: scores equal the direct test_model's")

        # eval images/s, host clock to the scores, the batches in memory: PIPELINE_SCORING on and off in turns
        rates = {}
        try:
            for variant, dtype in (("gru", "float32"), ("lstm", "float32"), ("attn", "float32"),
                                   ("attn_lstm", "float32"), ("gru", "bfloat16")):
                cfg, ts = states[variant]
                for _ in range(3):
                    for pipelined in (True, False):
                        tester.PIPELINE_SCORING = pipelined
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        run_eval(ts, cfg, batches, None, dtype=dtype)
                        rates.setdefault((variant, dtype, pipelined), []).append(n_images / (time.perf_counter() - t0))
                on, off = (rates[variant, dtype, p] for p in (True, False))
                phase("eval", "%s %s %s test_model B=%d, %d images in %d batches from memory, no flips, host clock to "
                      "the scores: pipelined %.1f images/s [%.1f, %.1f], serial %.1f [%.1f, %.1f] (median [min, max] "
                      "of 3 in turns)" % (card, variant, dtype, TRAIN_B, n_images, len(batches),
                                          statistics.median(on), min(on), max(on), statistics.median(off), min(off),
                                          max(off)))
        finally:
            tester.PIPELINE_SCORING = True
        # 7 (c) and 8 (d): data parallelism on the card, the sharded eval held to the f32 GRU's scores above
        dp_phase(tmp, batches, f32_scores, train_batch)
        return main_counts

    def spawn_ranks(world, backend, work):
        """dp_worker on ``world`` ranks spawned on cuda:0 (parallel.multihost.spawn, ended after DP_TIMEOUT);
        returns their results in rank order and the seconds they took."""
        from show_tell_tpu_torch.parallel import multihost

        t0 = time.perf_counter()
        try:
            results = multihost.spawn(dp_worker, world, (work,), device, backend, timeout=DP_TIMEOUT)
        except TimeoutError as e:
            fail("%d %s ranks: %s" % (world, backend, e))
        return results, time.perf_counter() - t0

    def dp_phase(tmp, batches, f32_scores, train_batch):
        """Phase 7 (c): a one-rank nccl group (the pooled GRU), then two gloo ranks on cuda:0 (the pooled and the
        attention GRU, full width), each DP_STEPS f32 steps at global B=TRAIN_B from the seeded weights, with
        flips, and one step from one backbone output: each rank's losses, that step's loss and every trainable
        gradient's norm against one process's card steps (dp_steps, mesh None) within TRAIN_CPU_RTOL, and the two
        ranks equal.  Phase 8 (d): test_model over the two gloo ranks from phase 7's f32 GRU checkpoint, on phase
        8's batches without flips: its scores equal the one-process run's (the word-level ones exactly,
        test_loss within 1e-5 relative), each rank 25 greedy launches a batch.  No step is skipped or caught."""
        import pickle

        from show_tell_tpu_torch.models.captioner import exact_f32_math
        from show_tell_tpu_torch.train.loop import captioner_config_from_params
        from show_tell_tpu_torch.train.train_step import create_train_state

        cfgs, fmaps, refs = {}, {}, {}
        for variant, Ed in FOLD_VARIANTS:
            kw = dict(nos_filters=AC, attn_dim=AA) if variant.startswith("attn") else {}
            cfg = CaptionerConfig(variant, 101, Ed, H, V, L, **kw)
            init = init_captioner(cfg, torch.Generator().manual_seed(SEED))
            s = create_train_state(cfg, "SGD", 0.01, 0.9, device="gpu", seed=1, init=init)
            with torch.no_grad(), exact_f32_math(device):  # one train-mode backbone output of the batch
                fmaps[variant] = s.model.encoder.resnet(preprocess_images(torch.from_numpy(train_batch[0]).to(device),
                                                                         s.generator)).cpu()
            del s
            cfgs[variant] = tuple(cfg)
            refs[variant] = dp_steps(cfg, init, train_batch, device, None, fmaps[variant])
            torch.cuda.empty_cache()

        def hold(label, results):
            for variant in results[0]["train"]:
                got = [r["train"][variant] for r in results]
                if any(g != got[0] for g in got[1:]):
                    fail("%s %s: the ranks disagree: %s" % (label, variant, got))
                got, want = got[0], refs[variant]
                rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"] + [got["fixed_loss"]],
                                                              want["losses"] + [want["fixed_loss"]]))
                if sorted(got["norms"]) != sorted(want["norms"]):
                    fail("%s %s: gradients for %s, one process's for %s" % (label, variant, sorted(got["norms"]),
                                                                             sorted(want["norms"])))
                floor = 1e-3 * max(want["norms"].values())  # as phase 7: the Linear bias before BN1d is roundoff
                nrel = {n: abs(got["norms"][n] - w) / max(w, floor) for n, w in want["norms"].items()}
                worst = max(nrel, key=nrel.get)
                if rel > TRAIN_CPU_RTOL or nrel[worst] > TRAIN_CPU_RTOL:
                    fail("%s %s: losses %s (from one backbone output %.7f) against one process's %s (%.7f); gradient "
                         "norm of %s %.6g against %.6g (bar %g)" % (label, variant, got["losses"], got["fixed_loss"],
                                                                    want["losses"], want["fixed_loss"], worst,
                                                                    got["norms"][worst], want["norms"][worst],
                                                                    TRAIN_CPU_RTOL))
                phase("train", "%s %s f32 B=%d: %d steps' losses %s against one process's %s on the card; from one "
                      "backbone output the loss %.7f / %.7f; largest gap %.2e relative (bar %g); %d gradient norms "
                      "within %.2e (the farthest %s; bar %g); the ranks equal" % (
                          label, variant, TRAIN_B, DP_STEPS, " ".join("%.7f" % x for x in got["losses"]),
                          " ".join("%.7f" % x for x in want["losses"]), got["fixed_loss"], want["fixed_loss"], rel,
                          TRAIN_CPU_RTOL, len(nrel), nrel[worst], worst, TRAIN_CPU_RTOL))

        work = os.path.join(tmp, "dp_nccl")
        os.makedirs(work)
        with open(os.path.join(work, "inputs.pkl"), "wb") as f:
            pickle.dump({"cfgs": {"gru": cfgs["gru"]}, "batch": train_batch, "fmaps": {"gru": fmaps["gru"]}}, f)
        results, seconds = spawn_ranks(1, "nccl", work)
        if results[0]["backend"] != "nccl":
            fail("the one-rank group ran on %s, not nccl" % results[0]["backend"])
        hold("dp: one nccl rank (DDP and the synced BatchNorms over itself)", results)
        phase("train", "dp: the one-rank nccl group took %.1f s (spawn, build, steps)" % seconds)

        work = os.path.join(tmp, "dp_gloo")
        os.makedirs(os.path.join(work, "eval"))
        gcfg = captioner_config_from_params(train_params("gru", E, "SGD", 0.01), V)
        with open(os.path.join(work, "inputs.pkl"), "wb") as f:
            pickle.dump({"cfgs": cfgs, "batch": train_batch, "fmaps": fmaps,
                         "eval": {"cfg": tuple(gcfg), "batches": batches,
                                  "ckpt": os.path.join(tmp, "gru_float32", "model_%d.ckpt" % TRAIN_EPOCHS)}}, f)
        results, seconds = spawn_ranks(2, "gloo", work)
        hold("dp: two gloo ranks on cuda:0", results)
        for r in results:
            got = r["eval"]
            off = [k for k in f32_scores if k != "test_loss" and got.get(k) != f32_scores[k]]
            loss_rel = abs(got["test_loss"] - f32_scores["test_loss"]) / abs(f32_scores["test_loss"])
            if off or loss_rel > 1e-5 or r["eval_launches"] != len(batches) * T:
                fail("sharded eval rank %d: scores %s against one process's %s (unequal: %s; test_loss %.2e apart); "
                     "%d greedy launches" % (r["rank"], got, f32_scores, off, loss_rel, r["eval_launches"]))
        phase("eval", "sharded test_model over two gloo ranks on cuda:0 (gru f32, model_%d.ckpt, %d batches, no "
              "flips): every score equal to the one-process run's (%s), test_loss %.7f / %.7f; each rank %d greedy "
              "launches (its rows of each batch); the two ranks took %.1f s (spawn, build, steps, eval)"
              % (TRAIN_EPOCHS, len(batches), ", ".join("%s %.4f" % (k, v) for k, v in f32_scores.items()
                                                       if k != "test_loss"),
                 results[0]["eval"]["test_loss"], f32_scores["test_loss"], results[0]["eval_launches"], seconds))

    def reference_ckpt_phase(tmp):
        """Phase 6 (a): a full-width reference-format torch .ckpt of each
        FOLD_VARIANTS family (seeded weights), served at B=64 through
        Captioner.from_checkpoint (counts zeroed just before the request,
        read just after); its ids must equal, position for position, those
        of the Captioner built from the same weights."""
        from show_tell_tpu_torch.vocab import DatasetVocabulary, save_vocab

        built = DatasetVocabulary()
        for i in range(V):
            built.add_new_word(vocab.index_to_word[i])
        vocab_path = os.path.join(tmp, "vocab.pkl")
        save_vocab(built, vocab_path)
        for variant, Ed in FOLD_VARIANTS:
            kw = dict(nos_filters=AC, attn_dim=AA) if variant.startswith("attn") else {}
            cfg = CaptionerConfig(variant, 101, Ed, H, V, L, **kw)
            params, bn_state = init_captioner(cfg, torch.Generator().manual_seed(SEED))
            path = os.path.join(tmp, "model_1_%s.ckpt" % variant)
            write_reference_ckpt(params, bn_state, path)
            request = img_rng.randint(0, 256, (64, IMG, IMG, 3), dtype=np.uint8)
            cap = Captioner.from_checkpoint(path, vocab_path, variant=variant, resnet_version=101, embed_dim=Ed,
                                            hidden_dim=H, num_layers=L, device="gpu", **kw)
            counter = fused_gru_decode_step if variant == "gru" else fused_attn_decode_step
            served, seconds, counts = serve(cap, [request], counters,
                                            dict(by_name(greedy_launches(counter, 1)), preprocess_u8=1))
            folded = cap.fold_bn
            del cap
            direct = Captioner(params, bn_state, cfg, vocab, device="gpu")
            ref = direct.caption_ids(request)
            del direct
            torch.cuda.empty_cache()
            if served[0].shape != (64, T) or not np.array_equal(served[0], ref):
                fail("%s: Captioner.from_checkpoint of the reference .ckpt gave ids equal to the directly built "
                     "Captioner's on %.4f of positions" % (variant, float((served[0] == ref).mean())))
            phase("main", "%s bf16 B=64, Captioner.from_checkpoint of a reference-format torch .ckpt (model.N.*, "
                  "unit.*, %.1f MB; fold_bn %s): launches %s, %.3f s (host clock); ids equal the Captioner built from "
                  "the same weights at all %d positions" % (variant, os.path.getsize(path) / 2**20, folded,
                                                           {k: v for k, v in counts.items() if v}, seconds, ref.size))
            os.remove(path)

    def fold_phase():
        """Phase 6 (b): the folded route (models/serving.FoldedEncoder, which phases 4-5 serve on the card) against
        the unfolded one, each FOLD_VARIANTS family, a request of 64: in f32 the features within FOLD_F32_RTOL of
        the largest and the served ids equal on >= 0.95 of positions; in bf16 the slice's three requests served by
        the unfolded route against the plain decode of its features (check_served), and the folded features
        within twice the unfolded route's error of the f32 features (ids printed against both routes); then the
        encoder alone from uint8 on the card, B = 1 and 64, bf16 and f32,
        the routes in turns by CUDA events (event_rounds, ab_verdict).  The rule, fixed before the first run:
        fold_bn_default() is on where the folded route wins at B=64 in bf16 for both families and the unfolded route
        wins in no cell."""
        wins = {}
        labels = {"folded": "folded (one biased cuDNN convolution a conv, epilogue relu / add + relu)",
                  "unfolded": "unfolded (convolution, eval BatchNorm, relu, add)"}
        for variant, Ed in FOLD_VARIANTS:
            kw = dict(nos_filters=AC, attn_dim=AA) if variant.startswith("attn") else {}
            cfg = CaptionerConfig(variant, 101, Ed, H, V, L, **kw)
            params, bn_state = init_captioner(cfg, torch.Generator().manual_seed(SEED))
            request = img_rng.randint(0, 256, (64, IMG, IMG, 3), dtype=np.uint8)
            x = torch.from_numpy(request).to(device)
            for dtype in ("float32", "bfloat16"):
                caps = {fold: Captioner(params, bn_state, cfg, vocab, dtype, device="gpu", fold_bn=fold)
                        for fold in (True, False)}
                with torch.inference_mode():
                    f = {fold: encode(c.model, x).float() for fold, c in caps.items()}
                ids = {fold: c.caption_ids(request) for fold, c in caps.items()}
                agree = float((ids[True] == ids[False]).mean())
                if dtype == "float32":
                    f32, ids32 = f[False], ids[False]
                    scale, gap = f32.abs().max().item(), (f[True] - f32).abs().max().item()
                    if gap > FOLD_F32_RTOL * scale or agree < 0.95:
                        fail("%s f32 B=64: the folded encoder's features differ from the unfolded one's by %.4g (bar "
                             "%g of their largest value %.4g); the served ids agree on %.4f of positions (bar 0.95)"
                             % (variant, gap, FOLD_F32_RTOL, scale, agree))
                    phase("main", "%s f32 B=64: the folded encoder's features within %.3g of the unfolded one's "
                          "(|features| <= %.4g, relative %.3g; bar %g); the folded route's served ids equal the "
                          "unfolded route's on %.4f of positions (>= 0.95)" % (variant, gap, scale, gap / scale,
                                                                               FOLD_F32_RTOL, agree))
                else:
                    # the unfolded route, which the card's serving bypasses (phases 4-5 serve the folded one),
                    # serves the slice's three requests, held to the plain decode of its own features by the
                    # serving criterion (check_served: >= 0.95 of positions)
                    sl = slices[variant]
                    counter = fused_gru_decode_step if variant == "gru" else fused_attn_decode_step
                    served, _, counts = serve(caps[False], sl["requests"], counters,
                                              dict(by_name(greedy_launches(counter, 3)), preprocess_u8=3))
                    check_served(variant + " unfolded", served, sl["requests"], caps[False])
                    phase("main", "%s unfolded bf16: launches in the three requests %s"
                          % (variant, {k: v for k, v in counts.items() if v}))
                    # bf16 rounds differently along each route, and a random-weight decode carries such differences
                    # into many tokens; so each bf16 route is held to the f32 route, the fold to within twice the
                    # unfolded route's feature error
                    err = {fold: (f[fold] - f32).abs().max().item() / scale for fold in f}
                    to_f32 = {fold: float((ids[fold] == ids32).mean()) for fold in ids}
                    if err[True] > 2 * err[False]:
                        fail("%s bf16 B=64: the folded encoder's features are %.3g from the f32 route's, relative, "
                             "more than twice the unfolded bf16 route's %.3g" % (variant, err[True], err[False]))
                    phase("main", "%s bf16 B=64: the folded encoder's features %.3g from the f32 route's, relative "
                          "(the unfolded bf16 route's %.3g; bar twice that); served ids: the folded route's equal the "
                          "unfolded route's on %.4f of positions, the f32 route's on %.4f (the unfolded route's on "
                          "%.4f)" % (variant, err[True], err[False], agree, to_f32[True], to_f32[False]))
                for B in (1, 64):
                    xb = x[:B].contiguous()

                    def run(c, xb=xb):
                        with torch.inference_mode():
                            return encode(c.model, xb)

                    ms = event_rounds({"folded": lambda: run(caps[True]), "unfolded": lambda: run(caps[False])})
                    wins[variant, dtype, B], text = ab_verdict(ms, labels, "encodes")
                    phase("times", "%s fold A/B %s %s B=%d, the encoder from uint8 on the card, CUDA events, %s"
                          % (card, variant, dtype, B, text))
                del caps
                torch.cuda.empty_cache()
        backed = (all(wins[v, "bfloat16", 64] == "folded" for v, _ in FOLD_VARIANTS)
                  and "unfolded" not in wins.values())
        phase("times", "%s fold A/B verdict: by its rule this run gives %s; fold_bn_default() = %s"
              % (card, "on" if backed else "off", fold_bn_default()))

    marks.append(("4 pooled", time.perf_counter()))
    # 4. pooled main paths
    slices = {}
    for variant, Ed, counter in (("gru", E, fused_gru_decode_step), ("lstm", LE, fused_lstm_decode_step)):
        slices[variant] = pooled_slice(variant, Ed, counter)

    marks.append(("5 attention", time.perf_counter()))
    # 5. attention main paths
    for variant, counter in (("attn", fused_attn_decode_step), ("attn_lstm", fused_attn_lstm_decode_step)):
        slices[variant] = attention_slice(variant, counter)
    marks.append(("5b CLI", time.perf_counter()))
    # 5b. the CLI path
    cli = cli_path(slices["gru"])
    # every kernel: its launches over all the main-path runs, each read just after it ran
    runs = [sl["beam_counts"] for sl in slices.values()] + [c for sl in slices.values() for c in sl["routes"].values()]
    runs += [slices[v]["comp_counts"] for v in ("attn", "attn_lstm")]
    runs += [c for sl in slices.values() for c in sl["other"].values()]
    runs += [sl["counts"] for sl in slices.values()] + [sl["s2d"]["counts"] for sl in slices.values()] + [cli["counts"]]
    launches = {fn.__name__: sum(counts[fn.__name__] for counts in runs) for fn in counters}

    marks.append(("6 times", time.perf_counter()))
    # 6. times (bf16, flagship widths)
    times = {}
    library = {}  # kernel -> ms of the one PyTorch call (or composite) that computes its function at the line's shape
    cold_ms = {}  # (kernel, B) -> ms with the operands cold in L2 (a 64 MB write between the spin and the call)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    note = "(median of 30 after 5, CUDA events, each call queued behind a 1 ms spin)"
    for name, cell, Ed, cuda_step, plain_step in (
            ("fused_gru_decode_step", "gru", E, fused_gru_decode_step_cuda, fused_gru_decode_step_plain),
            ("fused_lstm_decode_step", "lstm", LE, fused_lstm_decode_step_cuda, fused_lstm_decode_step_plain)):
        for B in (1, 64, 512):
            stacked, vocab_w, x, state = step_inputs(rng, B, torch.bfloat16, device, Ed, cell)
            times[name, B] = (event_median_ms(lambda: cuda_step(stacked, vocab_w, x, state)),
                              event_median_ms(lambda: plain_step(stacked, vocab_w, x, state)))
            # the tensor-core greedy steps, also with their operands cold in L2
            cold_ms[name, B] = event_median_ms(lambda: cuda_step(stacked, vocab_w, x, state), before=flush_buf.zero_)
    for B in (1, 64, 256):
        for name, cell in (("fused_attn_decode_step", "gru"), ("fused_attn_lstm_decode_step", "lstm")):
            prep, w_emb, state = attn_inputs(rng, B, torch.bfloat16, device, cell)
            times[name, B] = (event_median_ms(lambda: fused_attn_decode_step_cuda(prep, w_emb, state)),
                              event_median_ms(lambda: fused_attn_decode_step_plain(prep, w_emb, state)))
            cold_ms[name, B] = event_median_ms(lambda: fused_attn_decode_step_cuda(prep, w_emb, state),
                                               before=flush_buf.zero_)
        h = last_h(state)
        feats = uniform(rng, (B, AP, AC), 1.0, torch.bfloat16, device)
        times["attention_context", B] = (
            event_median_ms(lambda: attention_context_cuda(prep, feats, prep["att1"], h)),
            event_median_ms(lambda: attention_context_plain(prep, feats, prep["att1"], h)))
        # composite yardstick: cuBLAS's att2, the scores by leaky_relu and a matmul by w_full, softmax, bmm
        wdec, bdec, wfull = prep["wdec"], prep["bdec"], prep["wfull"]
        yard = lambda: torch.bmm(torch.softmax((F.leaky_relu(prep["att1"] + torch.addmm(bdec, h, wdec.T)[:, None, :],
                                                            0.2) @ wfull).float(), dim=1)[:, None, :].to(feats.dtype),
                                 feats)[:, 0]
        y_ms = event_median_ms(yard)
        y_err = (yard().float() - attention_context_plain(prep, feats, prep["att1"], h)[0].float()).abs().max().item()
        if B == 64:
            library["attention_context"] = y_ms
        phase("times", "%s attention_context bf16 B=%d: kernel %.4f ms, plain %.4f ms, bound %.4f ms (%s), composite "
              "yardstick %s %.4f ms (max_abs_err against the twin %.3g): kernel / yardstick %.3f %s"
              % (card, B, *times["attention_context", B], *bound("attention_context", B),
                 LIBRARY_CALLS["attention_context"], y_ms, y_err, times["attention_context", B][0] / y_ms, note))
    # the beam kernels at R = 3 (B=1) and R = 192 (B=64), K = 3.  The dense steps also with their operands cold in
    # L2 (a 64 MB write between the spin and the call); at R = 192 the pooled ones beside the stack step (kNone,
    # the recurrence alone on the same tensor-core layers, at R = 192 with no K split: dense minus stack is the
    # vocab phase and its grid barrier) and beside their composite yardstick: one torch.nn.GRU / LSTM step and
    # one cuBLAS addmm for the logits, the module built outside the timed call
    for R in (3, 192):
        for cell, Ed in (("gru", E), ("lstm", LE)):
            name = "fused_%s_dense_step" % cell
            stacked, vocab_w, x, state = step_inputs(rng, R, torch.bfloat16, device, Ed, cell)
            dense = lambda: fused_dense_step_cuda(stacked, vocab_w, x, state)
            times[name, R] = (event_median_ms(dense),
                              event_median_ms(lambda: fused_dense_step_plain(stacked, vocab_w, x, state)))
            cold = event_median_ms(dense, before=flush_buf.zero_)
            topk_name = "fused_%s_topk_step" % cell
            topk = lambda: fused_topk_step_cuda(stacked, vocab_w, x, state, K_BEAM)
            times[topk_name, R] = (event_median_ms(topk),
                                   event_median_ms(lambda: fused_topk_step_plain(stacked, vocab_w, x, state, K_BEAM)))
            topk_cold = event_median_ms(topk, before=flush_buf.zero_)
            split, topk_split = "", ""
            if R == 192:
                stack_cuda = lstm_stack_step_cuda if cell == "lstm" else gru_stack_step_cuda
                stack_ms = event_median_ms(lambda: stack_cuda(stacked, x, state))
                rnn = library_rnn(cell, stacked, Ed)
                hx = tuple(state) if cell == "lstm" else state
                wv, bv = vocab_w["w"], vocab_w["b"]
                with torch.inference_mode():
                    yard_err = (torch.addmm(bv, rnn(x[None], hx)[0][0], wv.T).float() - dense()[0]).abs().max().item()
                    library[name] = event_median_ms(lambda: torch.addmm(bv, rnn(x[None], hx)[0][0], wv.T).float(),
                                                    spin=LIBRARY_SPIN_CYCLES)
                split = ("; stack step (kNone: the tensor-core recurrence alone) %.4f ms, dense minus stack %.4f ms; "
                         "composite yardstick %s %.4f ms (10 ms spin; its logits within %.3g of the kernel's): "
                         "kernel / yardstick %.3f"
                         % (stack_ms, times[name, R][0] - stack_ms, LIBRARY_CALLS[name], library[name], yard_err,
                            times[name, R][0] / library[name]))
                with torch.inference_mode():
                    yard = lambda: torch.addmm(bv, rnn(x[None], hx)[0][0], wv.T).float().log_softmax(dim=-1).topk(
                        K_BEAM, dim=-1)
                    yard_err = (yard().values - topk()[0][0]).abs().max().item()
                    library[topk_name] = event_median_ms(yard, spin=LIBRARY_SPIN_CYCLES)
                topk_split = ("; composite yardstick %s %.4f ms (10 ms spin; its logp within %.3g of the kernel's): "
                              "kernel / yardstick %.3f; kernel / dense step %.3f"
                              % (LIBRARY_CALLS[topk_name], library[topk_name], yard_err,
                                 times[topk_name, R][0] / library[topk_name],
                                 times[topk_name, R][0] / times[name, R][0]))
            phase("times", "%s bf16 %s R=%d: kernel %.4f ms, L2 cold %.4f ms%s %s"
                  % (card, name, R, times[name, R][0], cold, split, note))
            phase("times", "%s bf16 %s R=%d: kernel %.4f ms, L2 cold %.4f ms%s %s"
                  % (card, topk_name, R, times[topk_name, R][0], topk_cold, topk_split, note))
        for name, cell in (("fused_attn_dense_step", "gru"), ("fused_attn_lstm_dense_step", "lstm")):
            prep, w_emb, state = attn_inputs(rng, R, torch.bfloat16, device, cell)
            dense = lambda: fused_attn_dense_step_cuda(prep, w_emb, state)
            times[name, R] = (event_median_ms(dense),
                              event_median_ms(lambda: fused_attn_dense_step_plain(prep, w_emb, state)))
            phase("times", "%s bf16 %s R=%d: kernel %.4f ms, L2 cold %.4f ms %s"
                  % (card, name, R, times[name, R][0], event_median_ms(dense, before=flush_buf.zero_), note))
    # the sharded-projection route's stack steps, and the whole decode (T=25 steps in one call)
    whole_rows = {}  # B -> the distinct embedding rows the timed whole decode fed back (its bound's bytes)
    for B in (1, 64, 512):
        for name, cell, Ed, cuda_step, plain_step in (("gru_stack_step", "gru", E, gru_stack_step_cuda, gru_stack_plain),
                                                      ("lstm_stack_step", "lstm", LE, lstm_stack_step_cuda,
                                                       lstm_stack_plain)):
            stacked, _, x, state = step_inputs(rng, B, torch.bfloat16, device, Ed, cell)
            times[name, B] = (event_median_ms(lambda: cuda_step(stacked, x, state)),
                              event_median_ms(lambda: plain_step(stacked, x, state)))
            cold_ms[name, B] = event_median_ms(lambda: cuda_step(stacked, x, state), before=flush_buf.zero_)
            # every K split the rule may take, L2 warm and cold, beside the one it takes (stack_tiles)
            by_split = {S: (event_median_ms(lambda: cuda_step(stacked, x, state, splits=S)),
                            event_median_ms(lambda: cuda_step(stacked, x, state, splits=S), before=flush_buf.zero_))
                        for S in range(1, MAX_SPLITS + 1)}
            rule = stack_tiles(B, Ed, H, sm_count(device)).splits
            best = min(by_split, key=lambda S: by_split[S][0])
            phase("times", "%s bf16 %s B=%d K split: %s; the rule takes S = %d (layer 0), %d (above): %.4f ms; fastest "
                  "warm S = %d, %.4f ms %s"
                  % (card, name, B, ", ".join("S=%d %.4f ms (cold %.4f)" % (S, *ms) for S, ms in by_split.items()),
                     *rule, times[name, B][0], best, by_split[best][0], note))
            # the library's call: the whole L-layer step as one multi-layer torch.nn.GRU / LSTM call (cuDNN
            # where it takes bf16), held to the kernel's new state first
            rnn = library_rnn(cell, stacked, Ed)
            hx = tuple(state) if cell == "lstm" else state
            with torch.inference_mode():
                _, lib_state = rnn(x[None], hx)
                err = check_state("%s B=%d library call (torch.nn.%s)" % (name, B, cell.upper()), lib_state,
                                  cuda_step(stacked, x, state)[1], torch.bfloat16)
                lib_ms = event_median_ms(lambda: rnn(x[None], hx), spin=LIBRARY_SPIN_CYCLES)
            if B == 64:
                library[name] = lib_ms
            phase("times", "%s bf16 %s B=%d: library call torch.nn.%s(%d, %d, num_layers=%d) %.4f ms (cuDNN %s; "
                  "its state within %.3g of the kernel's) %s"
                  % (card, name, B, cell.upper(), Ed, H, L, lib_ms,
                     "accepts bf16" if torch.backends.cudnn.is_acceptable(x) else "refuses bf16: PyTorch's own RNN",
                     err, note.replace("1 ms spin", "10 ms spin")))
        prepared, feats = whole_inputs(rng, B, torch.bfloat16, device)
        toks = gru_whole_greedy_decode_cuda(prepared, feats, T)
        whole_rows[B] = int(torch.unique(toks[:, :-1]).numel())
        times["gru_whole_greedy_decode", B] = (
            event_median_ms(lambda: gru_whole_greedy_decode_cuda(prepared, feats, T), iters=10, warmup=2),
            event_median_ms(lambda: gru_whole_greedy_decode_plain(prepared, feats, T), iters=5, warmup=1))
    for (name, B), (k_ms, p_ms) in times.items():
        phase("times", "%s bf16 %s %s=%d: kernel %.4f ms%s, plain %.4f ms, bound %.4f ms (%s) %s"
              % (card, name, "R" if name in BEAM_KERNELS else "B", B, k_ms,
                 " (L2 cold %.4f ms)" % cold_ms[name, B] if (name, B) in cold_ms else "", p_ms,
                 *bound(name, B, whole_rows.get(B, 0)), note))
    # the projection kernels at B = 1, 64, 256 and R = 3, 192, 320, each against its twin, its bound and its
    # composite yardstick (cuBLAS's bf16 product and torch's reductions) on the same operands; with the weights
    # warm in L2, as the earlier PRs timed them, and cold (a 64 MB write between the spin and the call)
    vocab_t = vocab_inputs(rng, H, torch.bfloat16, device)
    w, b = vocab_t["w"], vocab_t["b"]
    projections = (
        ("project_argmax", (1, 64, 256), lambda h: project_argmax_cuda(vocab_t, h),
         lambda h: project_argmax_plain(vocab_t, h), lambda h: torch.addmm(b, h, w.T).argmax(dim=-1)),
        ("project_topk", (3, 192, 320), lambda h: project_topk_cuda(vocab_t, h, K_BEAM),
         lambda h: project_topk_plain(vocab_t, h, K_BEAM),
         lambda h: torch.addmm(b, h, w.T).float().log_softmax(dim=-1).topk(K_BEAM, dim=-1)))
    for name, shapes, kernel_fn, plain_fn, yard_fn in projections:
        for rows in shapes:
            h = uniform(rng, (rows, H), 1.0, torch.bfloat16, device)
            k_ms, p_ms, y_ms = (event_median_ms(lambda: fn(h)) for fn in (kernel_fn, plain_fn, yard_fn))
            k_cold, y_cold = (event_median_ms(lambda: fn(h), before=flush_buf.zero_) for fn in (kernel_fn, yard_fn))
            times[name, rows] = (k_ms, p_ms)
            if rows in (64, 192):
                library[name] = y_ms
            phase("times", "%s bf16 %s %s=%d: kernel %.4f ms, plain %.4f ms, bound %.4f ms (%s), composite yardstick "
                  "%s %.4f ms: kernel / yardstick %.3f; L2 cold: kernel %.4f ms, yardstick %.4f ms, %.3f %s"
                  % (card, name, "R" if name in BEAM_KERNELS else "B", rows, k_ms, p_ms, *bound(name, rows),
                     LIBRARY_CALLS[name], y_ms, k_ms / y_ms, k_cold, y_cold, k_cold / y_cold, note))
    # the A/B behind whole_decode_default(): host clock around whole decodes (the user's wait), in turns,
    # by ab_verdict's rule
    wins = {}  # (dtype name, B) -> "whole", "loop" or None
    for dtype in (torch.bfloat16, torch.float32):
        dn = dname(dtype)
        for B in (1, 64, 512):
            prepared, feats = whole_inputs(rng, B, dtype, device)
            ms = ab_rounds({route: lambda w=(route == "whole"): greedy_decode_kernel(prepared, feats, T, whole_decode=w)
                            for route in ("whole", "loop")})
            wins[dn, B], text = ab_verdict(ms, {"whole": "whole-decode kernel",
                                                "loop": "per-step loop (25 fused steps + index_select)"})
            phase("times", "%s A/B %s B=%d T=%d, host clock a decode, %s" % (card, dn, B, T, text))
        code = dtype_code("grid barriers", dtype)

        def barriers():
            raise_on_error("grid barriers", probe.st_grid_barriers(code, L, 64, E, H, BARRIERS, stream_arg(device)))

        per_us = 1e3 * event_median_ms(barriers, iters=10, warmup=2) / BARRIERS
        phase("times", "%s %s grid barrier at the whole-decode kernel's grid: %.3f us each (%d in one launch); a T=25 "
              "decode crosses %d, %.4f ms; the B=64 bf16 whole decode takes %.4f ms"
              % (card, dn, per_us, BARRIERS, T * (L + 2) - 1, per_us * (T * (L + 2) - 1) / 1e3,
                 times["gru_whole_greedy_decode", 64][0]))
    # whole_decode_default() is on where the whole decode wins at B=64 bf16 and the loop wins at no B in bf16
    backed = wins["bfloat16", 64] == "whole" and all(wins["bfloat16", B] != "loop" for B in (1, 64, 512))
    phase("times", "%s A/B verdict: this run %s whole_decode_default() = %s"
          % (card, "backs" if backed == whole_default else "does not back", whole_default))
    for variant, what in (("gru", "pooled-GRU slice, bf16, ResNet-101"),
                          ("lstm", "pooled-LSTM slice, bf16, ResNet-101"),
                          ("attn", "attention-GRU slice, bf16, spatial ResNet-101"),
                          ("attn_lstm", "attention-LSTM slice, bf16, spatial ResNet-101")):
        sl = slices[variant]
        phase("times", "%s %s + 25 greedy steps: %.1f captions/s at B=64 (3 requests, %.3f s, host clock to ids on "
              "the host)" % (card, what, 3 * 64 / sl["seconds"], sl["seconds"]))
        phase("times", "%s %s + beam search, K=3: %.1f captions/s at B=64 (3 requests, %.3f s, host clock to ids on "
              "the host); bf16 ids equal the plain beam decode on >= %.4f of positions"
              % (card, what, 3 * 64 / sl["beam_seconds"], sl["beam_seconds"], sl["beam_share"]))
    # greedy captions/s at B=64 over more requests than the three above, the families in turns
    rates = greedy_rates({v: (sl["cap"], sl["requests"]) for v, sl in slices.items()}, RATE_ROUNDS)
    for variant, per_s in rates.items():
        phase("times", "%s %s + 25 greedy steps, bf16, B=64: %.1f captions/s, median [min, max] [%.1f, %.1f] of %d "
              "requests, each timed alone on the host clock to ids on the host, %d rounds of three with the families "
              "in turns" % (card, variant, statistics.median(per_s), min(per_s), max(per_s), len(per_s), RATE_ROUNDS))
    # the pooled GRU's beam routes on one request's features, in turns
    gru = slices["gru"]
    routes = {"dense": dict(fused_step="dense"), "top-k": dict(fused_step="topk"),
              "sparse composite": dict(fused_step=None, sparse=True)}
    route_s = {route: [] for route in routes}
    with torch.inference_mode():
        for order in [list(routes), list(routes)[::-1]] * 2 + [list(routes)]:
            for route in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                beam_search_decode(gru["cap"].prepared, gru["cap"].cfg.decoder_config(), gru["feats"], K_BEAM, END,
                                   PAD, **routes[route])
                torch.cuda.synchronize()
                route_s[route].append(time.perf_counter() - t0)
    phase("times", "%s pooled-GRU beam decode, B=64, K=3, 25 steps (host clock, median [min, max] of 5 in turns): %s"
          % (card, ", ".join("%s %.3f ms [%.3f, %.3f]" % (r, 1e3 * statistics.median(v), 1e3 * min(v), 1e3 * max(v))
                             for r, v in route_s.items())))
    # the A/B behind beam_step_default(): host clock around whole pooled beam decodes (K=3, bf16, ids on the host),
    # the dense and the top-k route in turns, by ab_verdict's rule; the features of a request (four times for B=256)
    beam_wins = {}  # (variant, B) -> "dense", "topk" or None
    with torch.inference_mode():
        for variant in ("gru", "lstm"):
            sl = slices[variant]
            dcfg = sl["cap"].cfg.decoder_config()
            for Bq in (1, 64, 256):
                fb = torch.cat([sl["feats"]] * 4)[:Bq].contiguous()
                ms = ab_rounds({route: lambda r=route: beam_search_decode(
                    sl["cap"].prepared, dcfg, fb, K_BEAM, END, PAD, fused_step=r).cpu() for route in ("dense", "topk")})
                beam_wins[variant, Bq], text = ab_verdict(ms, {"dense": "dense route", "topk": "top-k route"})
                phase("times", "%s beam A/B pooled %s bf16 B=%d K=%d T=%d, host clock a decode to ids on the host, %s"
                      % (card, variant, Bq, K_BEAM, T, text))
    # top-k is the default where it wins at B=64 and dense wins at neither B=1 nor B=256, for both families
    topk_backed = all(beam_wins[v, 64] == "topk" and "dense" not in (beam_wins[v, 1], beam_wins[v, 256])
                      for v in ("gru", "lstm"))
    phase("times", "%s beam A/B verdict: by its rule this run gives %s; beam_step_default() = %s"
          % (card, "topk" if topk_backed else "dense", beam_default))
    # what is not the step kernel: step 0, log_softmax, the K x V sort, gathers, launches and wrapper checks
    one = []
    with torch.inference_mode():
        feats1 = gru["feats"][:1].contiguous()
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            beam_search_decode(gru["cap"].prepared, gru["cap"].cfg.decoder_config(), feats1, K_BEAM, END, PAD)
            torch.cuda.synchronize()
            one.append(time.perf_counter() - t0)
    attn_ms = []
    with torch.inference_mode():
        for rep in range(6):  # one warm-up, then 5 timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            slices["attn"]["beam_decode"]()
            torch.cuda.synchronize()
            if rep:
                attn_ms.append(1e3 * (time.perf_counter() - t0))
    phase("times", "%s attention-GRU dense beam decode, B=64, K=3, 25 steps (host clock, median [min, max] of 5): "
          "%.3f ms [%.3f, %.3f], of which the 24 step kernels %.3f ms (kernel time at R=192)"
          % (card, statistics.median(attn_ms), min(attn_ms), max(attn_ms),
             (T - 1) * times["fused_attn_dense_step", 192][0]))
    for Bq, decode_ms in ((1, 1e3 * statistics.median(one)), (64, 1e3 * statistics.median(route_s["dense"]))):
        kernel_ms = (T - 1) * times["fused_gru_dense_step", Bq * K_BEAM][0]
        phase("times", "%s pooled-GRU dense beam decode, B=%d, K=3: %.3f ms a decode (host clock), of which the 24 "
              "step kernels %.3f ms (kernel time at R=%d); the rest, %.1f us a step, is step 0 and the torch and host "
              "work around the kernel" % (card, Bq, decode_ms, kernel_ms, Bq * K_BEAM,
                                          1e3 * (decode_ms - kernel_ms) / (T - 1)))

    # the input kernels at the serving shape (B=64, bf16), their twins and yardsticks, and request stages
    x3 = u8_images(rng, (64, IMG, IMG, 3), device)
    x12 = space_to_depth(x3).contiguous()
    bf16 = torch.bfloat16
    times["preprocess_images", 64] = (event_median_ms(lambda: preprocess_u8_cuda(x3, bf16)),
                                      event_median_ms(lambda: preprocess_u8_plain(x3, bf16)))
    pre12 = (event_median_ms(lambda: preprocess_u8_cuda(x12, bf16)), event_median_ms(lambda: preprocess_u8_plain(x12, bf16)))
    scap = slices["gru"]["s2d"]["cap"]
    enc = scap.model.encoder
    res = enc.resnet
    sprep = enc.stem_operands()  # the flagship's folded conv1 and bn1, bf16
    # the served layout: RGB as decoded, which the kernel reads through index math; at B=64 and B=1
    x1 = x3[:1].contiguous()
    for B, xb in ((64, x3), (1, x1)):
        times["stem_fused", B] = (event_median_ms(lambda: stem_fused_cuda(xb, sprep)),
                                  event_median_ms(lambda: stem_fused_plain(xb, sprep)))
    stem12 = (event_median_ms(lambda: stem_fused_cuda(x12, sprep)), event_median_ms(lambda: stem_fused_plain(x12, sprep)))
    stem_conv = event_median_ms(lambda: stem_fused_cuda(x3, sprep, pool=False))  # 4 conv rows a CTA, no recomputed row
    with torch.inference_mode():
        w4 = transform_conv1_weight(res.conv1.weight.float())
        if isinstance(enc, FoldedEncoder):  # the served encoder's conv1 carries bn1 already
            b4 = res.conv1.bias.float()
        else:
            mult = res.bn1.weight.float() * torch.rsqrt(res.bn1.running_var.float() + 1e-5)
            w4, b4 = w4 * mult[:, None, None, None], res.bn1.bias.float() - res.bn1.running_mean.float() * mult
        w4f, b4f = w4.to(bf16).contiguous(memory_format=torch.channels_last), b4.to(bf16)
        xn12 = preprocess_u8_cuda(x12, bf16).permute(0, 3, 1, 2)
        xn3 = preprocess_u8_cuda(x3, bf16).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        # yardstick: cuDNN's 4x4 conv with the BN-folded weight and bias on the normalized s2d input, relu, pool
        library["stem_fused"] = event_median_ms(
            lambda: F.max_pool2d(F.relu(F.conv2d(F.pad(xn12, S2D_PAD), w4f, b4f)), 3, 2, 1))
        stem_yard1 = event_median_ms(lambda: F.max_pool2d(F.relu(F.conv2d(F.pad(xn12[:1], S2D_PAD), w4f, b4f)),
                                                          3, 2, 1))
        # the encoder's own stem routes (Encoder.stem_u8), each to the post-maxpool activation
        stem_y = enc.stem_u8(x3, s2d=True)
        bn = " (BN folded into conv1)" if isinstance(enc, FoldedEncoder) else " + BN"
        stages = {
            "stock stem (preprocess kernel + 7x7 conv1%s + relu + pool)" % bn: event_median_ms(lambda: enc.stem_u8(x3)),
            "s2d stem, conv route from [64,112,112,12] (preprocess kernel + 4x4 conv1%s + relu + pool)" % bn:
                event_median_ms(lambda: enc.stem_u8(x12, s2d=True, stem="conv")),
            "s2d stem, fused route from RGB (the served route: stem kernel)":
                event_median_ms(lambda: enc.stem_u8(x3, s2d=True)),
            "layer1-4 + pooled head from the stem's output": event_median_ms(
                lambda: enc.head(res.forward_from_stem(stem_y))),
            "stock encoder from normalized images (conv1 to head)": event_median_ms(
                lambda: slices["gru"]["cap"].model.encoder(xn3.permute(0, 2, 3, 1))),
        }
    pinned = torch.from_numpy(slices["gru"]["requests"][0]).pin_memory()
    h2d = event_median_ms(lambda: pinned.to(device, non_blocking=True))
    for name in ("preprocess_images", "stem_fused"):
        k_ms, p_ms = times[name, 64]
        phase("times", "%s bf16 %s B=64: kernel %.4f ms, plain %.4f ms, bound %.4f ms (%s), yardstick %s %s"
              % (card, name, k_ms, p_ms, *bound(name, 64),
                 "%.4f ms" % library[name] if name in library else "none", note))
    phase("times", "%s bf16 preprocess B=64, s2d layout [64,112,112,12]: kernel %.4f ms, plain %.4f ms %s"
          % (card, pre12[0], pre12[1], note))
    phase("times", "%s bf16 stem_fused B=64, s2d layout [64,112,112,12]: kernel %.4f ms, plain %.4f ms %s; RGB "
          "without the pool ([64,112,112,64] out) %.4f ms" % (card, stem12[0], stem12[1], note, stem_conv))
    phase("times", "%s bf16 stem_fused B=1 (RGB, pooled): kernel %.4f ms, plain %.4f ms, bound %.4f ms (%s), "
          "yardstick %s %.4f ms %s" % (card, *times["stem_fused", 1], *bound("stem_fused", 1),
                                       LIBRARY_CALLS["stem_fused"], stem_yard1, note))
    phase("times", "%s stock request stages, pooled GRU, bf16, B=64: host-to-device copy of the uint8 batch from "
          "pinned memory %.4f ms (not part of the preprocess stage); preprocess stage before (plain chain) %.4f ms, "
          "after (kernel) %.4f ms %s" % (card, h2d, times["preprocess_images", 64][1],
                                          times["preprocess_images", 64][0], note))
    for stage, ms in stages.items():
        phase("times", "%s request stage, pooled GRU, bf16, B=64, %s: %s %.4f ms %s"
              % (card, type(enc).__name__, stage, ms, note))
    for variant in ("gru", "lstm", "attn", "attn_lstm"):
        sl = slices[variant]
        phase("times", "%s %s s2d slice, bf16, ResNet-101 + 25 greedy steps: %.1f captions/s at B=64 (3 requests, "
              "%.3f s), stock slice %.1f captions/s in the same run (host clock to ids on the host); s2d bf16 ids "
              "equal the plain decode from the served stem on >= %.4f of positions" % (card, variant, 3 * 64 / sl["s2d"]["seconds"],
                                                                   sl["s2d"]["seconds"], 3 * 64 / sl["seconds"],
                                                                   sl["s2d"]["share"]))
    decoder = fastimage.status().split(" ")[0]  # native or PIL
    phase("times", "%s caption_paths, %d COCO-size JPEGs, s2d pooled GRU bf16, B=64: overlapped %.3f s, serial %.3f "
          "s (host clock, %s decode included)" % (card, N_FILES, cli["overlap_s"], cli["serial_s"], decoder))
    spread = lambda xs: "%.4f s [%.4f, %.4f]" % (statistics.median(xs), min(xs), max(xs))
    phase("times", "%s caption_paths in turns, %d COCO-size JPEGs, B=64, host clock, median [min, max] of %d: decoded "
          "(%s) overlapped %s, serial %s; from the cache overlapped %s, serial %s; one file decoded (a batch of 1) %s; "
          "one batch of 64 alone: %s" % (
              card, N_FILES, CLI_TURNS, decoder, spread(cli["runs"][False, True]), spread(cli["runs"][False, False]),
              spread(cli["runs"][True, True]), spread(cli["runs"][True, False]), spread(cli["runs"]["one file"]),
              ", ".join("%s %s" % (k, spread(v)) for k, v in cli["parts"].items())))

    marks.append(("6 (a), (b)", time.perf_counter()))
    # 6 (a), (b): the reference .ckpt served, and the folded encoder against the unfolded one
    import tempfile

    ckpt_tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        reference_ckpt_phase(ckpt_tmp)
    finally:
        import shutil

        shutil.rmtree(ckpt_tmp, ignore_errors=True)
    fold_phase()

    marks.append(("7-8 train, eval", time.perf_counter()))
    # 7. training, then 8. eval on its checkpoints; phase 8's runs are the eval path's share of every launch count
    for counts in training_phase():
        for name, n in counts.items():
            launches[name] += n
    marks.append(("9 mesh", time.perf_counter()))
    # 9. serving over a dp x mp mesh; its requests' launches join the counts
    for name, n in mesh_phase(card).items():
        launches[name] += n
    marks.append(("10 learn", time.perf_counter()))
    # 10. the port learns the demonstration task; its runs' launches join the counts
    for name, n in learn_phase(card, counters).items():
        launches[name] += n

    marks.append(("end", time.perf_counter()))
    phase("time", "seconds by phase (host clock): %s; %.1f s in all" % (
        ", ".join("%s %.1f" % (name, t1 - t0) for (name, t0), (_, t1) in zip(marks, marks[1:])),
        marks[-1][1] - marks[0][1]))
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "show_tell_tpu"))
    if leaked:
        fail("the port's path imported %s" % leaked[:5])

    print(smi, flush=True)
    kernels = []
    for name, src, replaces in KERNEL_ROWS:
        rows = 192 if name in BEAM_KERNELS else 64  # the slice's serving shape: B=64, K=3 beam rows
        bound_ms, bound_by = bound(name, rows, whole_rows.get(rows, 0))
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "show_tell_tpu_torch/csrc/" + src,
            "replaces": replaces,
            "launches": launches[COUNTER_OF.get(name, name)],
            "max_abs_err": errs[name],
            "ms": times[name, rows][0],
            "plain_ms": times[name, rows][1],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            # the stack steps: one torch.nn.GRU / LSTM call; the stem: its cuDNN yardstick; the projections: their
            # composite yardsticks; the rest: no single call
            "library_ms": library.get(name),
            "library_call": LIBRARY_CALLS.get(name),
            "rows": rows,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
