"""The learning demonstration on the PyTorch port: a synthetic grounded
dataset, trained and scored through the port's CLI, then captioned on
unseen images.

The dataset is COCO-format: images of one coloured shape on a dark or light
background, each with two captions that name what is visible ("a red circle
on a dark background."), or with --compositional two shapes and their
left/right relation.  ``build_dataset`` writes, for a seed, the same JPEG
bytes and the same annotation JSON as the JAX package's
tools/demo_synthetic.py (the drawing code is copied; PIL and numpy only).
The model trains and tests through ``show_tell_tpu_torch.cli.run.run`` with
that tool's argv (ResNet-18, E=64, H=128, L=1, Adam 0.002, B=32, no eval
flips), then ``serve.Captioner`` captions 16 images drawn at seed 999, which
training never saw, in f32, and the captions' colour and shape words are
counted against what was drawn.

    python tools/demo_synthetic_torch.py [--images 400] [--epochs 12] [--variant gru|lstm|attn|attn_lstm]
        [--next_token] [--compositional] [--device gpu|cpu] [--dp N] [--out scores.json]

It runs on the CUDA card unless ``--device cpu`` is given; ``--dp N``
trains and tests over N processes, one a card, at the same global batch.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Sequence, Tuple

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
from PIL import Image, ImageDraw

COLORS = {
    "red": (220, 40, 40),
    "green": (40, 200, 60),
    "blue": (50, 80, 230),
    "yellow": (230, 220, 50),
    "purple": (160, 60, 200),
    "orange": (240, 150, 40),
}
SHAPES = ["circle", "square", "triangle"]
BACKGROUNDS = {"dark": (25, 25, 30), "light": (235, 235, 225)}

TEMPLATES = [
    "a {color} {shape} on a {bg} background.",
    "there is a {color} {shape} here.",
    "the image shows a {color} {shape}.",
]

PROBE_SEED = 999  # the unseen images' generator; training draws from seed 0
ANN_PATH = "annotations/captions_train2014.json"
IMG_DIR = "train2014"
WIDTHS = {"resnet_version": 18, "embed_dim": 64, "hidden_dim": 128, "num_layers": 1, "nos_filters": 512,
          "attn_dim": 64}


def _draw_shape(d, shape, box, c):
    if shape == "circle":
        d.ellipse(box, fill=c)
    elif shape == "square":
        d.rectangle(box, fill=c)
    else:
        x0, y0, x1, y1 = box
        d.polygon([((x0 + x1) // 2, y0), (x0, y1), (x1, y1)], fill=c)


def draw_sample(rng, size=224):
    """One shape, centred, on a plain background: (image, colour, shape, background)."""
    color = rng.choice(list(COLORS))
    shape = rng.choice(SHAPES)
    bg = rng.choice(list(BACKGROUNDS))
    img = Image.new("RGB", (size, size), BACKGROUNDS[bg])
    d = ImageDraw.Draw(img)
    m, M = size // 5, 4 * size // 5
    _draw_shape(d, shape, [m, m, M, M], COLORS[color])
    return img, color, shape, bg


def draw_compositional(rng, size=224):
    """Two objects with a left/right relation: pooled features cannot say
    which side each object is on; spatial attention can."""
    (c1, s1), (c2, s2) = rng.sample([(c, s) for c in COLORS for s in SHAPES], 2)
    bg = rng.choice(list(BACKGROUNDS))
    img = Image.new("RGB", (size, size), BACKGROUNDS[bg])
    d = ImageDraw.Draw(img)
    q, h = size // 4, size // 2
    _draw_shape(d, s1, [q - 40, h - 40, q + 40, h + 40], COLORS[c1])  # left
    _draw_shape(d, s2, [3 * q - 40, h - 40, 3 * q + 40, h + 40], COLORS[c2])  # right
    caption = "a %s %s left of a %s %s." % (c1, s1, c2, s2)
    return img, caption, (c1, s1, c2, s2)


def build_dataset(root, n_images, seed=0, compositional=False):
    """``n_images`` JPEGs (quality 92) under root/train2014 and their
    captions in root/annotations/captions_train2014.json."""
    rng = random.Random(seed)
    img_dir = os.path.join(root, IMG_DIR)
    ann_dir = os.path.join(root, "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    images, anns = [], []
    ann_id = 1
    for img_id in range(1, n_images + 1):
        fname = "COCO_train2014_%012d.jpg" % img_id
        if compositional:
            img, caption, _ = draw_compositional(rng)
            captions = [caption, caption.replace("a ", "one ", 1)]
        else:
            img, color, shape, bg = draw_sample(rng)
            captions = [tpl.format(color=color, shape=shape, bg=bg) for tpl in rng.sample(TEMPLATES, 2)]
        img.save(os.path.join(img_dir, fname), quality=92)
        images.append({"id": img_id, "file_name": fname})
        for cap in captions:
            anns.append({"id": ann_id, "image_id": img_id, "caption": cap})
            ann_id += 1
    with open(os.path.join(ann_dir, "captions_train2014.json"), "w") as f:
        json.dump({"images": images, "annotations": anns}, f)


def cli_argv(variant: str, data_root: str, out_dir: str, epochs: int, next_token: bool = False,
             extra: Sequence[str] = ()) -> List[str]:
    """The CLI's argv for the demo, as tools/demo_synthetic.py gives it; ``extra`` goes last."""
    argv = []
    if variant.startswith("attn"):
        argv = ["--nos_cnn_filters", "512", "--attn_dim", "64", "--alpha_c", "0.1"]
        if next_token:
            argv += ["--attn_next_token", "1"]
    return argv + [
        "--data_dir", data_root, "--output_dir", out_dir,
        "--train_ann_path", ANN_PATH, "--test_ann_path", ANN_PATH,
        "--train_img_dir", IMG_DIR, "--test_img_dir", IMG_DIR,
        "--vocab_threshold", "1", "--embedding_length", "64",
        "--num_hidden_units", "128", "--num_layers", "1",
        "--batch_size", "32", "--num_epochs", str(epochs),
        "--resnet_version", "18", "--lr", "0.002", "--optimizer_type", "Adam",
        "--is_training", "1", "--is_testing", "1",
        "--load_model_test", "model_%d" % epochs,
        "--eval_augment", "0", "--keep_checkpoints", "1",
    ] + list(extra)


def probe_images(n: int = 16, seed: int = PROBE_SEED) -> Tuple[np.ndarray, List[Tuple[str, str]]]:
    """``n`` unseen images [n, 224, 224, 3] uint8 and their (colour, shape)."""
    rng = random.Random(seed)
    imgs, truths = [], []
    for _ in range(n):
        img, color, shape, _ = draw_sample(rng)
        imgs.append(np.asarray(img, dtype=np.uint8))
        truths.append((color, shape))
    return np.stack(imgs), truths


def attribute_hits(truths: Sequence[Tuple[str, str]], captions: Sequence[str]) -> Tuple[int, int]:
    """(captions naming the drawn colour, captions naming the drawn shape), by substring as the JAX tool counts."""
    return (sum(color in cap for (color, _), cap in zip(truths, captions)),
            sum(shape in cap for (_, shape), cap in zip(truths, captions)))


def probe(out_dir: str, epochs: int, variant: str, device: str) -> Dict[str, object]:
    """The trained checkpoint captions the 16 unseen images in f32: their captions and attribute hits."""
    from show_tell_tpu_torch.serve import Captioner

    cap = Captioner.from_checkpoint(
        os.path.join(out_dir, "model_%d.ckpt" % epochs), os.path.join(out_dir, "vocab.pkl"), variant=variant,
        compute_dtype="float32", device=device, **WIDTHS)
    imgs, truths = probe_images(16)
    captions = cap.caption(imgs)
    color, shape = attribute_hits(truths, captions)
    return {"captions": captions, "color": color, "shape": shape}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--images", type=int, default=400)
    parser.add_argument("--epochs", type=int, default=12)
    parser.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "shape_demo_torch"))
    parser.add_argument("--variant", default="gru", choices=["gru", "lstm", "attn", "attn_lstm"])
    parser.add_argument("--next_token", action="store_true", help="corrected attention alignment (--attn_next_token)")
    parser.add_argument("--compositional", action="store_true", help="two-object left/right task (pooling-breaking)")
    parser.add_argument("--device", default="gpu", choices=["gpu", "cpu"])
    parser.add_argument("--dp", type=int, default=0, help="train and test over this many processes, one a card")
    parser.add_argument("--train_dtype", default="float32", choices=["float32", "bfloat16"])
    parser.add_argument("--out", default="", help="optional JSON output path: scores and the probe's counts")
    args = parser.parse_args(argv)

    from show_tell_tpu_torch.cli.run import run
    from show_tell_tpu_torch.vocab import tokenizer_name

    shutil.rmtree(args.root, ignore_errors=True)
    data_root = os.path.join(args.root, "data")
    out_dir = os.path.join(args.root, "out")
    build_dataset(data_root, args.images, compositional=args.compositional)
    os.makedirs(out_dir, exist_ok=True)
    print("tokenizer:", tokenizer_name())
    extra = ["--train_dtype", args.train_dtype] + (["--dp", str(args.dp)] if args.dp > 1 else [])
    t0 = time.perf_counter()
    res = run(args.variant, cli_argv(args.variant, data_root, out_dir, args.epochs, args.next_token, extra),
              device=args.device)
    seconds = time.perf_counter() - t0
    scores = res["scores"]
    print("\n=== synthetic grounding demo (PyTorch port) ===")
    print("trained and tested through the CLI in %.1f s (host clock, %s%s)"
          % (seconds, args.device, ", %d processes" % args.dp if args.dp > 1 else ""))
    for k in ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L", "test_loss"]:
        print("%-10s %.4f" % (k, scores[k]))
    result = {"scores": {k: float(v) for k, v in scores.items()}, "variant": args.variant,
              "next_token": args.next_token, "images": args.images, "epochs": args.epochs, "dp": args.dp,
              "seconds": seconds}
    if not args.compositional:
        seen = probe(out_dir, args.epochs, args.variant, args.device)
        for cap in seen["captions"][:4]:
            print("unseen-image caption: %s" % cap)
        print("unseen-image color accuracy: %d/16 (chance ~2.7)" % seen["color"])
        print("unseen-image shape accuracy: %d/16 (chance ~5.3; frozen RANDOM" % seen["shape"])
        print("backbone pools away shape — pretrained weights or the attention")
        print("variant are the shape path, as in the reference)")
        result["probe"] = seen
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        print("wrote", args.out)
    return result


if __name__ == "__main__":
    main()
