"""Prefill the PyTorch port's decoded-image cache (--image_cache) ahead of
training: the counterpart of tools/prefill_cache.py, importing only
show_tell_tpu_torch, so it runs where JAX is not installed.

The cache (show_tell_tpu_torch/data/image_cache.py) fills lazily on first
touch, so epoch 1 of a training run pays the JPEG decode of every unique
image.  This tool fills it up front at the native decoder's threaded batch
rate (PIL where the decoder does not build, and for the files it rejects),
with the same cache identity as the loader (image size, ``fast_jpeg``), so
a training run's first epoch streams from the memmap.  The files it writes
are byte for byte those of tools/prefill_cache.py on the same images.

    python tools/prefill_cache_torch.py --ann_path data/COCO/annotations/captions_train2014.json \\
        --img_dir data/COCO/train2014 --image_cache cache/train [--fast_jpeg] [--batch 256]

Point --image_cache at the per-split subdirectory the CLI will use
(``--image_cache DIR`` on the CLI maps train -> DIR/train, test -> DIR/test).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def prefill(ann_path: str, img_dir: str, cache_dir: str, batch: int = 256, fast_jpeg: bool = False,
            n_threads: int = 0) -> int:
    """Decode every image the annotations name that the cache lacks into
    ``cache_dir``; returns the number decoded."""
    from show_tell_tpu_torch.data.coco import CocoCaptions, FlickrCaptions
    from show_tell_tpu_torch.data.dataset import _pil_decode
    from show_tell_tpu_torch.data.image_cache import ImageCache
    from show_tell_tpu_torch.data.images import IMAGE_SIZE
    from show_tell_tpu_torch.native import fastimage

    # The dataset's index rule: .tsv = Flickr-style annotations.
    coco = FlickrCaptions(ann_path) if ann_path.endswith(".tsv") else CocoCaptions(ann_path)
    names = sorted({img["file_name"] for img in coco.imgs.values()})
    # fast_jpeg is part of the cache identity (index.json): a training run
    # must ask for the same decode mode to use this cache.
    cache = ImageCache(cache_dir, names, IMAGE_SIZE, fast_jpeg=fast_jpeg)
    todo = [n for n in names if cache.get(n) is None]
    print("%d images, %d to decode (%.0f%% already cached); decoder: %s" % (
        len(names), len(todo), 100.0 * (1 - len(todo) / max(1, len(names))), fastimage.status()))

    t0 = time.perf_counter()
    done = 0
    use_native = fastimage.is_available()
    for lo in range(0, len(todo), batch):
        chunk = todo[lo : lo + batch]
        imgs, statuses = None, [1] * len(chunk)
        if use_native:
            bufs = []
            for name in chunk:
                with open(os.path.join(img_dir, name), "rb") as f:
                    bufs.append(f.read())
            imgs, statuses = fastimage.decode_resize_batch(bufs, IMAGE_SIZE, IMAGE_SIZE, n_threads=n_threads,
                                                           fast_scale=fast_jpeg)
        for k, name in enumerate(chunk):
            # PIL for the files the native decoder rejects (or all of them without it)
            img = imgs[k] if statuses[k] == 0 else _pil_decode(os.path.join(img_dir, name), fast_jpeg)
            cache.put(name, img)
            done += 1
        if done and done % (batch * 4) == 0:
            rate = done / (time.perf_counter() - t0)
            print("  %d/%d (%.0f img/s, ~%.0fs left)" % (done, len(todo), rate, (len(todo) - done) / rate))
    dt = time.perf_counter() - t0
    print("prefilled %d images in %.1fs (%.0f img/s, host clock); cache at %s" % (
        done, dt, done / dt if dt > 0 else 0.0, cache_dir))
    return done


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ann_path", required=True, help="COCO captions annotation JSON (or a Flickr .tsv)")
    p.add_argument("--img_dir", required=True, help="image directory")
    p.add_argument("--image_cache", required=True, help="cache directory for this split")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--fast_jpeg", action="store_true", help="DCT-domain scaled decode (~2x)")
    p.add_argument("--n_threads", type=int, default=0, help="decoder threads (0 = all cores)")
    args = p.parse_args(argv)
    prefill(args.ann_path, args.img_dir, args.image_cache, args.batch, args.fast_jpeg, args.n_threads)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
