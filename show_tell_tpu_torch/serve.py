"""Serving API: checkpoint -> captions (counterpart of show_tell_tpu/serve.py,
the pooled and the soft-attention GRU and LSTM, greedy and beam decode).

    captioner = Captioner.from_checkpoint("output/COCO/model_50.ckpt",
                                          "output/COCO/vocab.pkl", device="gpu")
    captioner = Captioner.from_checkpoint(ckpt, vocab, variant="attn_lstm", embed_dim=512)
    captions = captioner.caption(images_u8)               # [B,224,224,3] uint8, greedy
    captions = captioner.caption(images_u8, beam_size=3)  # beam search, width 3
    captions = captioner.caption_files(paths)             # image files (native libjpeg, else PIL)
    captioner = Captioner.from_checkpoint(ckpt, vocab, s2d=True)  # the space-to-depth input path
    captioner = Captioner.from_checkpoint("model_9.ckpt", vocab)  # a reference torch .ckpt reads the same way
    captioner = Captioner.from_checkpoint(ckpt, vocab, fold_bn=True)  # BN folded into the encoder's convolutions
    for path, caption in caption_paths(captioner, paths, 64, cache=ServeImageCache(dir, 224)): ...

Over a dp x mp mesh (one process per device, parallel/), ``Captioner(...,
dp=D, mp=M)`` in every process of a group of D x M: each request's rows
split over the dp axis (a request must divide over dp), the decoder's
vocabulary-sized tensors over the mp axis (``parallel.mesh.
decoder_vocab_shard``: V padded to a multiple of M as the JAX Captioner
pads it), the ids gathered so that every process returns the whole
request's.  Under mp every family decodes through the stack-step kernel
(after the attention context kernel in the attention families) with the
projection split over the ranks; the CLI's ``--dp``/``--mp`` spawn the
D x M processes (``--multihost`` joins a group started elsewhere).

Images are preprocessed on the device, by the preprocess kernel on a GPU;
with ``s2d=True`` the fused stem kernel computes the ResNet's stem from
the uint8 pixels instead, as decoded ([B,224,224,3]; it takes their s2d
layout [B,112,112,12] too), with conv1 in its space-to-depth form.
``stage`` copies a batch through pinned memory on a side
stream, and ``caption_paths`` stages batch k+1 on a worker thread while
batch k is captioned.  Greedy decode runs one fused-step
CUDA kernel launch per token on a GPU (the pooled step, or the attention
step with its attention, context, recurrence and argmax; each with a GRU
and an LSTM instance); the pooled GRU's fixed-length decode can instead
take one whole-decode launch for all its tokens
(``ops.whole_decode_default()``, off since an H100 A/B);
beam search (``beam_size`` K > 0) runs B x K beam
rows through a fused step, one launch per token after the first
(decode/beam.py): the pooled families by the route that
``ops.beam_step_default()`` names (dense logits or each row's top-K), the
attention families by the dense-logits form.  ``compute_dtype="bfloat16"`` casts
every float32 weight and BN statistic to bf16 (no autocast); "float32" is
the parity dtype, its convolutions in full f32 (no TF32).  The package
reads checkpoints, vocabularies and images itself (its own copy of the
native JPEG decoder): nothing of the JAX package is imported.

CLI: ``python -m show_tell_tpu_torch.serve --ckpt model.ckpt --vocab
vocab.pkl [--variant gru|lstm|attn|attn_lstm] [--beam_size K] [--s2d 1]
[--fast_jpeg 1] [--image_cache DIR] [--fold_bn 0|1] [--device cpu|gpu]
[--dp D] [--mp M] [--multihost SPEC] img1.jpg photos_dir/ ...``;
``--ckpt`` takes either checkpoint format.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from show_tell_tpu_torch.core.device import DEVICE_CHOICES
from show_tell_tpu_torch.data.images import IMAGE_SIZE, load_images
from show_tell_tpu_torch.data.serve_cache import ServeImageCache
from show_tell_tpu_torch.models.captioner import (
    CaptionerConfig,
    build_model,
    captioner_beam_decode,
    captioner_greedy_decode,
    prepare_decode,
)
from show_tell_tpu_torch.models.serving import FoldedEncoder
from show_tell_tpu_torch.ops import fold_bn_default
from show_tell_tpu_torch.parallel import multihost
from show_tell_tpu_torch.parallel.mesh import active, all_gather_rows, decoder_vocab_shard, make_mesh, shard_rows
from show_tell_tpu_torch.train.checkpoint import import_torch_checkpoint, load_checkpoint
from show_tell_tpu_torch.vocab import load_vocab

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def create_caption_word_format(tokenized, vocab) -> List[List[str]]:
    """ids -> words; truncate at <end>, drop <start> (reference utils.py:105-123)."""
    caption_words = []
    start_idx = vocab.word_to_index[vocab.start_token()]
    for token in tokenized:
        curr_word = []
        for idx in token:
            idx = int(idx)
            if vocab.index_to_word[idx] == vocab.end_token():
                break
            if idx != start_idx:
                curr_word.append(vocab.index_to_word[idx])
        caption_words.append(curr_word)
    return caption_words


def load_any_checkpoint(ckpt_path: str, cfg: CaptionerConfig) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(params, bn_state) from a show_tell_tpu pickle checkpoint or, where
    the file is not one, from a reference torch .ckpt
    (``import_torch_checkpoint``).  A file that loads as neither raises one
    ValueError that names both errors: a torn checkpoint of either format
    would otherwise hide behind the other reader's message."""
    try:
        return load_checkpoint(ckpt_path)
    except Exception as ours_err:
        try:
            return import_torch_checkpoint(ckpt_path, cfg)
        except Exception as torch_err:
            raise ValueError(
                "%s loads neither as a show_tell_tpu checkpoint (%s: %s) nor as a torch checkpoint (%s: %s)"
                % (ckpt_path, type(ours_err).__name__, ours_err, type(torch_err).__name__, torch_err)
            ) from torch_err


class Staged(NamedTuple):
    """A uint8 batch on the Captioner's device (``Captioner.stage``).
    ``ready`` is the event of its copy on the side stream, or None where
    no copy is pending (CPU, or a tensor that was already on the card)."""

    images: torch.Tensor
    ready: Optional["torch.cuda.Event"]


class Captioner:
    def __init__(
        self,
        params: Dict[str, Any],
        bn_state: Dict[str, Any],
        cfg: CaptionerConfig,
        vocab,
        compute_dtype: str = "bfloat16",
        early_exit: bool = False,
        device: Union[str, torch.device] = "gpu",
        s2d: bool = False,
        fold_bn: Optional[bool] = None,
        dp: int = 1,
        mp: int = 1,
    ):
        """params, bn_state: the JAX package's trees (numpy arrays).
        early_exit stops decoding once every row (beam: every beam)
        emitted <end> (identical captions).  device: 'cpu', 'gpu' or a
        torch.device; 'gpu' without CUDA raises.  s2d serves the
        space-to-depth input path: the encoder runs the fused stem kernel
        from the pixels.  fold_bn serves the encoder with every BatchNorm
        folded into its convolution (models/serving.FoldedEncoder); None
        takes ``ops.fold_bn_default()`` on a GPU, the route its H100 A/B
        chose, and the unfolded encoder on the CPU, where the port is held
        to the JAX package's Captioner (which does not fold).

        dp, mp > 1: this process's place in a dp x mp mesh of the group it
        joined (parallel/; every process of the group builds its Captioner
        together): its rows of each request (dp) and its vocabulary shard
        (mp, ``decoder_vocab_shard`` with the pad); 'gpu' is then this
        rank's card (``multihost.local_device``).  Raises where the group
        cannot form the mesh."""
        self.cfg = cfg
        self.vocab = vocab
        self.early_exit = early_exit
        self.s2d = s2d
        self.device = multihost.local_device(device)
        self.mesh = make_mesh(dp, mp, device=self.device) if dp * mp > 1 else None
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.dtype = _DTYPES[compute_dtype]
        self.model = build_model(params, bn_state, cfg, self.dtype, self.device)
        self.fold_bn = (self.device.type == "cuda" and fold_bn_default()) if fold_bn is None else bool(fold_bn)
        if self.fold_bn:
            self.model.encoder = FoldedEncoder.from_trees(params["encoder"], bn_state, cfg.encoder_config(),
                                                          self.dtype, self.device)
        if mp > 1:
            decoder_vocab_shard(self.mesh, self.model.decoder, pad=True)
        self.prepared = prepare_decode(self.model, self.dtype)
        # Early exit and beam retirement key on the loaded vocab's own <end> id.
        self.end_idx = vocab.word_to_index[vocab.end_token()]

    @classmethod
    def from_checkpoint(
        cls,
        ckpt_path: str,
        vocab_path: str,
        variant: str = "gru",
        resnet_version: int = 101,
        embed_dim: int = 256,
        hidden_dim: int = 512,
        num_layers: int = 5,
        compute_dtype: str = "bfloat16",
        early_exit: bool = False,
        device: Union[str, torch.device] = "gpu",
        s2d: bool = False,
        fold_bn: Optional[bool] = None,
        dp: int = 1,
        mp: int = 1,
        **cfg_kw,
    ) -> "Captioner":
        """Load a checkpoint, a show_tell_tpu pickle (either package's) or a
        reference torch .ckpt, and its vocab.pkl (in every process of a
        dp x mp mesh)."""
        vocab = load_vocab(vocab_path)
        cfg_kw.setdefault("start_token", vocab.word_to_index.get(vocab.start_token(), 1))
        cfg = CaptionerConfig(
            variant=variant, resnet_version=resnet_version, embed_dim=embed_dim,
            hidden_dim=hidden_dim, vocab_size=len(vocab), num_layers=num_layers, **cfg_kw,
        )
        params, bn_state = load_any_checkpoint(ckpt_path, cfg)
        return cls(params, bn_state, cfg, vocab, compute_dtype, early_exit=early_exit, device=device, s2d=s2d,
                   fold_bn=fold_bn, dp=dp, mp=mp)

    def local_rows(self, n: int) -> slice:
        """This process's rows of a request of ``n``: its dp share under a
        mesh (a ValueError naming dp where n does not divide), else all."""
        if self.mesh is None:
            return slice(0, n)
        if n % self.mesh.dp:
            raise ValueError("serving batch of %d does not divide over dp=%d; pass a batch that is a multiple of dp "
                             "(pad with repeated images and slice the outputs, as the CLI does)" % (n, self.mesh.dp))
        return shard_rows(self.mesh, n)

    def stage(self, images_u8: Union[np.ndarray, torch.Tensor], local: bool = False) -> Staged:
        """A uint8 batch -> ``Staged`` on the Captioner's device: this
        process's rows of it under a dp mesh (``local_rows``), or with
        ``local`` the batch as it is, already those rows.  From the
        host to a GPU the batch is copied into freshly pinned memory, then
        to the card with non_blocking=True on a side stream, and ``ready``
        records that copy; ``caption_ids`` makes the compute stream wait on
        it.  PyTorch's pinned-memory allocator keeps the buffer from reuse
        until its copy has run.  Callable from a worker thread, so batch
        k+1's copy overlaps batch k's compute."""
        if not local:
            images_u8 = images_u8[self.local_rows(len(images_u8))]
        host = torch.from_numpy(np.ascontiguousarray(images_u8)) if isinstance(images_u8, np.ndarray) else images_u8
        if self._copy_stream is None or host.device.type != "cpu":
            return Staged(host.to(self.device), None)
        pinned = host.pin_memory()
        with torch.cuda.device(self.device), torch.cuda.stream(self._copy_stream):
            images = pinned.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return Staged(images, ready)

    def caption_ids(self, images_u8: Union[np.ndarray, torch.Tensor, Staged], beam_size: int = 0) -> np.ndarray:
        """uint8 [B,224,224,3] (under s2d also [B,112,112,12]; host numpy,
        a tensor or a ``stage``d batch) -> [B, 25] int32 ids: greedy for
        beam_size 0, else beam search of that width.  Under a dp mesh this
        process decodes its rows and the ids are gathered over the dp
        group: every process returns the whole request's."""
        staged = images_u8 if isinstance(images_u8, Staged) else self.stage(images_u8)
        images = staged.images
        if staged.ready is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(staged.ready)
            images.record_stream(compute)  # allocated on the side stream, read on this one
        with torch.inference_mode():
            if beam_size > 0:
                ids = captioner_beam_decode(self.model, self.cfg, images, self.prepared, beam_size,
                                            end_token=self.end_idx, early_exit=self.early_exit, s2d=self.s2d)
            else:
                ids = captioner_greedy_decode(
                    self.model, self.cfg, images, self.prepared,
                    end_token=self.end_idx if self.early_exit else None, s2d=self.s2d,
                )
            if self.mesh is not None and self.mesh.dp > 1:
                ids = all_gather_rows(ids.to(self.mesh.device), self.mesh)
        return ids.cpu().numpy()

    def caption(self, images_u8, beam_size: int = 0) -> List[str]:
        """uint8 images (host, tensor or staged) -> caption strings (<end>-truncated)."""
        words = create_caption_word_format(self.caption_ids(images_u8, beam_size), self.vocab)
        return [" ".join(w) for w in words]

    def load_files(self, paths: Sequence[str], fast_jpeg: bool = False) -> np.ndarray:
        """Image file paths -> uint8 [N,224,224,3] (data/images.py: the
        native decoder, PIL for the files it rejects).  fast_jpeg: its
        DCT-domain scaled decode, about 2x faster on the host, pixels
        within a few LSB of the full decode."""
        return load_images(paths, fast_jpeg)

    def caption_files(self, paths: Sequence[str], beam_size: int = 0, fast_jpeg: bool = False) -> List[str]:
        return self.caption(self.load_files(paths, fast_jpeg), beam_size)


def _load_with_cache(captioner: Captioner, paths: Sequence[str], cache: Optional[ServeImageCache],
                     fast_jpeg: bool = False) -> np.ndarray:
    """``load_files`` through an optional ServeImageCache: cached rows
    come from their .npy, only the misses are decoded (and cached)."""
    if cache is None:
        return captioner.load_files(paths, fast_jpeg)
    out = [cache.get(p) for p in paths]
    miss = [i for i, a in enumerate(out) if a is None]
    if miss:
        decoded = captioner.load_files([paths[i] for i in miss], fast_jpeg)
        for j, i in enumerate(miss):
            out[i] = decoded[j]
            cache.put(paths[i], decoded[j])
    return np.stack(out)


def caption_paths(
    captioner: Captioner,
    paths: Sequence[str],
    batch_size: int,
    beam_size: int = 0,
    cache: Optional[ServeImageCache] = None,
    overlap: bool = True,
    fast_jpeg: bool = False,
) -> Iterator[Tuple[str, str]]:
    """Caption image files in batches of ``batch_size``, yielding (path,
    caption) in order.  Fewer files than ``batch_size`` make one batch of
    their own size; otherwise the last batch is padded with repeats of its
    last image and the outputs sliced, so every batch has one shape.
    overlap loads and stages batch k+1 on one worker thread while batch k
    is captioned; False runs each batch's load, copy and captioning in
    turn.  fast_jpeg: the scaled JPEG decode (``Captioner.load_files``);
    a cache should be keyed with the same flag.

    Under a dp mesh ``batch_size`` must divide over dp (a batch of fewer
    files is rounded up to the next multiple of dp), each process decodes
    only its rows of each batch, and every process yields every file's
    caption."""
    if not paths:
        return
    dp = captioner.mesh.dp if captioner.mesh is not None else 1
    B = min(batch_size, -(-len(paths) // dp) * dp)
    rows = captioner.local_rows(B)
    chunks = [paths[lo : lo + B] for lo in range(0, len(paths), B)]

    def load(chunk):
        # This process's rows of the padded batch, as files of the chunk (the padding repeats its last file); each
        # file is decoded once and its pixels repeated.
        picks = (list(range(len(chunk))) + [len(chunk) - 1] * (B - len(chunk)))[rows]
        files = sorted(set(picks))
        imgs = _load_with_cache(captioner, [chunk[i] for i in files], cache, fast_jpeg)
        if picks != files:
            imgs = imgs[[files.index(i) for i in picks]]
        return captioner.stage(imgs, local=True)

    if not overlap:
        for chunk in chunks:
            yield from zip(chunk, captioner.caption(load(chunk), beam_size)[: len(chunk)])
        return

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        nxt = pool.submit(load, chunks[0])
        for i, chunk in enumerate(chunks):
            staged = nxt.result()
            if i + 1 < len(chunks):
                nxt = pool.submit(load, chunks[i + 1])
            yield from zip(chunk, captioner.caption(staged, beam_size)[: len(chunk)])


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Caption JPEG files and directories from a checkpoint, printing one
    ``path<TAB>caption`` line per image (``--json``: one JSON object)."""
    import argparse
    import json
    import os
    import sys

    p = argparse.ArgumentParser(prog="python -m show_tell_tpu_torch.serve", description="Caption images from a checkpoint.")
    p.add_argument("images", nargs="+", help="JPEG files and/or directories of JPEGs")
    p.add_argument("--ckpt", required=True, help="checkpoint: a show_tell_tpu pickle or a reference torch .ckpt")
    p.add_argument("--vocab", required=True, help="vocab.pkl path")
    p.add_argument("--variant", default="gru", choices=["gru", "lstm", "attn", "attn_lstm"],
                   help="model family: pooled gru/lstm (main.py, main_lstm.py) or attention attn/attn_lstm")
    p.add_argument("--resnet_version", type=int, default=101)
    p.add_argument("--embedding_length", type=int, default=0,
                   help="0 = the reference default for the variant (256 gru, 512 the others)")
    p.add_argument("--num_hidden_units", type=int, default=512)
    p.add_argument("--num_layers", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--beam_size", type=int, default=0, help="0 = greedy; K > 0 = beam search of width K")
    p.add_argument("--compute_dtype", default="bfloat16", choices=sorted(_DTYPES))
    p.add_argument("--nos_cnn_filters", type=int, default=0,
                   help="attention variants: encoder channels (0 = the backbone's, 2048 for ResNet-50/101/152, "
                        "512 for 18/34)")
    p.add_argument("--attn_dim", type=int, default=512, help="attention variants: attention width (reference 512)")
    p.add_argument("--early_exit", type=int, default=0,
                   help="stop decoding when every row (or beam) emitted <end>; identical captions")
    p.add_argument("--s2d", type=int, default=0,
                   help="serve the space-to-depth input path: the fused stem kernel from the decoded pixels")
    p.add_argument("--fast_jpeg", type=int, default=0, help="DCT-domain scaled JPEG decode (~2x host decode speed)")
    p.add_argument("--fold_bn", type=int, default=-1, choices=[-1, 0, 1],
                   help="serve the encoder with its BatchNorms folded into the convolutions: 1 on, 0 off, "
                        "-1 the default (ops.fold_bn_default() on the card, off on the CPU)")
    p.add_argument("--image_cache", default="",
                   help="decoded-image cache dir (.npy per image keyed by path, size, mtime and --fast_jpeg; stale "
                        "entries decode anew; shareable across serve runs)")
    p.add_argument("--device", default="gpu", choices=DEVICE_CHOICES, help="gpu raises when there is no CUDA device")
    p.add_argument("--dp", type=int, default=1,
                   help="shard each batch's rows over this many processes, one a device (the CUDA cards of this "
                        "host, or the CPU); dp x mp > 1 spawns the dp x mp processes")
    p.add_argument("--mp", type=int, default=1,
                   help="shard the decoder's vocabulary-sized tensors (output projection, embedding) over this many "
                        "processes for each dp share")
    p.add_argument("--multihost", default="",
                   help="join a group of dp x mp processes started elsewhere: 'coordinator_host:port,"
                        "num_processes,process_id', or 'auto' under torchrun; process 0 prints")
    p.add_argument("--json", action="store_true", help='emit {"image": ..., "caption": ...} JSON lines')
    args = p.parse_args(argv)

    paths: List[str] = []
    for item in args.images:
        if os.path.isdir(item):
            paths.extend(
                os.path.join(item, f) for f in sorted(os.listdir(item))
                if f.lower().endswith((".jpg", ".jpeg", ".png"))
            )
        elif os.path.isfile(item):
            paths.append(item)
        else:
            print("image path does not exist: %s" % item, file=sys.stderr)
            return 2
    if not paths:
        print("no images found", file=sys.stderr)
        return 2

    if args.dp < 1 or args.mp < 1:
        print("--dp and --mp take 1 or more", file=sys.stderr)
        return 2
    if args.batch_size % args.dp:
        args.batch_size += args.dp - args.batch_size % args.dp  # batches shard over dp; round up
        print("batch_size rounded up to %d (multiple of dp=%d)" % (args.batch_size, args.dp), file=sys.stderr)
    if args.multihost and multihost.process_count() == 1:
        multihost.initialize(args.multihost, args.device)
        primary = multihost.is_primary()
        try:
            results, cached = _serve(args, paths)
        finally:
            torch.distributed.destroy_process_group()
        if not primary:
            return 0
    elif args.dp * args.mp > 1 and multihost.process_count() == 1:
        results, cached = multihost.spawn(_serve, args.dp * args.mp, (args, paths), args.device)[0]
    else:
        results, cached = _serve(args, paths)
    for path, cap in results:
        print(json.dumps({"image": path, "caption": cap}) if args.json else "%s\t%s" % (path, cap))
    if cached is not None:
        print("image cache %s: %d hits, %d misses" % (args.image_cache, *cached), file=sys.stderr)
    return 0


def _serve(args, paths: List[str]) -> Tuple[List[Tuple[str, str]], Optional[Tuple[int, int]]]:
    """The CLI's captioning in this process (one of a dp x mp mesh, or
    alone): every (path, caption) in input order, and the image cache's
    (hits, misses) over every row of the batches (None without a cache)."""
    cfg_kw = {}
    if args.variant.startswith("attn"):
        nos = args.nos_cnn_filters or (512 if args.resnet_version in (18, 34) else 2048)
        cfg_kw = dict(nos_filters=nos, attn_dim=args.attn_dim)
    captioner = Captioner.from_checkpoint(
        args.ckpt, args.vocab, variant=args.variant, resnet_version=args.resnet_version,
        embed_dim=args.embedding_length or (256 if args.variant == "gru" else 512),
        hidden_dim=args.num_hidden_units, num_layers=args.num_layers, compute_dtype=args.compute_dtype,
        early_exit=bool(args.early_exit), device=args.device, s2d=bool(args.s2d),
        fold_bn=None if args.fold_bn < 0 else bool(args.fold_bn), dp=args.dp, mp=args.mp, **cfg_kw,
    )
    fast_jpeg = bool(args.fast_jpeg)
    cache = ServeImageCache(args.image_cache, IMAGE_SIZE, fast_jpeg) if args.image_cache else None
    results = list(caption_paths(captioner, paths, max(1, args.batch_size), args.beam_size, cache=cache,
                                 fast_jpeg=fast_jpeg))
    if cache is None:
        return results, None
    counts = torch.tensor([cache.hits, cache.misses], dtype=torch.int64)
    mesh = active(captioner.mesh)
    if mesh is not None:  # each dp rank read its own rows
        counts = counts.to(mesh.device)
        torch.distributed.all_reduce(counts, group=mesh.group)
    return results, tuple(int(c) for c in counts)


if __name__ == "__main__":
    raise SystemExit(main())
