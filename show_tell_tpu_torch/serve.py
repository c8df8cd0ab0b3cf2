"""Serving API: checkpoint -> captions (counterpart of show_tell_tpu/serve.py,
the pooled and the soft-attention GRU and LSTM, greedy and beam decode).

    captioner = Captioner.from_checkpoint("output/COCO/model_50.ckpt",
                                          "output/COCO/vocab.pkl", device="gpu")
    captioner = Captioner.from_checkpoint(ckpt, vocab, variant="attn_lstm", embed_dim=512)
    captions = captioner.caption(images_u8)               # [B,224,224,3] uint8, greedy
    captions = captioner.caption(images_u8, beam_size=3)  # beam search, width 3
    captions = captioner.caption_files(paths)             # image files (PIL)

Images are preprocessed on the device.  Greedy decode runs one fused-step
CUDA kernel launch per token on a GPU (the pooled step, or the attention
step with its attention, context, recurrence and argmax; each with a GRU
and an LSTM instance); beam search (``beam_size`` K > 0) runs B x K beam
rows through the fused step's dense-logits form, one launch per token
after the first (decode/beam.py).  ``compute_dtype="bfloat16"`` casts
every float32 weight and BN statistic to bf16 (no autocast); "float32" is
the parity dtype.  The package reads checkpoints, vocabularies and images
itself: nothing of the JAX package is imported.

CLI: ``python -m show_tell_tpu_torch.serve --ckpt model.ckpt --vocab
vocab.pkl [--variant gru|lstm|attn|attn_lstm] [--beam_size K] [--device cpu|gpu]
img1.jpg photos_dir/ ...``
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from show_tell_tpu_torch.core.device import DEVICE_CHOICES, resolve_device
from show_tell_tpu_torch.data.images import load_images
from show_tell_tpu_torch.data.transforms import preprocess_images
from show_tell_tpu_torch.models.captioner import (
    CaptionerConfig,
    build_model,
    captioner_beam_decode,
    captioner_greedy_decode,
    prepare_decode,
)
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


class _NumpyTreeUnpickler(pickle.Unpickler):
    """Reads the JAX package's pickle checkpoints without importing jax:
    numpy and builtin types load as themselves, and any other class (the
    optimizer's state tuples) becomes an inert tuple, since serving reads
    only the weights."""

    _ALLOWED = ("numpy", "ml_dtypes", "builtins", "collections", "copyreg", "_codecs")

    def find_class(self, module: str, name: str):
        if module.split(".")[0] in self._ALLOWED:
            return super().find_class(module, name)
        return type(name, (_Opaque,), {"__module__": module})


class _Opaque(tuple):
    def __new__(cls, *args, **kwargs):
        return tuple.__new__(cls, args)

    def __setstate__(self, state):
        pass


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A show_tell_tpu pickle checkpoint (train/checkpoint.py) -> (params,
    bn_state) numpy trees in the JAX layout."""
    with open(path, "rb") as f:
        ckpt = _NumpyTreeUnpickler(f).load()
    if not (isinstance(ckpt, dict) and str(ckpt.get("format", "")).startswith("show_tell_tpu")):
        raise ValueError(
            "%s is not a show_tell_tpu pickle checkpoint (reading reference torch .ckpt files "
            "is ROADMAP Queue 1 item 7)" % path
        )
    enc = ckpt["encoder_state_dict"]
    params = {
        "encoder": {
            "resnet": enc["frozen"]["resnet"],
            "linear_secondlast_layer": enc["trainable"]["linear_secondlast_layer"],
            "last_layer": enc["trainable"]["last_layer"],
        },
        "decoder": ckpt["decoder_state_dict"],
    }
    return params, enc["bn_state"]


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
    ):
        """params, bn_state: the JAX package's trees (numpy arrays).
        early_exit stops decoding once every row (beam: every beam)
        emitted <end> (identical captions).  device: 'cpu', 'gpu' or a
        torch.device; 'gpu' without CUDA raises."""
        self.cfg = cfg
        self.vocab = vocab
        self.early_exit = early_exit
        self.device = resolve_device(device)
        self.dtype = _DTYPES[compute_dtype]
        self.model = build_model(params, bn_state, cfg, self.dtype, self.device)
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
        **cfg_kw,
    ) -> "Captioner":
        """Load a show_tell_tpu pickle checkpoint and its vocab.pkl."""
        vocab = load_vocab(vocab_path)
        cfg_kw.setdefault("start_token", vocab.word_to_index.get(vocab.start_token(), 1))
        cfg = CaptionerConfig(
            variant=variant, resnet_version=resnet_version, embed_dim=embed_dim,
            hidden_dim=hidden_dim, vocab_size=len(vocab), num_layers=num_layers, **cfg_kw,
        )
        params, bn_state = load_checkpoint(ckpt_path)
        return cls(params, bn_state, cfg, vocab, compute_dtype, early_exit=early_exit, device=device)

    def caption_ids(self, images_u8: Union[np.ndarray, torch.Tensor], beam_size: int = 0) -> np.ndarray:
        """uint8 [B,224,224,3] (host numpy or a tensor) -> [B, 25] int32
        ids: greedy for beam_size 0, else beam search of that width."""
        images = torch.as_tensor(images_u8).to(self.device, non_blocking=True)
        with torch.inference_mode():
            x = preprocess_images(images, augment=False, dtype=self.dtype)
            if beam_size > 0:
                ids = captioner_beam_decode(self.model, self.cfg, x, self.prepared, beam_size,
                                            end_token=self.end_idx, early_exit=self.early_exit)
            else:
                ids = captioner_greedy_decode(
                    self.model, self.cfg, x, self.prepared,
                    end_token=self.end_idx if self.early_exit else None,
                )
        return ids.cpu().numpy()

    def caption(self, images_u8, beam_size: int = 0) -> List[str]:
        """uint8 [B,224,224,3] -> caption strings (<end>-truncated)."""
        words = create_caption_word_format(self.caption_ids(images_u8, beam_size), self.vocab)
        return [" ".join(w) for w in words]

    def load_files(self, paths: Sequence[str]) -> np.ndarray:
        """Image file paths -> uint8 [N,224,224,3] (PIL, data/images.py)."""
        return load_images(paths)

    def caption_files(self, paths: Sequence[str], beam_size: int = 0) -> List[str]:
        return self.caption(self.load_files(paths), beam_size)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Caption JPEG files and directories from a checkpoint, printing one
    ``path<TAB>caption`` line per image (``--json``: one JSON object)."""
    import argparse
    import json
    import os
    import sys

    p = argparse.ArgumentParser(prog="python -m show_tell_tpu_torch.serve", description="Caption images from a checkpoint.")
    p.add_argument("images", nargs="+", help="JPEG files and/or directories of JPEGs")
    p.add_argument("--ckpt", required=True, help="show_tell_tpu pickle checkpoint")
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
    p.add_argument("--device", default="gpu", choices=DEVICE_CHOICES, help="gpu raises when there is no CUDA device")
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

    cfg_kw = {}
    if args.variant.startswith("attn"):
        nos = args.nos_cnn_filters or (512 if args.resnet_version in (18, 34) else 2048)
        cfg_kw = dict(nos_filters=nos, attn_dim=args.attn_dim)
    captioner = Captioner.from_checkpoint(
        args.ckpt, args.vocab, variant=args.variant, resnet_version=args.resnet_version,
        embed_dim=args.embedding_length or (256 if args.variant == "gru" else 512),
        hidden_dim=args.num_hidden_units, num_layers=args.num_layers, compute_dtype=args.compute_dtype,
        early_exit=bool(args.early_exit), device=args.device, **cfg_kw,
    )
    B = max(1, args.batch_size)
    for lo in range(0, len(paths), B):
        chunk = paths[lo : lo + B]
        for path, cap in zip(chunk, captioner.caption_files(chunk, args.beam_size)):
            print(json.dumps({"image": path, "caption": cap}) if args.json else "%s\t%s" % (path, cap))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
