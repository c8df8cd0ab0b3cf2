"""show_tell_tpu_torch: the Show-and-Tell captioner in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (H100).

A port of the JAX package ``show_tell_tpu``, which stays the reference.
This package imports torch and never jax, and nothing of the JAX package
either: what it needs of that package's host modules (the vocabulary and
its pickle reader, the image size and loader, the native JPEG decoder) it
keeps as its own copies.

Layout mirrors the JAX package:
  core/     device resolution (--device cpu|gpu)
  data/     image files to uint8 batches (native libjpeg, or PIL), on-device preprocessing
  decode/   batched beam search over the decode kernels
  models/   ResNet encoder, GRU/LSTM decoders (pooled, attention), captioner, weight bridge
  native/   the host's JPEG decoder (libjpeg, C++), built with g++ at first use
  ops/      the CUDA kernels (csrc/), their wrappers and plain twins, the build
  vocab.py  the caption vocabulary and its vocab.pkl reader
  serve.py  Captioner and the captioning CLI
"""

__version__ = "0.1.0"
