"""show_tell_tpu_torch: the Show-and-Tell captioner in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (H100).

A port of the JAX package ``show_tell_tpu``, which stays the reference.
This package imports torch and never jax.  It reuses the JAX package's
framework-free host modules (``show_tell_tpu.vocab``,
``show_tell_tpu.native.fastimage``, ``show_tell_tpu.data.dataset``), which
import no jax either.

Layout mirrors the JAX package:
  core/     device resolution (--device cpu|gpu)
  data/     on-device image preprocessing
  models/   ResNet encoder, GRU/LSTM decoders (pooled, attention), captioner, weight bridge
  ops/      the CUDA kernels (csrc/), their wrappers and plain twins, the build
  serve.py  Captioner and the captioning CLI
"""

__version__ = "0.1.0"
