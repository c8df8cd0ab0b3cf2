"""The optimizers of the reference (main.py:96-102), as PyTorch's own
(counterpart of show_tell_tpu/train/optim.py).

The JAX package builds them from optax primitives with the rules below;
``torch.optim`` implements the same rules:

  SGD + momentum (dampening 0, no Nesterov, no weight decay):
      buf <- momentum * buf + g          (buf starts as g)
      p   <- p - lr * buf
  == optax.trace(decay=momentum) then scale(-lr), whose trace starts at 0.

  Adam (betas (0.9, 0.999), eps 1e-8):
      p <- p - lr * m_hat / (sqrt(v_hat) + eps)
  == optax.scale_by_adam(0.9, 0.999, eps=1e-8) then scale(-lr).
"""

from __future__ import annotations

from typing import Iterable

import torch

OPTIMIZERS = ("SGD", "Adam")


def make_optimizer(optimizer_type: str, params: Iterable[torch.nn.Parameter], lr: float,
                   momentum: float = 0.9) -> torch.optim.Optimizer:
    if optimizer_type == "SGD":
        return torch.optim.SGD(params, lr=lr, momentum=momentum)
    elif optimizer_type == "Adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    raise ValueError("Please specify a valid optimizer. %s is invalid." % (optimizer_type,))
