"""The train and eval steps (counterpart of show_tell_tpu/train/train_step.py).

A train step: the uint8 batch is normalized on the device with random
flips (data/transforms.py), the captioner runs in train mode (the frozen
backbone's BatchNorms move their running statistics), the teacher-forced
loss goes backward over the trainable split only, and the optimizer
updates it.  The state is a ``TrainState`` that the step updates in place.

f32 is the parity dtype: on a GPU the step scopes TF32 off for
convolutions and matmuls (``models.captioner.exact_f32_math``).
``compute_dtype=bfloat16`` mirrors the JAX package's mixed precision: the
master weights, gradients, optimizer state and BatchNorm statistics stay
f32, and the forward and backward run in bf16.  Like the JAX step, which
casts its parameters to bf16 inside the loss function, the step casts
every float parameter but the BatchNorms' to bf16 inside the forward
(``torch.func.functional_call`` with the cast tensors), so gradients flow
back through the casts to the f32 masters.  That keeps the bf16 rounding
where the JAX step has it, which ``torch.autocast`` (a per-op policy)
would not.  BatchNorm weights stay f32 beside bf16 activations, as its
statistics do.  The logits that enter the CE are f32 from upcast
operands (models/decoder.linear_f32).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch.func import functional_call

from show_tell_tpu_torch.core.device import resolve_device
from show_tell_tpu_torch.data.transforms import preprocess_images
from show_tell_tpu_torch.models.captioner import (
    CaptionerConfig,
    CaptionerModel,
    beam_decode_features,
    build_trainable_model,
    decoder_loss,
    encode,
    exact_f32_math,
    greedy_decode_features,
    init_captioner,
    prepare_decode,
    trainable_parameters,
)
from show_tell_tpu_torch.models.resnet import BatchNorm
from show_tell_tpu_torch.train.optim import make_optimizer

COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


class TrainState:
    """What a train step reads and updates: the model (f32, train mode),
    its optimizer over the trainable split, the CPU generator the flips are
    drawn from, and the count of steps taken."""

    def __init__(self, model: CaptionerModel, optimizer: torch.optim.Optimizer, generator: torch.Generator,
                 step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.generator = generator
        self.step = step

    @property
    def device(self) -> torch.device:
        return self.model.decoder.embeddings.weight.device


def create_train_state(
    cfg: CaptionerConfig,
    optimizer_type: str,
    lr: float,
    momentum: float = 0.9,
    device: Union[str, torch.device] = "gpu",
    seed: int = 1,
    init: Optional[Tuple[Dict[str, Any], Dict[str, Any]]] = None,
) -> TrainState:
    """A fresh TrainState on ``device`` ('gpu' raises without CUDA).  The
    weights are ``init``'s (params, bn_state) numpy trees in the JAX
    layout, or else drawn by ``init_captioner``'s laws from a generator
    seeded with ``seed``; the flips' generator is seeded from that one
    first, as the JAX package splits its key."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    flips = torch.Generator().manual_seed(int(torch.randint(2**62, (1,), generator=g)))
    params, bn_state = init if init is not None else init_captioner(cfg, g)
    model = build_trainable_model(params, bn_state, cfg, device)
    optimizer = make_optimizer(optimizer_type, trainable_parameters(model).values(), lr, momentum)
    return TrainState(model, optimizer, flips)


def _compute_params(model: CaptionerModel, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Every float parameter but the BatchNorms' cast to ``dtype``; the
    casts of trainable ones stay in the graph."""
    bn = {name for name, m in model.named_modules() if isinstance(m, BatchNorm)}
    return {n: p.to(dtype) for n, p in model.named_parameters() if n.rpartition(".")[0] not in bn}


def _on(device: torch.device, *arrays):
    return [torch.as_tensor(a).to(device, non_blocking=True) for a in arrays]


def make_train_step(
    cfg: CaptionerConfig, augment: bool = True, compute_dtype: str = "float32"
) -> Callable[[TrainState, Any, Any, Any], torch.Tensor]:
    """Returns step(ts, images_u8, captions, lengths) -> the loss (a 0-dim
    f32 tensor on the device; the caller's ``float()`` is its sync).  The
    batch may be numpy or tensors on any device.  augment=False skips the
    flips (lockstep tests: they cannot match the JAX package's draws)."""
    dtype = COMPUTE_DTYPES[compute_dtype]

    def step(ts: TrainState, images_u8, captions, lengths) -> torch.Tensor:
        model = ts.model
        model.train()
        images_u8, captions, lengths = _on(ts.device, images_u8, captions, lengths)
        with exact_f32_math(ts.device):
            images = preprocess_images(images_u8, ts.generator if augment else None, augment)
            if dtype is None:
                loss = model(images, captions, lengths)
            else:
                loss = functional_call(model, _compute_params(model, dtype), (images.to(dtype), captions, lengths))
            ts.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            ts.optimizer.step()
        ts.step += 1
        return loss.detach()

    return step


def make_eval_step(
    cfg: CaptionerConfig,
    augment: bool = True,
    compute_dtype: str = "float32",
    beam_size: int = 0,
    loss_only: bool = False,
    early_exit: bool = False,
    end_token: int = 2,
):
    """Returns evaluate(ts, images_u8, captions, lengths, generator=None,
    prepared=None, t_max=None) -> (loss, out): eval-mode BatchNorm, one
    encoder forward, the teacher-forced loss from its features, and from
    them ``out``: the greedy decode's ids [B, 25] int32
    (``greedy_decode_features``: the decode kernels on a GPU), with
    ``beam_size`` > 0 the batched beam search's (``beam_decode_features``),
    or with ``loss_only`` the features themselves (the faithful beam decodes
    them on the host).  ``early_exit`` stops the decode once every row
    emitted ``end_token`` (identical ids).  The reference keeps its random
    flips at test time (utils.py:96); ``augment`` mirrors that, drawn from
    ``generator``.

    ``ts.model`` computes in ``compute_dtype`` ("bfloat16": a model whose
    weights the caller cast, and the images are cast to it).  ``prepared``:
    the kernels' weight layout (``prepare_decode``), which a caller that
    evaluates many batches of unchanged weights builds once; else it is
    built from the weights at each call, so an eval after an update or a
    restore decodes with the weights as they are.  ``t_max``: the longest
    caption length, where the caller has it on the host.  Neither the loss
    nor ``out`` is read on the host here (with ``t_max`` given and no
    ``early_exit``: no device sync), so a caller may queue the next batch
    before it reads them.  The model's mode is restored."""
    dtype = COMPUTE_DTYPES[compute_dtype] or torch.float32

    def evaluate(ts: TrainState, images_u8, captions, lengths, generator: Optional[torch.Generator] = None,
                 prepared: Optional[Dict[str, object]] = None, t_max: Optional[int] = None):
        model = ts.model
        was_training = model.training
        model.eval()
        try:
            images_u8, captions, lengths = _on(ts.device, images_u8, captions, lengths)
            with torch.no_grad(), exact_f32_math(ts.device):
                images = preprocess_images(images_u8, generator, augment, dtype)
                feats = encode(model, images)
                loss = decoder_loss(model, cfg, feats, captions, lengths, t_max)
                if loss_only:
                    return loss, feats
                if prepared is None:
                    prepared = prepare_decode(model, dtype)
                if beam_size > 0:
                    out = beam_decode_features(model, cfg, feats, prepared, beam_size, end_token, early_exit)
                else:
                    out = greedy_decode_features(model, cfg, feats, prepared, end_token if early_exit else None)
        finally:
            model.train(was_training)
        return loss, out

    return evaluate
