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

Data parallelism (a ``TrainState`` with the ``parallel.mesh.Mesh`` of a
process group, one process per device): each rank takes its contiguous
rows of the global batch and the flips the global batch draws for them,
every BatchNorm in train mode normalizes by the statistics of all ranks'
rows, and the loss is this rank's share of the global batch's: its sums
over the global batch's token and row counts, which every rank reads
from the global lengths it holds.  ``DistributedDataParallel`` over the trainable split averages
the gradients of dp x that share, which is the gradient of the global
loss; every rank then takes the same optimizer step.  The step returns the
global loss, the same on every rank.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn as nn
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
from show_tell_tpu_torch.parallel.mesh import (
    Mesh,
    active,
    all_gather_rows,
    all_reduce_sum,
    decoder_vocab_shard,
    replicate,
    shard_batch,
    shard_rows,
)
from show_tell_tpu_torch.train.optim import make_optimizer

COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


class _StepForward(nn.Module):
    """The train step's forward as one module, so that DDP can wrap it: the
    loss (with ``batch_lengths``, this rank's share of the whole batch's),
    in f32, or with every float parameter but the BatchNorms' cast to
    ``dtype`` inside the forward."""

    def __init__(self, model: CaptionerModel):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor, captions: torch.Tensor, lengths: torch.Tensor,
                batch_lengths: Optional[torch.Tensor], dtype: Optional[torch.dtype]) -> torch.Tensor:
        if dtype is None:
            return self.model(images, captions, lengths, batch_lengths)
        return functional_call(self.model, _compute_params(self.model, dtype),
                               (images.to(dtype), captions, lengths, batch_lengths))


class TrainState:
    """What a train step reads and updates: the model (f32, train mode),
    its optimizer over the trainable split, the CPU generator the flips are
    drawn from, and the count of steps taken.  ``mesh``: a data-parallel
    mesh (parallel/mesh.py), or None in one process.  ``forward`` is the
    step's forward (``_StepForward``); under the mesh of a process group
    every BatchNorm of the model takes the mesh's statistics, and
    ``forward`` is its DistributedDataParallel wrapper, made here on every
    rank at once, from rank 0's weights and statistics (``replicate``)."""

    def __init__(self, model: CaptionerModel, optimizer: torch.optim.Optimizer, generator: torch.Generator,
                 step: int = 0, mesh: Optional[Mesh] = None):
        self.model = model
        self.optimizer = optimizer
        self.generator = generator
        self.step = step
        self.mesh = active(mesh)
        self.forward = _StepForward(model)
        if self.mesh is not None:
            replicate(self.mesh, model)  # every rank starts from rank 0's weights and statistics
            for m in model.modules():
                if isinstance(m, BatchNorm):
                    m.mesh = self.mesh
            from torch.nn.parallel import DistributedDataParallel

            # The attention families never run the encoder's head: DDP must not wait for its gradients.
            self.forward = DistributedDataParallel(self.forward, broadcast_buffers=False,
                                                   find_unused_parameters=model.cfg.is_attention)

    @property
    def device(self) -> torch.device:
        return self.model.decoder.embeddings.weight.device


def shard_train_state(ts: TrainState, mesh: Optional[Mesh], dtype: Optional[torch.dtype] = None) -> TrainState:
    """The TrainState an eval runs (the JAX package's
    ``shard_train_state(tensor_parallel=True)``, for eval): ``ts`` itself
    where nothing changes, else a copy of its model, in ``dtype`` (every
    float weight and BN statistic cast, as the JAX package casts its
    trees), whose decoder holds this rank's vocabulary shard under a mesh
    with an mp axis (``parallel.mesh.decoder_vocab_shard`` without the pad:
    the eval's loss cannot pad the vocabulary).  The caller's model is left
    as it is; the copy has no optimizer (evaluation takes no step)."""
    sharded = mesh is not None and mesh.mp > 1
    if dtype is None and not sharded:
        return ts
    model = copy.deepcopy(ts.model)
    if dtype is not None:
        model = model.to(dtype)
    if sharded:
        decoder_vocab_shard(mesh, model.decoder, pad=False)
    return TrainState(model, None, None)


def create_train_state(
    cfg: CaptionerConfig,
    optimizer_type: str,
    lr: float,
    momentum: float = 0.9,
    device: Union[str, torch.device] = "gpu",
    seed: int = 1,
    init: Optional[Tuple[Dict[str, Any], Dict[str, Any]]] = None,
    mesh: Optional[Mesh] = None,
) -> TrainState:
    """A fresh TrainState on ``device`` ('gpu' raises without CUDA).  The
    weights are ``init``'s (params, bn_state) numpy trees in the JAX
    layout, or else drawn by ``init_captioner``'s laws from a generator
    seeded with ``seed``; the flips' generator is seeded from that one
    first, as the JAX package splits its key.  ``mesh``: the data-parallel
    mesh of a multi-process run (``TrainState``), made on every rank."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    flips = torch.Generator().manual_seed(int(torch.randint(2**62, (1,), generator=g)))
    params, bn_state = init if init is not None else init_captioner(cfg, g)
    model = build_trainable_model(params, bn_state, cfg, device)
    optimizer = make_optimizer(optimizer_type, trainable_parameters(model).values(), lr, momentum)
    return TrainState(model, optimizer, flips, mesh=mesh)


def _compute_params(model: CaptionerModel, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Every float parameter but the BatchNorms' cast to ``dtype``; the
    casts of trainable ones stay in the graph."""
    bn = {name for name, m in model.named_modules() if isinstance(m, BatchNorm)}
    return {n: p.to(dtype) for n, p in model.named_parameters() if n.rpartition(".")[0] not in bn}


def _on(device: torch.device, *arrays):
    return [torch.as_tensor(a).to(device, non_blocking=True) for a in arrays]


def _local_rows(mesh: Mesh, images_u8, captions, lengths):
    """This rank's rows of a data-parallel batch.  ``captions`` and
    ``lengths`` are the global batch's (the loader's metadata); ``images_u8``
    is the global batch too, or already this rank's rows (the
    process-sharded loader decodes only those)."""
    rows = shard_rows(mesh, len(captions))
    if len(images_u8) == len(captions):
        images_u8 = images_u8[rows]
    elif len(images_u8) != rows.stop - rows.start:
        raise ValueError("images hold %d rows: neither the batch's %d nor this rank's %d"
                         % (len(images_u8), len(captions), rows.stop - rows.start))
    return images_u8, captions[rows], lengths[rows]


def make_train_step(
    cfg: CaptionerConfig, augment: bool = True, compute_dtype: str = "float32"
) -> Callable[[TrainState, Any, Any, Any], torch.Tensor]:
    """Returns step(ts, images_u8, captions, lengths) -> the loss (a 0-dim
    f32 tensor on the device; the caller's ``float()`` is its sync).  The
    batch may be numpy or tensors on any device.  augment=False skips the
    flips (lockstep tests: they cannot match the JAX package's draws).
    Under a data-parallel ``ts.mesh`` the batch is the global one
    (``_local_rows``) and the loss the global batch's."""
    dtype = COMPUTE_DTYPES[compute_dtype]

    def step(ts: TrainState, images_u8, captions, lengths) -> torch.Tensor:
        model, mesh = ts.model, ts.mesh
        model.train()
        shard = batch_lengths = None
        if mesh is not None:
            batch_lengths = _on(ts.device, lengths)[0]  # the global batch's: the loss's denominators
            images_u8, captions, lengths = _local_rows(mesh, images_u8, captions, lengths)
            shard = (mesh.dp_rank, mesh.dp)
        images_u8, captions, lengths = _on(ts.device, images_u8, captions, lengths)
        with exact_f32_math(ts.device):
            images = preprocess_images(images_u8, ts.generator if augment else None, augment, shard=shard)
            ts.optimizer.zero_grad(set_to_none=True)
            loss = ts.forward(images, captions, lengths, batch_lengths, dtype)  # under a mesh, this rank's share
            if mesh is None:
                loss.backward()
            else:
                (loss * mesh.dp).backward()  # DDP averages the gradients over the dp ranks
                loss = all_reduce_sum(loss.detach(), mesh)
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
    mesh: Optional[Mesh] = None,
    kernels: bool = True,
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
    ``generator``.  ``kernels=False`` decodes by the library route
    (``--use_pallas 0``: the plain decodes in PyTorch's operators, no
    kernel; ``prepared`` unused); nothing else in the step changes.

    ``ts.model`` computes in ``compute_dtype`` ("bfloat16": a model whose
    weights the caller cast, and the images are cast to it).  ``prepared``:
    the kernels' weight layout (``prepare_decode``), which a caller that
    evaluates many batches of unchanged weights builds once; else it is
    built from the weights at each call, so an eval after an update or a
    restore decodes with the weights as they are.  ``t_max``: the longest
    caption length, where the caller has it on the host.  Neither the loss
    nor ``out`` is read on the host here (with ``t_max`` given and no
    ``early_exit``: no device sync), so a caller may queue the next batch
    before it reads them.  The model's mode is restored.

    ``mesh``: the sharded eval's mesh.  A batch whose rows divide over its
    dp axis is split: each dp rank runs its rows (the flips the whole batch
    draws for them), the loss is the sum of the dp ranks' shares and
    ``out`` their rows gathered in order, the same on every rank.  A batch
    that does not divide (the loader's last) runs whole on every rank, as
    the JAX package runs it replicated.  Under an mp axis ``ts.model``'s
    decoder holds this rank's vocabulary shard (``shard_train_state``): the
    loss and the decodes take their vocabulary-sized steps over the mp
    group (``decoder_loss``, the decode routes)."""
    dtype = COMPUTE_DTYPES[compute_dtype] or torch.float32
    mesh = active(mesh)

    def evaluate(ts: TrainState, images_u8, captions, lengths, generator: Optional[torch.Generator] = None,
                 prepared: Optional[Dict[str, object]] = None, t_max: Optional[int] = None):
        model = ts.model
        was_training = model.training
        model.eval()
        split = mesh if mesh is not None and len(captions) % mesh.dp == 0 else None
        shard = batch_lengths = None
        if split is not None:
            batch_lengths = _on(ts.device, lengths)[0]  # the whole batch's: the loss's denominators
            images_u8, captions, lengths = shard_batch(split, images_u8, captions, lengths)
            shard = (split.dp_rank, split.dp)
        try:
            images_u8, captions, lengths = _on(ts.device, images_u8, captions, lengths)
            with torch.no_grad(), exact_f32_math(ts.device):
                images = preprocess_images(images_u8, generator, augment, dtype, shard=shard)
                feats = encode(model, images)
                loss = decoder_loss(model, cfg, feats, captions, lengths, t_max, batch_lengths)
                if loss_only:
                    out = feats
                else:
                    if prepared is None and kernels:
                        prepared = prepare_decode(model, dtype)
                    if beam_size > 0:
                        out = beam_decode_features(model, cfg, feats, prepared, beam_size, end_token, early_exit,
                                                   kernels=kernels)
                    else:
                        out = greedy_decode_features(model, cfg, feats, prepared, end_token if early_exit else None,
                                                     kernels=kernels)
                if split is not None:
                    loss, out = all_reduce_sum(loss, split), all_gather_rows(out, split)
        finally:
            model.train(was_training)
        return loss, out

    return evaluate
