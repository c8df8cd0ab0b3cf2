"""The captioner: encoder + decoder (counterpart of
show_tell_tpu/models/captioner.py).

All four families of the reference, greedy and beam serving:

  variant 'gru'       ResNet pooled [B, E]      -> GRU decoder    (main.py)
  variant 'lstm'      ResNet pooled [B, E]      -> LSTM decoder   (LSTM/main_lstm.py)
  variant 'attn'      ResNet spatial [B, C, 49] -> attention GRU  (Attention/main_attn.py)
  variant 'attn_lstm' ResNet spatial [B, C, 49] -> attention LSTM (Attention/main_attn_LSTM.py)

Serving builds a frozen model in eval mode (``build_model``).  Training
builds one in train mode (``build_trainable_model``) whose trainable
parameters are the reference's (main.py:96): the decoder, the encoder's
Linear head and its BN1d; the backbone is frozen, but its BN running
statistics move.  ``captioner_loss`` is the teacher-forced loss.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from show_tell_tpu_torch.models.attention import (
    AttnDecoder,
    AttnDecoderConfig,
    attn_decoder_forward,
    attn_greedy_decode,
    doubly_stochastic_penalty,
)
from show_tell_tpu_torch.models.decoder import (
    GATES,
    Decoder,
    DecoderConfig,
    decoder_forward,
    greedy_decode,
    masked_cross_entropy,
)
from show_tell_tpu_torch.models.encoder import Encoder, EncoderConfig
from show_tell_tpu_torch.models.resnet import RESNET_SPECS, STAGE_WIDTHS, feature_dim


class CaptionerConfig(NamedTuple):
    variant: str  # 'gru' | 'lstm' | 'attn' | 'attn_lstm'
    resnet_version: int
    embed_dim: int
    hidden_dim: int
    vocab_size: int
    num_layers: int
    nos_filters: int = 2048
    attn_dim: int = 512
    alpha_c: float = 1.0
    max_caption_length: int = 25
    start_token: int = 1
    attn_next_token: bool = False

    @property
    def is_attention(self) -> bool:
        return self.variant in ("attn", "attn_lstm")

    @property
    def cell_type(self) -> str:
        return "gru" if self.variant in ("gru", "attn") else "lstm"

    def encoder_config(self) -> EncoderConfig:
        return EncoderConfig(self.resnet_version, self.embed_dim, spatial=self.is_attention)

    def decoder_config(self) -> Union[DecoderConfig, AttnDecoderConfig]:
        if self.is_attention:
            return AttnDecoderConfig(
                self.cell_type, self.embed_dim, self.nos_filters, self.attn_dim, self.hidden_dim,
                self.vocab_size, self.num_layers, self.max_caption_length,
            )
        return DecoderConfig(
            self.cell_type, self.embed_dim, self.hidden_dim, self.vocab_size,
            self.num_layers, self.max_caption_length,
        )


class CaptionerModel(nn.Module):
    def __init__(self, cfg: CaptionerConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg.encoder_config())
        self.decoder = (AttnDecoder if cfg.is_attention else Decoder)(cfg.decoder_config())

    def forward(self, images: torch.Tensor, captions: torch.Tensor, lengths: torch.Tensor,
                batch_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The teacher-forced loss (``captioner_loss``) of normalized float images."""
        return captioner_loss(self, self.cfg, images, captions, lengths, batch_lengths=batch_lengths)


# The trainable parameters (reference main.py:96): the decoder and the encoder's head.
TRAINABLE_PREFIXES = ("decoder.", "encoder.linear_secondlast_layer.", "encoder.last_layer.")


def trainable_parameters(model: CaptionerModel) -> Dict[str, nn.Parameter]:
    """{name: parameter} of the trainable split, in the model's order (the
    JAX package's ``split_trainable``: the decoder, ``linear_secondlast_layer``
    and ``last_layer``); every other parameter is the frozen backbone's."""
    return {n: p for n, p in model.named_parameters() if n.startswith(TRAINABLE_PREFIXES)}


def captioner_loss(
    model: CaptionerModel,
    cfg: CaptionerConfig,
    images: torch.Tensor,  # [B, H, W, 3] normalized float, NHWC
    captions: torch.Tensor,  # [B, T] int
    lengths: torch.Tensor,  # [B] int
    t_max: Optional[int] = None,
    batch_lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Teacher-forced loss (captioner.captioner_loss in the JAX package):
    the encoder in the model's mode (in train mode its BatchNorms move their
    running statistics in place), then ``decoder_loss`` of its features."""
    return decoder_loss(model, cfg, model.encoder(images), captions, lengths, t_max, batch_lengths)


def decoder_loss(
    model: CaptionerModel,
    cfg: CaptionerConfig,
    feats: torch.Tensor,  # the encoder's features: [B, E] pooled, [B, C, P] spatial
    captions: torch.Tensor,  # [B, T] int
    lengths: torch.Tensor,  # [B] int
    t_max: Optional[int] = None,
    batch_lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The loss of ``captioner_loss`` from the encoder's features: masked
    CE, which equals the reference's packed CE, plus alpha_c times the
    doubly-stochastic penalty for the attention families
    (main_attn.py:130-131).  The attention families take the reference's
    w_t -> w_t alignment, or with ``attn_next_token`` step t predicting
    w_{t+1} over t < length - 1.

    Captions are cut to the longest length first: every later position is
    masked out of each term and the recurrence is causal, so the loss and
    its gradients are those of the padded batch, without the dead steps.
    ``t_max``: that length, where the caller has it on the host; else it is
    read from ``lengths`` (a device sync for lengths on a GPU).

    ``batch_lengths``: the lengths of the whole batch where these rows are
    one data-parallel rank's share of it; the terms' denominators then
    count that batch's tokens and rows, so the ranks' losses sum to the
    whole batch's.  Each rank cuts at its own longest caption: the cut
    drops only masked positions.

    A decoder that holds a vocabulary shard (an mp mesh's eval,
    ``parallel.mesh.decoder_vocab_shard``) computes its columns of the
    logits; the CE's logsumexp and target logits are then taken over the
    mp group (``masked_cross_entropy``'s ``shard``)."""
    if t_max is None:
        t_max = int(lengths.max())
    captions = captions[:, : max(t_max, 1)]
    count = rows = None
    if batch_lengths is not None:  # every length is within its rank's cut, so the tokens are their sum
        rows = len(batch_lengths)
        count = batch_lengths.sum().float()
    shard = getattr(model.decoder, "vocab_shard", None)
    if not cfg.is_attention:
        logits = decoder_forward(model.decoder, cfg.decoder_config(), feats, captions, lengths)
        return masked_cross_entropy(logits, captions, lengths, count, shard)
    if cfg.attn_next_token:
        lengths = (lengths - 1).clamp(min=0)
        targets = torch.cat([captions[:, 1:], torch.zeros_like(captions[:, :1])], dim=1)
        if batch_lengths is not None:
            count = (batch_lengths - 1).clamp(min=0).sum().float()
    else:
        targets = captions
    preds, alphas = attn_decoder_forward(model.decoder, cfg.decoder_config(), feats, captions, lengths)
    return (masked_cross_entropy(preds, targets, lengths, count, shard)
            + cfg.alpha_c * doubly_stochastic_penalty(alphas, rows))


def init_captioner(cfg: CaptionerConfig, generator: torch.Generator) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Random weights by the JAX package's init laws, drawn from
    ``generator``, as (params, bn_state) numpy trees in the JAX layout
    (so either package can load them): kaiming-normal fan_out convs,
    N(0, 0.05) head weight, U(+-1/sqrt(fan_in)) head bias and attention
    linears, U(+-1/sqrt(H)) recurrence (3H gate rows for the GRU, 4H for
    the LSTM) and projection, N(0, 1) embedding, BN at identity."""
    if cfg.is_attention:
        # The spatial channels are the backbone's (captioner.py:79-90 in the JAX package).
        expected = feature_dim(cfg.resnet_version)
        if cfg.nos_filters != expected:
            raise ValueError(
                "nos_cnn_filters=%d does not match ResNet-%d's spatial feature channels (%d); "
                "pass --nos_cnn_filters %d" % (cfg.nos_filters, cfg.resnet_version, expected, expected)
            )
    g = generator

    def normal(shape, std=1.0):
        return (torch.randn(shape, generator=g) * std).numpy()

    def uniform(shape, bound):
        return ((torch.rand(shape, generator=g) * 2.0 - 1.0) * bound).numpy()

    kind, stages = RESNET_SPECS[cfg.resnet_version]
    res_p: Dict[str, np.ndarray] = {}
    res_s: Dict[str, np.ndarray] = {}

    def conv(name, k, cin, cout):
        res_p[name + ".weight"] = normal((k, k, cin, cout), float(np.sqrt(2.0 / (k * k * cout))))

    def bn(name, c):
        res_p[name + ".weight"] = np.ones(c, np.float32)
        res_p[name + ".bias"] = np.zeros(c, np.float32)
        res_s[name + ".running_mean"] = np.zeros(c, np.float32)
        res_s[name + ".running_var"] = np.ones(c, np.float32)

    conv("conv1", 7, 3, 64)
    bn("bn1", 64)
    cin = 64
    for s, n_blocks in enumerate(stages):
        width = STAGE_WIDTHS[s]
        cout = width if kind == "basic" else width * 4
        for b in range(n_blocks):
            pre = "layer%d.%d" % (s + 1, b)
            stride = 2 if (b == 0 and s > 0) else 1
            convs = [(3, cin, width), (3, width, width)] if kind == "basic" else [
                (1, cin, width), (3, width, width), (1, width, cout)]
            for i, (k, ci, co) in enumerate(convs, start=1):
                conv("%s.conv%d" % (pre, i), k, ci, co)
                bn("%s.bn%d" % (pre, i), co)
            if stride != 1 or cin != cout:
                conv(pre + ".downsample.0", 1, cin, cout)
                bn(pre + ".downsample.1", cout)
            cin = cout

    C, E, H, V = feature_dim(cfg.resnet_version), cfg.embed_dim, cfg.hidden_dim, cfg.vocab_size
    I0 = 2 * E if cfg.is_attention else E
    GH = GATES[cfg.cell_type] * H

    def linear(d_in, d_out):
        bound = 1.0 / d_in ** 0.5
        return {"w": uniform((d_in, d_out), bound), "b": uniform((d_out,), bound)}

    params = {
        "encoder": {
            "resnet": res_p,
            "linear_secondlast_layer": {"w": normal((C, E), 0.05), "b": uniform((E,), 1.0 / C ** 0.5)},
            "last_layer": {"weight": np.ones(E, np.float32), "bias": np.zeros(E, np.float32)},
        },
        "decoder": {
            "embedding": normal((V, E)),
            "rnn": [
                {
                    "w_ih": uniform((I0 if l == 0 else H, GH), 1.0 / H ** 0.5),
                    "w_hh": uniform((H, GH), 1.0 / H ** 0.5),
                    "b_ih": uniform((GH,), 1.0 / H ** 0.5),
                    "b_hh": uniform((GH,), 1.0 / H ** 0.5),
                }
                for l in range(cfg.num_layers)
            ],
            "linear": linear(H, V),
        },
    }
    if cfg.is_attention:
        N, A = cfg.nos_filters, cfg.attn_dim
        params["decoder"].update({
            "init_h": linear(N, H),
            "embed": linear(N, E),
            "attn": {"encoder_att": linear(N, A), "decoder_att": linear(H, A), "full_att": linear(A, 1)},
        })
        if cfg.cell_type == "lstm":
            params["decoder"]["init_c"] = linear(N, H)
    bn_state = {
        "resnet": res_s,
        "last_layer": {"running_mean": np.zeros(E, np.float32), "running_var": np.ones(E, np.float32)},
    }
    return params, bn_state


def _model_from_trees(
    params: Dict[str, Any], bn_state: Dict[str, Any], cfg: CaptionerConfig, dtype: torch.dtype,
    device: torch.device,
) -> CaptionerModel:
    from show_tell_tpu_torch.models.convert import params_from_jax

    sds = params_from_jax(params, bn_state)
    with torch.device("meta"):  # no default init: every tensor comes from the trees
        model = CaptionerModel(cfg)
    for name in ("encoder", "decoder"):
        sd = {k: torch.from_numpy(np.array(v)) for k, v in sds[name].items()}  # own, writable copies
        getattr(model, name).load_state_dict(sd, strict=True, assign=True)
    model = model.to(device=device, dtype=dtype)
    model.encoder.resnet.to(memory_format=torch.channels_last)
    return model


def build_model(
    params: Dict[str, Any],
    bn_state: Dict[str, Any],
    cfg: CaptionerConfig,
    dtype: torch.dtype,
    device: torch.device,
) -> CaptionerModel:
    """A CaptionerModel on ``device`` holding the JAX-layout trees'
    weights; every float32 parameter and BN statistic is cast to ``dtype``."""
    return _model_from_trees(params, bn_state, cfg, dtype, device).eval().requires_grad_(False)


def build_trainable_model(
    params: Dict[str, Any], bn_state: Dict[str, Any], cfg: CaptionerConfig, device: torch.device
) -> CaptionerModel:
    """A CaptionerModel for training on ``device``: f32 weights and BN
    statistics from the JAX-layout trees, train mode, gradients on the
    trainable split (``trainable_parameters``) only."""
    model = _model_from_trees(params, bn_state, cfg, torch.float32, device).train().requires_grad_(False)
    for p in trainable_parameters(model).values():
        p.requires_grad_(True)
    return model


def model_trees(model: CaptionerModel) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The inverse of ``build_model``: the model's weights and BN statistics
    as (params, bn_state) numpy trees in the JAX layout."""
    from show_tell_tpu_torch.models.convert import params_to_jax

    return params_to_jax({name: {k: v.detach().cpu().numpy() for k, v in getattr(model, name).state_dict().items()}
                          for name in ("encoder", "decoder")})


def prepare_decode(model: CaptionerModel, dtype: torch.dtype) -> Dict[str, object]:
    """The decode kernels' weights in kernel layout, built once per model;
    where the decoder holds a vocabulary shard, also "shard" (its
    parallel.mesh.VocabShard), which sends every decode by the sharded
    routes."""
    from show_tell_tpu_torch.ops.fused_attn import prepare_attn_weights
    from show_tell_tpu_torch.ops.rnn import prepare_greedy

    dec = model.decoder
    if isinstance(dec, AttnDecoder):
        prepared = prepare_attn_weights(dec, dtype)
    else:
        prepared = prepare_greedy(dec.unit.layers(), dec.embeddings.weight, dec.linear.weight, dec.linear.bias,
                                  dtype)
    if getattr(dec, "vocab_shard", None) is not None:
        prepared["shard"] = dec.vocab_shard
    return prepared


def exact_f32_convs(weight: torch.Tensor):
    """A context in which cuDNN runs the convolutions of ``weight``'s model
    in full f32 where that is its dtype on a GPU.  cuDNN takes f32
    convolutions in TF32 by default (``torch.backends.cudnn.allow_tf32``),
    which keeps about three decimal digits: neither the JAX package's f32
    nor the reference's.  Scoped: the global flags are as the caller left
    them outside it.  bf16 and the CPU run as they are."""
    if weight.dtype != torch.float32 or weight.device.type != "cuda":
        return contextlib.nullcontext()
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, benchmark_limit=None,
                       deterministic=cudnn.deterministic, allow_tf32=False)


@contextlib.contextmanager
def exact_f32_math(device: torch.device):
    """``exact_f32_convs`` for every convolution and, through
    ``torch.set_float32_matmul_precision("highest")``, every f32 matmul
    (cuBLAS) on a CUDA ``device``: the train step's f32 is the JAX
    package's.  Scoped: the flags are as the caller left them outside it.
    The CPU runs as it is."""
    if device.type != "cuda":
        yield
        return
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with exact_f32_convs(torch.empty(0, device=device)):
            yield
    finally:
        torch.set_float32_matmul_precision(precision)


def encode(model: CaptionerModel, images: torch.Tensor, s2d: bool = False) -> torch.Tensor:
    """Features of uint8 pixels through the encoder's serving entry
    (``Encoder.encode_u8``: the preprocess kernel, or under s2d the stem
    kernel), or of normalized float images through the plain forward; an
    f32 model's convolutions in full f32 (``exact_f32_convs``)."""
    with exact_f32_convs(model.encoder.resnet.conv1.weight):
        if images.dtype == torch.uint8:
            return model.encoder.encode_u8(images, s2d=s2d)
        return model.encoder(images)


def captioner_greedy_decode(
    model: CaptionerModel,
    cfg: CaptionerConfig,
    images: torch.Tensor,  # uint8 [B,224,224,3] (s2d: or [B,112,112,12]), or normalized float
    prepared: Optional[Dict[str, object]] = None,
    end_token: Optional[int] = None,
    s2d: bool = False,
    vocab_sharded: bool = False,
) -> torch.Tensor:
    """Eval-mode encode + 25-step batched greedy decode -> [B, 25] int32
    ids, through the kernels on a CUDA device (their plain twins on the
    CPU).  uint8 images enter through ``encode`` (s2d routes the stem);
    normalized float images skip the preprocess.  ``prepared``:
    ``prepare_decode(model, dtype)``, cached by the caller; built here when
    absent.

    Dispatch (captioner.py:160-262 in the JAX package): the pooled GRU
    and LSTM take ``greedy_decode_kernel``: one fused-step launch per token
    (or the whole-decode kernel where ``whole_decode_default()`` says so).
    Attention runs the fused attention step (its GRU or LSTM instance) when
    H <= 2E (``fused_attn_fits``), else the composite path: the attention
    context kernel, plain embed and recurrence products, and the projection
    + argmax kernel.  The JAX package keeps the pooled LSTM on its XLA scan
    by a TPU measurement; here it takes the kernel like the GRU.

    A sharded projection, ``vocab_sharded`` on one device or a decoder that
    holds an mp mesh's vocabulary shard (``prepared["shard"]``), takes the
    stack-step kernel with the projection outside it in every family, after
    the attention context kernel in the attention families; the fused steps,
    the projection + argmax kernel and the whole decode are never chosen
    there."""
    return greedy_decode_features(model, cfg, encode(model, images, s2d), prepared, end_token, vocab_sharded)


def greedy_decode_features(
    model: CaptionerModel,
    cfg: CaptionerConfig,
    feats: torch.Tensor,  # the encoder's features: [B, E] pooled, [B, C, P] spatial
    prepared: Optional[Dict[str, object]] = None,
    end_token: Optional[int] = None,
    vocab_sharded: bool = False,
    kernels: bool = True,
) -> torch.Tensor:
    """The decode of ``captioner_greedy_decode`` from the encoder's features.

    ``kernels=False`` is the eval's ``--use_pallas 0`` route, the JAX
    package's XLA decode (captioner.py:243,262 there): the plain decode of
    the model's own weights in PyTorch's operators, the pooled families'
    ``models.decoder.greedy_decode`` and the attention families'
    ``models.attention.attn_greedy_decode``, which take a vocabulary shard's
    logits over the mp group; ``prepared`` and ``vocab_sharded`` are unused
    there.  No kernel of this package runs, nor its twin."""
    from show_tell_tpu_torch.ops.attention import attn_greedy_decode_composite
    from show_tell_tpu_torch.ops.fused_attn import attn_greedy_decode_fused, fused_attn_fits
    from show_tell_tpu_torch.ops.rnn import greedy_decode_kernel

    if not kernels:
        if cfg.is_attention:
            return attn_greedy_decode(model.decoder, cfg.decoder_config(), feats, cfg.start_token, end_token)
        return greedy_decode(model.decoder, cfg.decoder_config(), feats, end_token)
    if prepared is None:
        prepared = prepare_decode(model, model.decoder.embeddings.weight.dtype)
    if cfg.is_attention:
        sharded = vocab_sharded or prepared.get("shard") is not None
        if not sharded and fused_attn_fits(cfg.hidden_dim, cfg.embed_dim):
            return attn_greedy_decode_fused(prepared, model.decoder, cfg.decoder_config(), feats, cfg.start_token,
                                            end_token=end_token)
        return attn_greedy_decode_composite(prepared, model.decoder, cfg.decoder_config(), feats, cfg.start_token,
                                            end_token=end_token, vocab_sharded=sharded)
    return greedy_decode_kernel(prepared, feats, cfg.max_caption_length, end_token=end_token,
                                vocab_sharded=vocab_sharded)


def captioner_beam_decode(
    model: CaptionerModel,
    cfg: CaptionerConfig,
    images: torch.Tensor,  # uint8 [B,224,224,3] (s2d: or [B,112,112,12]), or normalized float
    prepared: Optional[Dict[str, object]] = None,
    beam_size: int = 3,
    end_token: int = 2,
    early_exit: bool = False,
    s2d: bool = False,
) -> torch.Tensor:
    """Eval-mode encode (``encode``, as in ``captioner_greedy_decode``) +
    batched beam search of width ``beam_size`` ->
    [B, 25] int32 ids (the best hypothesis of each image; <pad> after its
    <end>), through the beam kernels on a CUDA device (their plain twins on
    the CPU).  The dispatch is show_tell_tpu/serve.py's: the pooled
    families take ``beam_search_decode`` with the step route that
    ``ops.beam_step_default()`` names (dense or top-k), the attention
    families ``attn_beam_search_decode`` with the fused dense step (the
    composite for an attention model with H > 2E).  Beams retire on
    ``end_token``; early_exit stops once all have (identical ids)."""
    return beam_decode_features(model, cfg, encode(model, images, s2d), prepared, beam_size, end_token, early_exit)


def beam_decode_features(
    model: CaptionerModel,
    cfg: CaptionerConfig,
    feats: torch.Tensor,  # the encoder's features: [B, E] pooled, [B, C, P] spatial
    prepared: Optional[Dict[str, object]] = None,
    beam_size: int = 3,
    end_token: int = 2,
    early_exit: bool = False,
    kernels: bool = True,
) -> torch.Tensor:
    """The beam search of ``captioner_beam_decode`` from the encoder's
    features.  ``kernels=False``: the library route of decode/beam.py, the
    JAX package's XLA beam (``prepared`` unused)."""
    from show_tell_tpu_torch.decode.beam import (
        attn_beam_search_decode,
        beam_search_decode,
        library_attn_beam_search_decode,
        library_beam_search_decode,
    )
    from show_tell_tpu_torch.ops import beam_step_default

    if not kernels:
        if cfg.is_attention:
            return library_attn_beam_search_decode(model.decoder, cfg.decoder_config(), feats, beam_size,
                                                   cfg.start_token, end_token=end_token, early_exit=early_exit)
        return library_beam_search_decode(model.decoder, cfg.decoder_config(), feats, beam_size, end_token=end_token,
                                          early_exit=early_exit)
    if prepared is None:
        prepared = prepare_decode(model, model.decoder.embeddings.weight.dtype)
    if cfg.is_attention:
        return attn_beam_search_decode(prepared, model.decoder, cfg.decoder_config(), feats, beam_size,
                                       cfg.start_token, end_token=end_token, early_exit=early_exit)
    return beam_search_decode(prepared, cfg.decoder_config(), feats, beam_size, end_token=end_token,
                              fused_step=beam_step_default(), early_exit=early_exit)
