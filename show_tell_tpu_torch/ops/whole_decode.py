"""The whole greedy decode of the pooled GRU in one CUDA kernel launch
(csrc/whole_decode.cu): all T steps, each the L-layer recurrence, the
vocab projection and the first-max argmax, with the winner's embedding row
fed back inside the kernel; its plain twin and a count of launches.

Counterpart of show_tell_tpu/ops/whole_decode_pallas.py::gru_whole_greedy_decode_pallas.
Fixed T (no early exit), GRU only, an unsharded projection; layer 0 reads
the features at their own width E.  Each step is the pooled GRU argmax
step's own code (ops/fused_step.py): in bf16 the tensor cores
(csrc/dense_mma.cuh, whose geometry ``mma_tiles`` checks before the
launch), in f32 the SIMT loops; so its ids are bit-equal to T launches of
that step with ``index_select`` between them.
"""

from __future__ import annotations

from typing import Dict

import torch

from show_tell_tpu_torch.ops import check_tensor, dtype_code, raise_on_error, stream_arg, uses_kernel
from show_tell_tpu_torch.ops.fused_step import check_stack, fused_gru_decode_step_plain, mma_step, mma_tiles


def gru_whole_greedy_decode_plain(prepared: Dict[str, object], feats: torch.Tensor, T: int) -> torch.Tensor:
    """The kernel's function in plain torch ops: T times ``gru_stack_plain``,
    ``project_argmax_plain`` and ``embedding.index_select``, from the
    features and a zero state in the compute dtype.  Returns [B, T] int32."""
    from show_tell_tpu_torch.models.decoder import greedy_loop
    from show_tell_tpu_torch.models.rnn_cells import init_state

    stacked, vocab, embedding = prepared["stacked"], prepared["vocab"], prepared["embedding"]
    L, _, H = stacked["w_hh"].shape
    hs0 = init_state("gru", L, feats.shape[0], H, embedding.dtype, feats.device)

    def step(x, hs):
        return fused_gru_decode_step_plain(stacked, vocab, x, hs)

    return greedy_loop(step, embedding, feats.to(embedding.dtype), hs0, T)


def gru_whole_greedy_decode_cuda(prepared: Dict[str, object], feats: torch.Tensor, T: int) -> torch.Tensor:
    """Launch the kernel on the current stream.  Every operand on one CUDA
    device in one dtype (float32 or bfloat16), contiguous, with E and H
    multiples of 8; the features are cast to the compute dtype.  Raises on
    anything else (in bf16 also on widths whose tensor-core tiles do not
    fit) and on a failed launch."""
    from show_tell_tpu_torch.ops.build import load_library

    kernel = "gru_whole_greedy_decode"
    stacked, vocab, emb = prepared["stacked"], prepared["vocab"], prepared["embedding"]
    L, GH, H = stacked["w_hh"].shape
    B, E = feats.shape
    V = emb.shape[0]
    dtype, device = emb.dtype, feats.device
    code = dtype_code(kernel, dtype)
    if GH != 3 * H:
        raise ValueError("%s takes the GRU's 3H gate rows, got w_hh %s" % (kernel, tuple(stacked["w_hh"].shape)))
    if T < 1 or V < 1:
        raise ValueError("%s needs T, V >= 1 (got T=%d V=%d)" % (kernel, T, V))
    hs0 = torch.zeros(L, B, H, dtype=dtype, device=device)
    check_stack(kernel, stacked, E, hs0, 3)
    x = feats.to(dtype, copy=True).contiguous()  # the features in; the kernel overwrites it with the fed-back rows
    check_tensor("feats", x, (B, E), dtype, device)
    check_tensor("embedding", emb, (V, E), dtype, device)
    check_tensor("vocab w", vocab["w"], (V, H), dtype, device)
    check_tensor("vocab b", vocab["b"], (V,), dtype, device)
    if mma_step(dtype, "argmax"):
        mma_tiles(B, E, H, V)
    hs1 = torch.empty_like(hs0)
    toks = torch.empty(B, T, dtype=torch.int32, device=device)
    best = torch.empty(B, dtype=torch.int64, device=device)
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.st_whole_gru_decode(
            code, x.data_ptr(), emb.data_ptr(), stacked["w_ih0"].data_ptr(), stacked["w_ihU"].data_ptr(),
            stacked["w_hh"].data_ptr(), stacked["b_ih"].data_ptr(), stacked["b_hh"].data_ptr(),
            vocab["w"].data_ptr(), vocab["b"].data_ptr(), hs0.data_ptr(), hs1.data_ptr(), toks.data_ptr(),
            best.data_ptr(), L, B, E, H, V, T, stream_arg(device),
        )
    raise_on_error(kernel, err)
    gru_whole_greedy_decode.launches += 1
    return toks


def gru_whole_greedy_decode(prepared: Dict[str, object], feats: torch.Tensor, T: int) -> torch.Tensor:
    """Greedy decode of T steps: ``prepare_greedy`` weights, features [B, E]
    -> [B, T] int32 ids, the ids of T fused steps with ``embedding[tok]``
    fed back.  CUDA tensors launch the kernel once (counted in
    ``gru_whole_greedy_decode.launches``); CPU tensors run the plain twin."""
    if uses_kernel(feats):
        return gru_whole_greedy_decode_cuda(prepared, feats, T)
    return gru_whole_greedy_decode_plain(prepared, feats, T)


gru_whole_greedy_decode.launches = 0
