"""The fused step's CUDA kernel against its plain twin, on an NVIDIA GPU.

Marked ``cuda``: each test skips where torch finds no CUDA device (the
kernel has no CPU or interpret mode).  Run them on the card with
``python -m pytest tests/test_torch_cuda.py -m cuda``; chip_smoke.py runs
the same comparison at the flagship widths.
"""

import numpy as np
import pytest
import torch

from show_tell_tpu_torch.ops.fused_step import (
    fused_gru_decode_step,
    fused_gru_decode_step_cuda,
    fused_gru_decode_step_plain,
)
from show_tell_tpu_torch.ops.rnn import prepare_rnn_weights
from show_tell_tpu_torch.ops.vocab import prepare_vocab

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused step kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, E, H, V, L, dtype, device, seed=0):
    rng = np.random.RandomState(seed)
    t = lambda *s: torch.from_numpy(rng.uniform(-0.3, 0.3, s).astype(np.float32))
    layers = [{"w_ih": t(3 * H, E if l == 0 else H), "w_hh": t(3 * H, H), "b_ih": t(3 * H), "b_hh": t(3 * H)}
              for l in range(L)]
    stacked = {k: v.to(device) for k, v in prepare_rnn_weights(layers, dtype).items()}
    vocab = {k: v.to(device) for k, v in prepare_vocab(t(V, H), t(V), dtype).items()}
    x = torch.from_numpy(rng.randn(B, E).astype(np.float32)).to(device, dtype)
    hs = torch.from_numpy(rng.uniform(-1, 1, (L, B, H)).astype(np.float32)).to(device, dtype)
    return stacked, vocab, x, hs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,E,H,V,L", [(3, 16, 24, 40, 2), (19, 64, 128, 1001, 3), (1, 256, 512, 9956, 5)])
def test_kernel_matches_plain(cuda, dtype, B, E, H, V, L):
    stacked, vocab, x, hs = _inputs(B, E, H, V, L, dtype, cuda)
    before = fused_gru_decode_step.launches
    tok, new_hs = fused_gru_decode_step(stacked, vocab, x, hs)
    torch.cuda.synchronize()
    assert fused_gru_decode_step.launches == before + 1
    ref_tok, ref_hs = fused_gru_decode_step_plain(stacked, vocab, x, hs)
    tol = 1e-5 if dtype == torch.float32 else 2e-2  # summation order; one bf16 ulp in h'
    torch.testing.assert_close(new_hs.float(), ref_hs.float(), rtol=tol, atol=tol)
    logits = ref_hs[-1].float() @ vocab["w"].float().T + vocab["b"].float()
    top = logits.topk(2, dim=-1).values
    clear = (top[:, 0] - top[:, 1]) > (1e-4 if dtype == torch.float32 else 5e-2)
    assert torch.equal(tok[clear], ref_tok[clear])


def test_kernel_tie_takes_lowest_index(cuda):
    stacked, vocab, x, hs = _inputs(33, 16, 24, 1000, 2, torch.float32, cuda, seed=1)
    vocab["w"][900] = vocab["w"][7]
    vocab["b"][7] = vocab["b"][900] = 50.0
    tok, _ = fused_gru_decode_step(stacked, vocab, x, hs)
    assert tok.tolist() == [7] * 33


def test_kernel_wrapper_rejects_what_it_does_not_take(cuda):
    stacked, vocab, x, hs = _inputs(3, 16, 24, 40, 2, torch.float32, cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_gru_decode_step(stacked, vocab, x, hs.half())
    with pytest.raises(ValueError, match="dtype"):
        fused_gru_decode_step(stacked, vocab, x, hs.bfloat16())
    with pytest.raises(ValueError, match="shape"):
        fused_gru_decode_step_cuda(stacked, vocab, x, hs)  # x not padded to H
    with pytest.raises(ValueError, match="contiguous"):
        fused_gru_decode_step(stacked, vocab, x, hs.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="is on"):
        fused_gru_decode_step(stacked, vocab, x.cpu(), hs)
