"""The port's stack steps (ops/rnn.py ``gru_stack_step``, ``lstm_stack_step``)
and the sharded-projection route of the pooled captioner against the JAX
package, on the CPU.

The same seeded numpy inputs go through the JAX stack-step kernels in
interpret mode (as tests/test_pallas_ops.py runs them) and through the
port's wrappers, which run their plain twins for CPU tensors; f32.  The
JAX kernels take E <= H (they pad layer 0 up to H).  Sizes: B=3, E=16 and
24, H=24, L=1 and 3; the captioners ResNet-18, E=16, H=24, V=40, L=2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from show_tell_tpu.models import captioner as jax_captioner
from show_tell_tpu.ops.rnn_pallas import gru_stack_step_pallas, lstm_stack_step_pallas
from show_tell_tpu.ops.rnn_pallas import prepare_rnn_weights as jax_prepare_rnn_weights
from show_tell_tpu_torch.models.captioner import CaptionerConfig, build_model, captioner_greedy_decode, prepare_decode
from show_tell_tpu_torch.ops.rnn import gru_stack_step, lstm_stack_step, prepare_rnn_weights

B, H = 3, 24
GATES = {"gru": 3, "lstm": 4}


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _case(cell, E, L, seed):
    """JAX-layout layers (w_ih [in, G*H]), x [B, E], hs and cs [L, B, H]."""
    rng = np.random.RandomState(seed)
    u = lambda *s: rng.uniform(-0.3, 0.3, s).astype(np.float32)
    G = GATES[cell] * H
    layers = [{"w_ih": u(E if l == 0 else H, G), "w_hh": u(H, G), "b_ih": u(G), "b_hh": u(G)} for l in range(L)]
    return (layers, rng.randn(B, E).astype(np.float32), rng.uniform(-1, 1, (L, B, H)).astype(np.float32),
            rng.uniform(-2, 2, (L, B, H)).astype(np.float32))


def _both_sides(layers):
    jax_stacked = jax_prepare_rnn_weights([{k: jnp.asarray(v) for k, v in l.items()} for l in layers])
    port_stacked = prepare_rnn_weights([{k: t(v).T if v.ndim == 2 else t(v) for k, v in l.items()} for l in layers])
    return jax_stacked, port_stacked


@pytest.mark.parametrize("L", [1, 3])
@pytest.mark.parametrize("E", [16, 24], ids=["E<H", "E=H"])
def test_gru_stack_step_matches_pallas_interpret(E, L):
    layers, x, hs, _ = _case("gru", E, L, seed=10 * L + E)
    jax_stacked, stacked = _both_sides(layers)
    j_top, j_hs = gru_stack_step_pallas(jax_stacked, jnp.asarray(x), jnp.asarray(hs), interpret=True)
    before = gru_stack_step.launches
    top, new_hs = gru_stack_step(stacked, t(x), t(hs))
    assert gru_stack_step.launches == before  # CPU tensors: the plain twin, not counted
    assert tuple(new_hs.shape) == (L, B, H) and torch.equal(top, new_hs[-1])
    np.testing.assert_allclose(new_hs.numpy(), np.asarray(j_hs), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(top.numpy(), np.asarray(j_top), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("L", [1, 3])
@pytest.mark.parametrize("E", [16, 24], ids=["E<H", "E=H"])
def test_lstm_stack_step_matches_pallas_interpret(E, L):
    layers, x, hs, cs = _case("lstm", E, L, seed=20 * L + E)
    jax_stacked, stacked = _both_sides(layers)
    j_top, (j_hs, j_cs) = lstm_stack_step_pallas(jax_stacked, jnp.asarray(x), jnp.asarray(hs), jnp.asarray(cs),
                                                 interpret=True)
    before = lstm_stack_step.launches
    top, (new_hs, new_cs) = lstm_stack_step(stacked, t(x), (t(hs), t(cs)))
    assert lstm_stack_step.launches == before
    assert tuple(new_cs.shape) == (L, B, H) and torch.equal(top, new_hs[-1])
    np.testing.assert_allclose(new_hs.numpy(), np.asarray(j_hs), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(new_cs.numpy(), np.asarray(j_cs), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(top.numpy(), np.asarray(j_top), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", ["gru", "lstm"])
def test_vocab_sharded_captioner_bit_equal_to_jax(variant):
    """captioner_greedy_decode(vocab_sharded=True) on the pooled families:
    the stack step, the projection outside it and the argmax, with f32
    ids bit-equal to the JAX package's use_pallas=True, vocab_sharded=True
    decode (its stack-step kernels interpreted, its projection in XLA) and
    to the port's own fused-step route."""
    jcfg = jax_captioner.CaptionerConfig(variant, 18, 16, H, 40, 2)
    params, state = jax.tree.map(np.asarray, jax_captioner.init_captioner(jax.random.PRNGKey(3), jcfg))
    images = np.random.RandomState(4).randn(2, 64, 64, 3).astype(np.float32)
    ref = np.asarray(jax_captioner.captioner_greedy_decode(
        jax.tree.map(jnp.asarray, params), state, jcfg, jnp.asarray(images), use_pallas=True, vocab_sharded=True))
    cfg = CaptionerConfig(*jcfg)
    model = build_model(params, state, cfg, torch.float32, torch.device("cpu"))
    prepared = prepare_decode(model, torch.float32)
    with torch.inference_mode():
        got = captioner_greedy_decode(model, cfg, t(images), prepared, vocab_sharded=True).numpy()
        fused = captioner_greedy_decode(model, cfg, t(images), prepared).numpy()
    assert got.shape == (2, 25) and got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, fused)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("E", [16, 40], ids=["E<H", "E>H"])
def test_stack_step_equals_torch_rnn_step(cell, E):
    """One step of a multi-layer torch.nn.GRU / LSTM holding the stacked
    weights computes the stack step (PyTorch's gate order and both biases,
    layer 0 at its own width): the one library call chip_smoke.py times
    beside the stack-step kernels."""
    L = 3
    layers, x, hs, cs = _case(cell, E, L, seed=30 * L + E)
    stacked = prepare_rnn_weights([{k: t(v).T if v.ndim == 2 else t(v) for k, v in l.items()} for l in layers])
    rnn = (torch.nn.LSTM if cell == "lstm" else torch.nn.GRU)(E, H, L)
    with torch.no_grad():
        for l in range(L):
            getattr(rnn, "weight_ih_l%d" % l).copy_(stacked["w_ih0"] if l == 0 else stacked["w_ihU"][l - 1])
            getattr(rnn, "weight_hh_l%d" % l).copy_(stacked["w_hh"][l])
            getattr(rnn, "bias_ih_l%d" % l).copy_(stacked["b_ih"][l])
            getattr(rnn, "bias_hh_l%d" % l).copy_(stacked["b_hh"][l])
    with torch.inference_mode():
        if cell == "lstm":
            top, (new_hs, new_cs) = lstm_stack_step(stacked, t(x), (t(hs), t(cs)))
            out, (lib_hs, lib_cs) = rnn(t(x)[None], (t(hs), t(cs)))
            np.testing.assert_allclose(new_cs.numpy(), lib_cs.numpy(), rtol=1e-5, atol=1e-5)
        else:
            top, new_hs = gru_stack_step(stacked, t(x), t(hs))
            out, lib_hs = rnn(t(x)[None], t(hs))
    np.testing.assert_allclose(new_hs.numpy(), lib_hs.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(top.numpy(), out[0].numpy(), rtol=1e-5, atol=1e-5)
