"""The port's faithful beam (decode/faithful_beam.py: the reference's
in-class beam with its three quirks, GRU, batch 1) against the JAX
package's ``faithful_beam_decode``: its host loop bit for bit for several
beam widths, depths and seeds, its step within 1e-6; an LSTM decoder and
a batch of two raise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from show_tell_tpu.decode import faithful_beam as jax_faithful_beam
from show_tell_tpu.models import captioner as jax_captioner
from show_tell_tpu_torch.decode.faithful_beam import faithful_beam_decode
from show_tell_tpu_torch.models.captioner import CaptionerConfig, build_model, prepare_decode
from show_tell_tpu_torch.ops.rnn import gru_stack_plain
from show_tell_tpu_torch.ops.vocab import project_logits
from torch_train_helpers import few_torch_threads, np_tree  # noqa: F401 (an autouse fixture)


def _setup(variant, L, seed, E=16, H=24, V=40):
    jcfg = jax_captioner.CaptionerConfig(variant, 18, E, H, V, L)
    params, bn_state = np_tree(jax_captioner.init_captioner(jax.random.PRNGKey(seed), jcfg))
    model = build_model(params, bn_state, CaptionerConfig(*jcfg), torch.float32, torch.device("cpu"))
    return jcfg, params, prepare_decode(model, torch.float32)


def _port_step(prepared):
    """The port's faithful-beam step, in the JAX package's ``_gru_step`` signature."""

    def step(params, x, hs):
        top, hs2 = gru_stack_plain(prepared["stacked"], torch.from_numpy(np.array(x)), torch.from_numpy(np.array(hs)))
        return jnp.asarray(project_logits(prepared["vocab"], top).numpy()), jnp.asarray(hs2.numpy())

    return step


@pytest.mark.parametrize("L,seed", [(1, 0), (2, 3), (3, 5)])
@pytest.mark.parametrize("K", [1, 2, 3, 5])
def test_faithful_beam_loop_equals_the_jax_package(monkeypatch, K, L, seed):
    """The host loop (the first top-K, the shared state, ranking by the last
    raw logit, the stable sort) bit for bit: the JAX package's loop driven
    by the port's step gives the port's ids.  Random-weight beams converge
    on near-equal states, where XLA's and torch's f32 sums (logits up to
    about 1e-7 apart) order tied candidates differently, so the ids of two
    independent steps agree only where no such tie decides; the step itself
    is held to the JAX step below, and whole faithful-beam evals of a
    trained model to the JAX package's in tests/test_torch_eval.py."""
    jcfg, params, prepared = _setup("gru", L, seed)
    monkeypatch.setattr(jax_faithful_beam, "_gru_step", _port_step(prepared))
    rng = np.random.RandomState(seed + K)
    for _ in range(2):
        feats = rng.randn(1, jcfg.embed_dim).astype(np.float32)
        want = jax_faithful_beam.faithful_beam_decode(params["decoder"], jcfg.decoder_config(), jnp.asarray(feats), K)
        got = faithful_beam_decode(prepared, CaptionerConfig(*jcfg).decoder_config(), torch.from_numpy(feats), K)
        assert got.dtype == np.int32 and got.shape == (jcfg.max_caption_length,)
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("L,seed", [(1, 0), (3, 5)])
def test_faithful_beam_step_equals_the_jax_step(L, seed):
    """The port's step (plain stack + f32 projection) against the JAX
    package's jitted ``_gru_step`` along a chain of fed-back tokens: logits
    and the new state within 1e-6."""
    jcfg, params, prepared = _setup("gru", L, seed)
    rng = np.random.RandomState(seed)
    x = rng.randn(1, jcfg.embed_dim).astype(np.float32)
    hs = np.zeros((L, 1, jcfg.hidden_dim), np.float32)
    port = _port_step(prepared)
    for t in range(12):
        jl, jh = jax_faithful_beam._gru_step(params["decoder"], jnp.asarray(x), jnp.asarray(hs))
        pl, ph = port(None, x, hs)
        np.testing.assert_allclose(np.asarray(pl), np.asarray(jl), rtol=1e-6, atol=1e-6, err_msg="step %d" % t)
        np.testing.assert_allclose(np.asarray(ph), np.asarray(jh), rtol=1e-6, atol=1e-6, err_msg="step %d" % t)
        hs = np.asarray(jh)
        x = params["decoder"]["embedding"][[int(np.argmax(np.asarray(jl)[0]))]]


def test_faithful_beam_rejects_lstm_and_batches():
    jcfg, _, prepared = _setup("lstm", 1, 0)
    with pytest.raises(ValueError, match="GRU"):
        faithful_beam_decode(prepared, CaptionerConfig(*jcfg).decoder_config(), torch.zeros(1, 16), 2)
    jcfg, _, prepared = _setup("gru", 1, 0)
    with pytest.raises(ValueError, match="batch_size=1"):
        faithful_beam_decode(prepared, CaptionerConfig(*jcfg).decoder_config(), torch.zeros(2, 16), 2)
