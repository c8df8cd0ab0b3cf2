"""The f32 stack steps in split-precision TF32 (csrc/fused_step.cu's kNone end, tf32x3_step()), on the CPU.

The kernels run only on the card; what surrounds them runs here.  The f32
stack steps run the f32 greedy step's layers: each f32 operand split into
tf32 halves, each k8 step's three products summed from zero and added in
f32, the 16-column chunks split over four warps and the warps' sums added
in order, and each layer's K chunks split in parts s = 0 .. S - 1, part s
the run [s n / S, (s + 1) n / S), the parts added in order.  That layer is
re-enacted in numpy by test_torch_f32_tf32x3.py's ``tf32x3_layer`` and held,
at S = 1, 2 and 3 for every layer, to the port's plain stack
(``gru_stack_plain``, ``lstm_stack_plain``) and to the JAX package's
gru_stack_step_pallas / lstm_stack_step_pallas in interpret mode, at B = 1,
3, 33, E = 16, 24 and 40, H = 24, L = 1 and 3, tolerance 1e-5; at E = 40 > H,
which the Pallas stack steps refuse (they pad x up to H), to the JAX
package's own stack step (rnn_cells.stack_step), the route it takes there.
Also the launch arguments the f32 stack wrappers hand the C entry points
(the K split of ``stack_tiles`` in f32, the greedy step's at the same rows),
with the library replaced.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from show_tell_tpu.models.rnn_cells import stack_step as jax_stack_step
from show_tell_tpu.ops.rnn_pallas import gru_stack_step_pallas, lstm_stack_step_pallas
from show_tell_tpu.ops.rnn_pallas import prepare_rnn_weights as jax_prepare_rnn_weights
from show_tell_tpu_torch.ops.fused_step import fused_gru_decode_step_cuda, stack_tiles
from show_tell_tpu_torch.ops.rnn import gru_stack_step_cuda, lstm_stack_step_cuda, prepare_rnn_weights, stack_plain
from test_torch_beam_tf32x3 import fake_library  # noqa: F401 (a fixture)
from test_torch_f32_tf32x3 import SMS, STATE_TOL, tf32x3_layer
from torch_train_helpers import few_torch_threads  # noqa: F401 (an autouse fixture)

H = 24


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _states(state):
    return [np.asarray(s) for s in (state if isinstance(state, tuple) else (state,))]


def _case(cell, B, E, L, seed):
    """Torch-layout stacked weights, x [B, E] and the state, with the JAX package's layers and stacked weights and
    the numpy operands."""
    rng = np.random.RandomState(seed)
    u = lambda *s: rng.uniform(-0.3, 0.3, s).astype(np.float32)
    G = (4 if cell == "lstm" else 3) * H
    layers = [{"w_ih": u(E if l == 0 else H, G), "w_hh": u(H, G), "b_ih": u(G), "b_hh": u(G)} for l in range(L)]
    x = rng.randn(B, E).astype(np.float32)
    hs = rng.uniform(-1, 1, (L, B, H)).astype(np.float32)
    cs = rng.uniform(-2, 2, (L, B, H)).astype(np.float32)
    stacked = prepare_rnn_weights([{k: t(v.T) if v.ndim == 2 else t(v) for k, v in l.items()} for l in layers])
    jax_layers = [{k: jnp.asarray(v) for k, v in l.items()} for l in layers]
    state = (t(hs), t(cs)) if cell == "lstm" else t(hs)
    return stacked, t(x), state, jax_layers, (x, hs, cs)


def split_stack(cell, stacked, x, state, S):
    """The f32 stack step re-enacted with every layer's K split in S parts: (top [B, H], new state)."""
    npy = lambda v: v.numpy()
    hs, cs = (npy(state[0]), npy(state[1])) if cell == "lstm" else (npy(state), None)
    inp, new_h, new_c = npy(x), [], []
    for l in range(hs.shape[0]):
        w_ih = stacked["w_ih0"] if l == 0 else stacked["w_ihU"][l - 1]
        inp, c2 = tf32x3_layer(cell, inp, hs[l], None if cs is None else cs[l], npy(w_ih), npy(stacked["w_hh"][l]),
                               npy(stacked["b_ih"][l]), npy(stacked["b_hh"][l]), S=S)
        new_h.append(inp)
        new_c.append(c2)
    return inp, ((np.stack(new_h), np.stack(new_c)) if cell == "lstm" else np.stack(new_h))


@pytest.mark.parametrize("L", [1, 3])
@pytest.mark.parametrize("E", [16, 24, 40], ids=["E<H", "E=H", "E>H"])
@pytest.mark.parametrize("B", [1, 3, 33])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_f32_split_stack_matches_plain_and_pallas(cell, B, E, L):
    """At S = 1, 2 and 3 the re-enacted f32 stack step's new state is within
    1e-5 of the plain stack and of the interpreted stack-step kernel (E > H:
    of the JAX package's stack step), and its top activation is
    new_hs[L-1]."""
    stacked, x, state, jax_layers, (xn, hs, cs) = _case(cell, B, E, L, seed=11 * B + E + L)
    _, ref_state = stack_plain(cell)(stacked, x, state)
    j_state = (hs, cs) if cell == "lstm" else hs
    if E > H:
        _, j_state = jax_stack_step(cell)(jax_layers, jnp.asarray(xn), jax.tree.map(jnp.asarray, j_state))
    elif cell == "lstm":
        _, j_state = lstm_stack_step_pallas(jax_prepare_rnn_weights(jax_layers), jnp.asarray(xn), jnp.asarray(hs),
                                            jnp.asarray(cs), interpret=True)
    else:
        _, j_state = gru_stack_step_pallas(jax_prepare_rnn_weights(jax_layers), jnp.asarray(xn), jnp.asarray(hs),
                                           interpret=True)
    for S in (1, 2, 3):
        top, new_state = split_stack(cell, stacked, x, state, S)
        np.testing.assert_array_equal(top, _states(new_state)[0][-1])
        for got, ref, jref in zip(_states(new_state), _states(ref_state), _states(j_state)):
            np.testing.assert_allclose(got, ref, rtol=STATE_TOL, atol=STATE_TOL, err_msg="S=%d" % S)
            np.testing.assert_allclose(got, jref, rtol=STATE_TOL, atol=STATE_TOL, err_msg="S=%d" % S)


FLAGSHIP_ROWS = [1, 32, 64, 512]


@pytest.mark.parametrize("E", [0, 1024], ids=["flagship-E", "E=1024"])
@pytest.mark.parametrize("B", FLAGSHIP_ROWS)
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_f32_stack_wrappers_hand_the_kernel_its_split(fake_library, cell, B, E):
    """gru_stack_step_cuda and lstm_stack_step_cuda on f32 operands at the
    flagship widths (E = 256 GRU, 512 LSTM, or the attention families'
    2E = 1024 under --mp; H = 512, L = 5): the C entry point gets (by its
    parameter names, as many arguments as build.py declares) dtype 0 and
    the layers' K split of stack_tiles in f32 (s0, su, max_parts; partial
    and arrivals where S > 1, none at S = 1), the greedy step's at the same
    rows; a forced S is handed on for both layers, its scratch sized for it."""
    G = 4 if cell == "lstm" else 3
    E = E or (512 if cell == "lstm" else 256)
    z = lambda *s: torch.zeros(s, dtype=torch.float32)
    stacked = {"w_ih0": z(G * 512, E), "w_ihU": z(4, G * 512, 512), "w_hh": z(5, G * 512, 512),
               "b_ih": z(5, G * 512), "b_hh": z(5, G * 512)}
    state = (z(5, B, 512), z(5, B, 512)) if cell == "lstm" else z(5, B, 512)
    step = lstm_stack_step_cuda if cell == "lstm" else gru_stack_step_cuda
    top, new_state = step(stacked, z(B, E), state)
    step(stacked, z(B, E), state, splits=3)
    split = stack_tiles(B, E, 512, SMS, dtype=torch.float32)
    forced = stack_tiles(B, E, 512, SMS, splits=3, dtype=torch.float32)
    assert [name for name, _ in fake_library] == ["st_%s_stack_step" % cell] * 2
    for (_, args), tiles in zip(fake_library, (split, forced)):
        assert args["dtype"] == 0 and (args["L"], args["B"], args["E"], args["H"]) == (5, B, E, 512)
        assert (args["s0"], args["su"], args["max_parts"]) == (*tiles.splits, tiles.parts)
        assert (args["partial"] is None) == (tiles.parts == 0) and (args["arrivals"] is None) == (tiles.parts == 0)
    assert forced.splits == (3, 3) and forced.parts == split.items * 3
    assert split.splits == ((8, 8) if B <= 32 else (4, 4) if B == 64 else (1, 1))
    assert split.parts == (split.items * max(split.splits) if max(split.splits) > 1 else 0)
    new_hs = new_state[0] if cell == "lstm" else new_state
    assert tuple(new_hs.shape) == (5, B, 512) and top.data_ptr() == new_hs[4].data_ptr()


def test_only_the_bf16_steps_with_a_vocabulary_end_refuse_a_split(fake_library):
    """A forced S goes to the stack steps of both dtypes and to the f32
    steps; a bf16 step with a vocabulary end takes none and says so."""
    z = lambda *s, dtype=torch.bfloat16: torch.zeros(s, dtype=dtype)
    stacked = {"w_ih0": z(72, 16), "w_ihU": z(1, 72, 24), "w_hh": z(2, 72, 24), "b_ih": z(2, 72), "b_hh": z(2, 72)}
    vocab = {"w": z(40, 24), "b": z(40)}
    with pytest.raises(ValueError, match="the bf16 steps with a vocabulary end take none"):
        fused_gru_decode_step_cuda(stacked, vocab, z(3, 16), z(2, 3, 24), splits=2)
    gru_stack_step_cuda(stacked, z(3, 16), z(2, 3, 24), splits=2)
    f32 = {k: v.float() for k, v in stacked.items()}
    gru_stack_step_cuda(f32, z(3, 16, dtype=torch.float32), z(2, 3, 24, dtype=torch.float32), splits=2)
    assert [(args["dtype"], args["s0"], args["su"]) for _, args in fake_library] == [(1, 2, 2), (0, 2, 2)]
