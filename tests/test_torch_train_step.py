"""The port's optimizers and train step against the JAX package's, on the
CPU in f32: SGD and Adam updates over the same gradients, and an 8-step
lockstep of ``make_train_step(augment=False)`` for the four families with
SGD (per-step losses, the trainable parameters at the end, and the eval
step's greedy ids after the updates; Adam: test_torch_train_adam.py); the
bf16 step against the f32 one and the JAX package's bf16 step; and an eval
after updates decoding with the updated weights (no stale kernel layout
or stem operands).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from show_tell_tpu.train.optim import make_optimizer as jax_make_optimizer
from show_tell_tpu.train.train_step import make_train_step as jax_make_train_step
from show_tell_tpu_torch.data.transforms import preprocess_images
from show_tell_tpu_torch.models.captioner import build_model, captioner_greedy_decode, model_trees, prepare_decode
from show_tell_tpu_torch.ops.stem import prepare_stem
from show_tell_tpu_torch.train.optim import make_optimizer
from show_tell_tpu_torch.train.train_step import create_train_state, make_eval_step, make_train_step
from torch_train_helpers import CPU, VARIANTS, jax_cfg, jax_init, jax_train_state, make_batch, port_cfg, train_step_lockstep
from torch_train_helpers import few_torch_threads  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("optimizer", ["SGD", "Adam"])
def test_optimizer_updates_match_optax(optimizer):
    """Five updates from the same gradients: torch.optim against the JAX
    package's optax chain, within 1e-6."""
    rng = np.random.RandomState(0)
    shapes = {"w": (6, 5), "b": (5,), "e": (7, 3)}
    start = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()} for _ in range(5)]
    tx = jax_make_optimizer(optimizer, 0.01)
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    state = tx.init(jp)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in start.items()}
    opt = make_optimizer(optimizer, params.values(), 0.01)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)


def test_unknown_optimizer_raises_the_same_message():
    with pytest.raises(ValueError, match="Please specify a valid optimizer. RMSprop is invalid."):
        make_optimizer("RMSprop", [torch.nn.Parameter(torch.zeros(1))], 0.1)


@pytest.mark.parametrize("variant", VARIANTS)
def test_train_step_lockstep_sgd(variant):
    train_step_lockstep(variant, "SGD")


def test_bf16_step_mixed_precision():
    """train_dtype bfloat16: the loss falls over 12 Adam steps on one
    batch, every float tensor of the state (weights, BN statistics,
    optimizer moments) stays f32, and the first loss is within 5% + 0.05
    of the port's f32 step and of the JAX package's bf16 step (the JAX
    test's bar, tests/test_train_step.py)."""
    jcfg = jax_cfg("gru")
    cfg = port_cfg(jcfg)
    init = jax_init(jcfg)
    batch = make_batch(30)
    ts16 = create_train_state(cfg, "Adam", 1e-2, device="cpu", init=init)
    ts32 = create_train_state(cfg, "Adam", 1e-2, device="cpu", init=init)
    step16 = make_train_step(cfg, augment=False, compute_dtype="bfloat16")
    losses16 = [float(step16(ts16, *batch)) for _ in range(12)]
    loss32 = float(make_train_step(cfg, augment=False)(ts32, *batch))
    tx = jax_make_optimizer("Adam", 1e-2)
    _, jloss16 = jax_make_train_step(jcfg, tx, augment=False, compute_dtype=jnp.bfloat16)(
        jax_train_state(*init, tx), *batch)
    assert np.isfinite(losses16).all() and losses16[-1] < 0.8 * losses16[0], losses16
    for ref in (loss32, float(jloss16)):
        assert abs(losses16[0] - ref) < 0.05 * abs(ref) + 0.05, (losses16[0], ref)
    tensors = list(ts16.model.state_dict().values()) + [
        v for st in ts16.optimizer.state.values() for v in st.values() if torch.is_tensor(v)]
    assert all(t.dtype == torch.float32 for t in tensors if t.is_floating_point())


def test_eval_after_updates_uses_the_updated_weights():
    """The eval step's kernel weight layout and the encoder's stem operands
    are rebuilt after updates: after four SGD steps the eval ids differ from
    the first eval's and equal a fresh serving model's decode of the
    trained weights, and the stem operands equal those prepared from the
    trained (moved) bn1."""
    jcfg = jax_cfg("gru")
    cfg = port_cfg(jcfg)
    ts = create_train_state(cfg, "SGD", 0.5, device="cpu", init=jax_init(jcfg))
    images, captions, lengths = make_batch(31)
    evaluate = make_eval_step(cfg, augment=False)
    _, ids0 = evaluate(ts, images, captions, lengths)
    ts.model.eval()
    stem0 = {k: v.clone() for k, v in ts.model.encoder.stem_operands().items()}
    step = make_train_step(cfg, augment=False)
    for _ in range(4):
        step(ts, images, captions, lengths)
    _, ids1 = evaluate(ts, images, captions, lengths)
    fresh = build_model(*model_trees(ts.model), cfg, torch.float32, CPU)
    with torch.no_grad():
        x = preprocess_images(torch.from_numpy(images), augment=False)
        want = captioner_greedy_decode(fresh, cfg, x, prepare_decode(fresh, torch.float32))
    assert not np.array_equal(ids0.numpy(), ids1.numpy())
    np.testing.assert_array_equal(ids1.numpy(), want.numpy())
    ts.model.eval()
    stem1 = ts.model.encoder.stem_operands()
    for k, v in prepare_stem(fresh.encoder.resnet, torch.float32).items():
        np.testing.assert_array_equal(stem1[k].detach().numpy(), v.numpy(), err_msg=k)
        assert not torch.equal(stem0[k], v), k  # bn1 moved in train mode
