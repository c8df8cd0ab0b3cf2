"""Shared pieces of the port's training tests (tests/test_torch_train*.py):
small configurations, seeded batches, and the bridge that carries the
JAX package's trees and gradients over to the port's names."""

import jax
import numpy as np
import pytest
import torch

from show_tell_tpu.models import captioner as jax_captioner
from show_tell_tpu_torch.models.captioner import CaptionerConfig, build_trainable_model, trainable_parameters
from show_tell_tpu_torch.models.convert import trainable_from_jax as trainable_tree_to_port

CPU = torch.device("cpu")
TORCH_THREADS = 2  # tier-1 runs six workers on eight cores: torch's default (a thread a core) oversubscribes them


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Run a module's tests on TORCH_THREADS intra-op threads, then restore the count."""
    before = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(before)
VARIANTS = ("gru", "lstm", "attn", "attn_lstm")
E, H, V, L, A = 16, 24, 40, 2, 16
IMG = 64  # ResNet-18 at 64 x 64: a 2 x 2 feature map, P = 4


def jax_cfg(variant, **kw):
    return jax_captioner.CaptionerConfig(variant, 18, E, H, V, L, nos_filters=512, attn_dim=A, **kw)


def port_cfg(jcfg):
    return CaptionerConfig(*jcfg)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_init(jcfg, seed=0):
    """The JAX package's seeded (params, bn_state), as numpy trees."""
    return np_tree(jax_captioner.init_captioner(jax.random.PRNGKey(seed), jcfg))


def port_model(jcfg, params, bn_state):
    return build_trainable_model(params, bn_state, port_cfg(jcfg), CPU)


def make_batch(seed, B=4, T=9, img=IMG, vocab=V):
    """uint8 images, captions <start> ... <end> 0-padded, and lengths that
    differ from row to row (descending, as the loader sorts them)."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (B, img, img, 3), dtype=np.uint8)
    lengths = np.sort(rng.randint(3, T + 1, B))[::-1].astype(np.int32)
    lengths[0] = T
    captions = rng.randint(4, vocab, (B, T)).astype(np.int32)
    for i, n in enumerate(lengths):
        captions[i, n:] = 0
        captions[i, 0] = 1
        captions[i, n - 1] = 2
    return images, captions, np.ascontiguousarray(lengths)


def port_grads(model):
    """{name: grad as numpy} over the trainable split; a parameter the loss
    does not reach (the attention families' unused head) reads as zeros,
    as jax.grad gives it."""
    return {n: (p.grad.numpy() if p.grad is not None else np.zeros(tuple(p.shape), np.float32))
            for n, p in trainable_parameters(model).items()}


def port_trainable(model):
    return {n: p.detach().numpy().copy() for n, p in trainable_parameters(model).items()}


def assert_trees_close(got, want, rtol, atol, what=""):
    assert sorted(got) == sorted(want), (what, sorted(set(got) ^ set(want)))
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=rtol, atol=atol, err_msg="%s %s" % (what, k))


STEPS = 8
LR = {"SGD": 0.05, "Adam": 1e-3}


def jax_train_state(params, bn_state, tx, seed=1):
    import jax.numpy as jnp

    from show_tell_tpu.train.train_step import TrainState

    trainable, frozen = jax_captioner.split_trainable(params)
    return TrainState(trainable, frozen, bn_state, tx.init(trainable), jax.random.PRNGKey(seed), jnp.int32(0))


def train_step_lockstep(variant, optimizer):
    """Eight steps of make_train_step(augment=False) on four batches (two
    passes) from the same weights in both packages: each step's loss within
    rtol 1e-4, the trainable parameters at the end within 1e-4 (Adam: see
    below), and the eval step's loss within 1e-4 and its greedy ids
    bit-equal to the JAX eval step's after the updates."""
    from show_tell_tpu.train.optim import make_optimizer as jax_make_optimizer
    from show_tell_tpu.train.train_step import make_eval_step as jax_make_eval_step
    from show_tell_tpu.train.train_step import make_train_step as jax_make_train_step
    from show_tell_tpu_torch.train.train_step import create_train_state, make_eval_step, make_train_step

    jcfg = jax_cfg(variant, alpha_c=0.1)
    params, bn_state = jax_init(jcfg)
    tx = jax_make_optimizer(optimizer, LR[optimizer])
    jts = jax_train_state(params, bn_state, tx)
    jstep = jax_make_train_step(jcfg, tx, augment=False)
    ts = create_train_state(port_cfg(jcfg), optimizer, LR[optimizer], device="cpu", init=(params, bn_state))
    step = make_train_step(port_cfg(jcfg), augment=False)
    batches = [make_batch(10 + i) for i in range(4)]
    for i in range(STEPS):
        images, captions, lengths = batches[i % 4]
        jts, jloss = jstep(jts, images, captions, lengths)
        loss = step(ts, images, captions, lengths)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4, err_msg="step %d" % i)
    assert ts.step == STEPS
    got, want = port_trainable(ts.model), trainable_tree_to_port(np_tree(jts.trainable))
    if optimizer == "SGD":
        assert_trees_close(got, want, 1e-4, 1e-4, "trainable")
    else:
        # Adam divides each element's first moment by the root of its second:
        # where a gradient is zero up to roundoff (the Linear bias in front of
        # the head's train-mode BN1d, full_att's bias under the softmax) or a
        # cancellation over steps, that ratio is roundoff over roundoff, and
        # both packages move the element by noise of up to lr a step.  So:
        # every element within Adam's bound on a move, STEPS x lr, and all but
        # 0.1% of them within 1e-4.
        assert sorted(got) == sorted(want)
        g = np.concatenate([got[k].ravel() for k in sorted(want)])
        w = np.concatenate([np.asarray(want[k]).ravel() for k in sorted(want)])
        assert np.abs(g - w).max() <= STEPS * LR["Adam"]
        off = np.abs(g - w) > 1e-4 + 1e-4 * np.abs(w)
        assert off.mean() <= 1e-3, (int(off.sum()), off.size)
    images, captions, lengths = batches[0]
    jloss, jids = jax_make_eval_step(jcfg, augment=False)(jts, images, captions, lengths, jax.random.PRNGKey(2))
    loss, ids = make_eval_step(port_cfg(jcfg), augment=False)(ts, images, captions, lengths)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert ts.model.training  # the eval step restores the mode
