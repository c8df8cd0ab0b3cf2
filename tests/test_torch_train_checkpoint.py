"""The port's checkpoints against itself and the JAX package, on the CPU in
f32: a port checkpoint resumes in the port exactly, optimizer state
included; a JAX checkpoint (optax state and all) resumes in the port and
continues the JAX run's losses; the JAX package's restore reads a port
checkpoint's weights and BN statistics (and resets the optimizer with its
notice); and the port's Captioner serves a checkpoint the port's trainer
wrote.
"""

import os
import pickle

import jax
import numpy as np
import pytest

from show_tell_tpu.train.checkpoint import create_checkpoint as jax_create_checkpoint
from show_tell_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from show_tell_tpu.train.checkpoint import restore_train_state as jax_restore_train_state
from show_tell_tpu.train.optim import make_optimizer as jax_make_optimizer
from show_tell_tpu.train.train_step import make_train_step as jax_make_train_step
from show_tell_tpu_torch.models.captioner import model_trees
from show_tell_tpu_torch.serve import Captioner
from show_tell_tpu_torch.train.checkpoint import (
    create_checkpoint,
    find_latest_checkpoint,
    prune_checkpoints,
    read_checkpoint,
    restore_train_state,
)
from show_tell_tpu_torch.train.train_step import create_train_state, make_eval_step, make_train_step
from show_tell_tpu_torch.vocab import DatasetVocabulary, save_vocab
from torch_train_helpers import LR, jax_cfg, jax_init, jax_train_state, make_batch, np_tree, port_cfg, port_trainable
from torch_train_helpers import few_torch_threads  # noqa: F401 (an autouse fixture)

BATCHES = [make_batch(20 + i) for i in range(3)]


def _steps(step, ts, batches):
    return [float(step(ts, *b)) for b in batches]


@pytest.mark.parametrize("optimizer", ["SGD", "Adam"])
def test_port_checkpoint_resumes_exactly(tmp_path, optimizer):
    """Three steps, a checkpoint, three more; a fresh state restored from the
    checkpoint takes the same three more steps bit for bit."""
    jcfg = jax_cfg("lstm")
    cfg = port_cfg(jcfg)
    init = jax_init(jcfg)
    step = make_train_step(cfg, augment=False)
    ts = create_train_state(cfg, optimizer, LR[optimizer], device="cpu", init=init)
    _steps(step, ts, BATCHES)
    path = create_checkpoint(ts, 1, 3, [0.0], {"output_dir": str(tmp_path)})
    want = _steps(step, ts, BATCHES)
    ts2 = create_train_state(cfg, optimizer, LR[optimizer], device="cpu", seed=5)  # other weights, empty optimizer
    restore_train_state(ts2, read_checkpoint(path))
    assert _steps(step, ts2, BATCHES) == want
    for name, value in port_trainable(ts.model).items():
        np.testing.assert_array_equal(port_trainable(ts2.model)[name], value, err_msg=name)


@pytest.mark.parametrize("variant,optimizer", [("gru", "SGD"), ("attn", "Adam")])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, variant, optimizer):
    """The JAX package trains three steps and writes its checkpoint, then
    trains three more.  The port, restored from that checkpoint (weights,
    BN statistics, and the optax state read as torch optimizer state),
    takes the same three steps: losses within 1e-4."""
    jcfg = jax_cfg(variant, alpha_c=0.1)
    params, bn_state = jax_init(jcfg)
    tx = jax_make_optimizer(optimizer, LR[optimizer])
    jts = jax_train_state(params, bn_state, tx)
    jstep = jax_make_train_step(jcfg, tx, augment=False)
    for b in BATCHES:
        jts, _ = jstep(jts, *b)
    path = jax_create_checkpoint(jts, 1, 3, [0.0], {"output_dir": str(tmp_path)})
    want = []
    for b in BATCHES:
        jts, loss = jstep(jts, *b)
        want.append(float(loss))
    ts = create_train_state(port_cfg(jcfg), optimizer, LR[optimizer], device="cpu", seed=3)
    restore_train_state(ts, read_checkpoint(path))
    assert len(ts.optimizer.state) > 0
    np.testing.assert_allclose(_steps(make_train_step(port_cfg(jcfg), augment=False), ts, BATCHES), want, rtol=1e-4)


def test_jax_restore_reads_a_port_checkpoint(tmp_path, capsys):
    """The JAX package's load_checkpoint + restore_train_state on a port
    checkpoint: equal weights and BN statistics, and its optimizer reset
    with the printed notice (the port writes torch.optim's state)."""
    jcfg = jax_cfg("attn_lstm")
    cfg = port_cfg(jcfg)
    ts = create_train_state(cfg, "Adam", 1e-3, device="cpu", init=jax_init(jcfg))
    _steps(make_train_step(cfg), ts, BATCHES[:2])
    path = create_checkpoint(ts, 2, 2, [1.0, 2.0], {"output_dir": str(tmp_path)})
    params, bn_state = jax_init(jcfg, seed=7)
    tx = jax_make_optimizer("Adam", 1e-3)
    restored = jax_restore_train_state(jax_train_state(params, bn_state, tx), jax_load_checkpoint(path))
    assert "resetting it" in capsys.readouterr().out
    want_params, want_bn = model_trees(ts.model)
    got = np_tree({"trainable": restored.trainable, "frozen": restored.frozen, "bn": restored.bn_state})
    jax.tree.map(np.testing.assert_array_equal, got["bn"], want_bn)
    jax.tree.map(np.testing.assert_array_equal, got["frozen"]["encoder"]["resnet"], want_params["encoder"]["resnet"])
    jax.tree.map(np.testing.assert_array_equal, got["trainable"]["decoder"], want_params["decoder"])
    for k in ("linear_secondlast_layer", "last_layer"):
        jax.tree.map(np.testing.assert_array_equal, got["trainable"]["encoder"][k], want_params["encoder"][k])


def test_port_checkpoint_serves(tmp_path):
    """Captioner.from_checkpoint on a checkpoint the port's trainer wrote
    gives the ids of the eval step on the same weights (f32, no flips)."""
    jcfg = jax_cfg("gru")
    cfg = port_cfg(jcfg)
    ts = create_train_state(cfg, "SGD", 0.05, device="cpu", init=jax_init(jcfg))
    _steps(make_train_step(cfg), ts, BATCHES)
    path = create_checkpoint(ts, 1, 3, [], {"output_dir": str(tmp_path)})
    vocab = DatasetVocabulary()
    for w in ["<pad>", "<start>", "<end>", "<unk>"] + ["w%d" % i for i in range(jcfg.vocab_size - 4)]:
        vocab.add_new_word(w)
    save_vocab(vocab, str(tmp_path / "vocab.pkl"))
    cap = Captioner.from_checkpoint(path, str(tmp_path / "vocab.pkl"), resnet_version=18, embed_dim=jcfg.embed_dim,
                                    hidden_dim=jcfg.hidden_dim, num_layers=jcfg.num_layers, compute_dtype="float32",
                                    device="cpu")
    images, captions, lengths = BATCHES[0]
    _, ids = make_eval_step(cfg, augment=False)(ts, images, captions, lengths)
    np.testing.assert_array_equal(cap.caption_ids(images), ids.numpy())
    assert len(cap.caption(images)) == len(images)


def test_checkpoint_listing_and_pruning(tmp_path):
    out = str(tmp_path)
    assert find_latest_checkpoint(out) is None
    for epoch in (1, 2, 10):
        for name in ("model_%d.ckpt", "model_%d_metrics.ckpt"):
            open(os.path.join(out, name % epoch), "wb").close()
    assert find_latest_checkpoint(out) == os.path.join(out, "model_10.ckpt")
    prune_checkpoints(out, 2)
    assert sorted(os.listdir(out)) == ["model_10.ckpt", "model_10_metrics.ckpt", "model_2.ckpt",
                                       "model_2_metrics.ckpt"]
    with open(os.path.join(out, "model_2.ckpt"), "wb") as f:
        pickle.dump({"epoch": 2}, f)
    with pytest.raises(ValueError, match="not a show_tell_tpu pickle checkpoint"):
        read_checkpoint(os.path.join(out, "model_2.ckpt"))
