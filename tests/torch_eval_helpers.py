"""Shared pieces of the port's eval tests (tests/test_torch_eval*.py): a
checkpoint trained for one epoch by the JAX package's CLI on the mini-COCO
fixture, and one test_model run of each package on it, with what each
printed and pickled."""

import os
import pickle
import re

import numpy as np
import pytest

from fixtures import build_mini_coco

ATTN_FLAGS = ["--nos_cnn_filters", "512", "--attn_dim", "16", "--alpha_c", "0.01"]


def cli_argv(data_root, out_dir, extra=()):
    """The JAX e2e tests' small GRU (ResNet-18, E=16, H=24, L=1, B=4, Adam)."""
    return [
        "--data_dir", data_root, "--output_dir", out_dir,
        "--train_ann_path", "annotations/captions_train2014.json",
        "--test_ann_path", "annotations/captions_train2014.json",
        "--train_img_dir", "train2014", "--test_img_dir", "train2014",
        "--vocab_threshold", "1", "--embedding_length", "16", "--num_hidden_units", "24", "--num_layers", "1",
        "--batch_size", "4", "--num_epochs", "1", "--resnet_version", "18", "--lr", "0.01", "--optimizer_type", "Adam",
    ] + list(extra)


def jax_trained(tmp_path_factory, variant):
    """(data_root, out_dir): model_1.ckpt and vocab.pkl of one epoch of the JAX package's CLI."""
    from show_tell_tpu.cli.run import run

    root = str(tmp_path_factory.mktemp("eval_" + variant))
    data_root, out_dir = os.path.join(root, "data"), os.path.join(root, "out")
    build_mini_coco(data_root)
    extra = ["--is_training", "1", "--is_testing", "0"] + (ATTN_FLAGS if variant.startswith("attn") else [])
    run(variant, cli_argv(data_root, out_dir, extra))
    return data_root, out_dir


def _pickles(out_dir):
    out = []
    for name in ("Target_Words_Dict.pickle", "Candidate_Words_Dict.pickle"):
        with open(os.path.join(out_dir, name), "rb") as f:
            out.append(pickle.load(f))
    return out


def _printed(text):
    """test_model's printed lines, with the elapsed-time field blanked."""
    return [re.sub(r"[0-9.]+ time", "<t> time", line) for line in text.splitlines()
            if not line.startswith(("Vocabulary", "Loading"))]


def jax_test_model(variant, data_root, out_dir, extra, capsys, batches=None):
    """The JAX package's test_model on model_1.ckpt, as its CLI's test phase
    builds it (one device), over its test loader or ``batches``: (scores,
    pickles, printed lines)."""
    import jax

    from show_tell_tpu.core.config import load_params
    from show_tell_tpu.data.dataset import get_data_loader
    from show_tell_tpu.evaluation.tester import test_model
    from show_tell_tpu.train.checkpoint import load_checkpoint, resolve_checkpoint_path, restore_train_state
    from show_tell_tpu.train.loop import captioner_config_from_params
    from show_tell_tpu.train.optim import make_optimizer
    from show_tell_tpu.train.train_step import create_train_state
    from show_tell_tpu.vocab.vocabulary import get_vocabulary

    params = dict(load_params(cli_argv(data_root, out_dir, extra), variant=variant), dp=1)
    vocab = get_vocabulary("MSCOCO", params)
    cfg = captioner_config_from_params(params, len(vocab))
    ts = create_train_state(jax.random.PRNGKey(1), cfg, make_optimizer(params["optimizer_type"], params["lr"], 0.9))
    ts = restore_train_state(ts, load_checkpoint(resolve_checkpoint_path(out_dir, "model_1")))
    capsys.readouterr()
    scores = test_model(ts, cfg, batches or get_data_loader(vocab, params, "test"), vocab, params,
                        beam_size=params["beam_size"], faithful_beam=bool(params["faithful_beam"]))
    return scores, _pickles(out_dir), _printed(capsys.readouterr().out)


def port_test_model(variant, data_root, out_dir, extra, capsys, batches=None):
    """The port's test_model on the same checkpoint, on the CPU."""
    from show_tell_tpu_torch.core.config import load_params
    from show_tell_tpu_torch.data.dataset import get_data_loader
    from show_tell_tpu_torch.evaluation.tester import test_model
    from show_tell_tpu_torch.train.checkpoint import read_checkpoint, resolve_checkpoint_path, restore_train_state
    from show_tell_tpu_torch.train.loop import captioner_config_from_params
    from show_tell_tpu_torch.train.train_step import create_train_state
    from show_tell_tpu_torch.vocab import get_vocabulary

    params = load_params(cli_argv(data_root, out_dir, extra), variant=variant)
    vocab = get_vocabulary("MSCOCO", params)
    cfg = captioner_config_from_params(params, len(vocab))
    ts = create_train_state(cfg, params["optimizer_type"], params["lr"], device="cpu")
    restore_train_state(ts, read_checkpoint(resolve_checkpoint_path(out_dir, "model_1")))
    capsys.readouterr()
    scores = test_model(ts, cfg, batches or get_data_loader(vocab, params, "test"), vocab, params,
                        beam_size=params["beam_size"], faithful_beam=bool(params["faithful_beam"]))
    return scores, _pickles(out_dir), _printed(capsys.readouterr().out)


def assert_same_eval(port, jax_run):
    """Every score key equal, test_loss within 1e-5 relative, the pickles
    equal, and the printed lines (the start, the score lines, the end)
    equal apart from the time field."""
    (ps, pp, pl), (js, jp, jl) = port, jax_run
    assert sorted(ps) == sorted(js)
    for k in js:
        if k == "test_loss":
            np.testing.assert_allclose(ps[k], js[k], rtol=1e-5)
        else:
            assert ps[k] == js[k], (k, ps[k], js[k])
    assert pp[0] == jp[0] and pp[1] == jp[1]
    ours = lambda lines: [x for x in lines if "test loss" in x or x.startswith(("Testing", "Sub-batch"))]
    assert ours(pl) == ours(jl) and sum(x.startswith("Step ") for x in pl) + 2 == sum("test loss" in x for x in pl)


@pytest.fixture
def port_and_jax(capsys):
    """run(variant, data_root, out_dir, extra, batches=None) -> (port, jax) test_model results, JAX first."""

    def run(variant, data_root, out_dir, extra, batches=None):
        jax_run = jax_test_model(variant, data_root, out_dir, extra, capsys, batches)
        return port_test_model(variant, data_root, out_dir, extra, capsys, batches), jax_run

    return run
