"""The port's training loop (train/loop.train) on the mini-COCO fixture, on
the CPU: two epochs whose per-step losses are the port's own train step
replayed on the batches the loop consumed, with the same flips; the
checkpoint cadence and ``keep_checkpoints``; ``metrics.jsonl`` and the
profiler trace; a resume that restores weights and optimizer state and
restarts at epoch 0; a SIGTERM that checkpoints and exits 143; data
parallelism, which raises before the first step; and the in-training eval,
whose scores equal a direct test_model call on each epoch's checkpoint.
"""

import json
import os
import pickle
import signal

import numpy as np
import pytest

from fixtures import build_mini_coco, mini_params
from show_tell_tpu_torch.data.dataset import get_data_loader
from show_tell_tpu_torch.train.checkpoint import read_checkpoint, restore_train_state
from show_tell_tpu_torch.train.loop import captioner_config_from_params, train
from show_tell_tpu_torch.train.train_step import create_train_state, make_train_step
from show_tell_tpu_torch.vocab import get_vocabulary
from torch_train_helpers import few_torch_threads  # noqa: F401 (an autouse fixture)


class _Recording:
    """The loader, recording the batches each epoch consumed."""

    def __init__(self, inner, after=None):
        self.inner, self.epochs, self.after = inner, [], after

    def __len__(self):
        return len(self.inner)

    def __iter__(self):
        self.epochs.append([])
        for i, b in enumerate(self.inner):
            self.epochs[-1].append(b)
            yield b
            if self.after is not None:
                self.after(len(self.epochs), i + 1)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("mini")
    data = str(root / "data")
    build_mini_coco(data)
    params = mini_params(data, str(root / "out"), device="cpu", num_epochs=2, embedding_length=16,
                         num_hidden_units=24, optimizer_type="Adam", lr=1e-3, keep_checkpoints=1,
                         profile_dir=str(root / "trace"))
    vocab = get_vocabulary("MSCOCO", params)
    return params, vocab


def _losses(out_dir, epoch):
    with open(os.path.join(out_dir, "model_%d_metrics.ckpt" % epoch), "rb") as f:
        return pickle.load(f)["train_loss"]


def _replay(params, vocab, epochs, ts=None):
    """The port's own train step (flips from a fresh state's generator) over recorded batches."""
    cfg = captioner_config_from_params(params, len(vocab))
    fresh = create_train_state(cfg, params["optimizer_type"], params["lr"], device="cpu", seed=params["seed"])
    if ts is None:
        ts = fresh
    ts.generator = fresh.generator
    step = make_train_step(cfg)
    return [[float(step(ts, images, captions, lengths)) for _, images, captions, lengths in ep] for ep in epochs], ts


def test_two_epochs_resume_and_files(setup):
    params, vocab = setup
    out = params["output_dir"]
    loader = _Recording(get_data_loader(vocab, params, "train"))
    assert len(loader) == 4  # 16 captions, B=4, drop_last
    ts = train(params, vocab, loader)
    assert ts.step == 8 and len(loader.epochs) == 2
    # keep_checkpoints=1: only the newest epoch's files stay
    assert sorted(f for f in os.listdir(out) if f.startswith("model_")) == ["model_2.ckpt", "model_2_metrics.ckpt"]
    replayed, _ = _replay(params, vocab, loader.epochs)
    np.testing.assert_allclose(_losses(out, 2), replayed[1], rtol=1e-6)
    records = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    epochs = [r for r in records if r["event"] == "epoch"]
    assert [r["epoch"] for r in epochs] == [1, 2]
    np.testing.assert_allclose(epochs[0]["mean_loss"], np.mean(replayed[0]), rtol=1e-6)
    assert set(epochs[0]["timing"]) == {"data", "step"} and epochs[0]["timing"]["step"]["count"] == 4
    assert [r["step"] for r in records if r["event"] == "train_step"] == [4, 4]  # each epoch's last step
    trace = os.path.join(params["profile_dir"], "train_steps_2-6.json")
    assert os.path.isfile(trace) and json.load(open(trace))["traceEvents"]
    ckpt = read_checkpoint(os.path.join(out, "model_2.ckpt"))
    assert (ckpt["epoch"], ckpt["step"], ckpt["optimizer_state_dict"]["type"]) == (2, 4, "Adam")

    # Resume: weights, BN statistics and Adam's state from model_2; epoch 0 again, flips from a fresh generator
    params2 = dict(params, num_epochs=1, resume_training=1, resume_model_train="auto", profile_dir="",
                   keep_checkpoints=0)
    loader2 = _Recording(get_data_loader(vocab, params2, "train"))
    ts2 = train(params2, vocab, loader2)
    assert ts2.step == 4
    assert sorted(f for f in os.listdir(out) if f.startswith("model_")) == [
        "model_1.ckpt", "model_1_metrics.ckpt", "model_2.ckpt", "model_2_metrics.ckpt"]
    cfg = captioner_config_from_params(params, len(vocab))
    start = create_train_state(cfg, "Adam", params["lr"], device="cpu", seed=params["seed"])
    restore_train_state(start, ckpt)
    replayed2, _ = _replay(params, vocab, loader2.epochs, start)
    np.testing.assert_allclose(_losses(out, 1), replayed2[0], rtol=1e-6)  # the resumed epoch wrote model_1


def test_sigterm_checkpoints_and_exits_143(setup, tmp_path):
    params, vocab = setup
    params = dict(params, output_dir=str(tmp_path), keep_checkpoints=0, profile_dir="")
    sent = []

    def kill(epoch, step):
        if (epoch, step) == (1, 2) and not sent:
            sent.append(True)
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as exit_info:
        train(params, vocab, _Recording(get_data_loader(vocab, params, "train"), after=kill))
    assert exit_info.value.code == 143
    assert signal.getsignal(signal.SIGTERM) == before  # the handler is restored
    ckpt = read_checkpoint(os.path.join(str(tmp_path), "model_1.ckpt"))
    assert (ckpt["epoch"], ckpt["step"]) == (1, 2) and len(_losses(str(tmp_path), 1)) == 2


@pytest.mark.parametrize("kw,item", [(dict(dp=2), "needs 2 devices but only 1 are visible"),
                                     (dict(eval_every_epochs=1, use_pallas=2), "XLA")])  # outside -1, 0, 1
def test_later_items_raise_before_the_first_step(setup, tmp_path, kw, item):
    params, vocab = setup
    params = dict(params, output_dir=str(tmp_path), dp=kw.get("dp", 0), use_pallas=kw.get("use_pallas", -1))
    with pytest.raises((NotImplementedError, ValueError), match=item):
        train(params, vocab, get_data_loader(vocab, params, "train"), test_data_loader=[],
              eval_every_epochs=kw.get("eval_every_epochs", 0))
    assert not os.listdir(str(tmp_path))


def test_in_training_eval_equals_a_direct_test_model(setup, tmp_path, monkeypatch, capsys):
    """eval_every_epochs=1 with a test loader: after each epoch's checkpoint
    the loop runs test_model on ``sub_batch_test`` batches (the reference's
    flips on) and leaves the model in train mode; its scores equal a direct
    test_model call on that epoch's checkpoint."""
    from show_tell_tpu_torch.evaluation import tester

    params, vocab = setup
    params = dict(params, output_dir=str(tmp_path), num_epochs=2, keep_checkpoints=0, profile_dir="",
                  sub_batch_test=2, use_pallas=-1)
    seen = []
    real = tester.test_model

    def recording(ts, *args, **kwargs):
        seen.append((real(ts, *args, **kwargs), kwargs["sub_batch_size"]))
        return seen[-1][0]

    monkeypatch.setattr(tester, "test_model", recording)
    ts = train(params, vocab, get_data_loader(vocab, params, "train"), get_data_loader(vocab, params, "test"),
               eval_every_epochs=1)
    assert ts.model.training and [n for _, n in seen] == [2, 2]
    assert capsys.readouterr().out.count("Testing completed.") == 2
    cfg = captioner_config_from_params(params, len(vocab))
    for epoch, (scores, _) in enumerate(seen, start=1):
        direct = create_train_state(cfg, params["optimizer_type"], params["lr"], device="cpu")
        restore_train_state(direct, read_checkpoint(os.path.join(str(tmp_path), "model_%d.ckpt" % epoch)))
        assert real(direct, cfg, get_data_loader(vocab, params, "test"), vocab, params, sub_batch_size=2) == scores
    assert seen[0][0] != seen[1][0]  # the second eval saw the second epoch's weights
