"""test_model's own invariants in the port (the JAX package pins them in
tests/test_eval_sharded.py and tests/test_e2e.py), on a pooled GRU the
port's loop trained for one epoch on the mini-COCO fixture, on the CPU:
serial scoring, one score thread or four, and no staging ahead give the
pipelined loop's scores exactly; early exit gives the same metrics; an eval
without flips is deterministic, and with them the same seed gives the same
scores, one draw of the flips a batch; bf16 scores within 0.05 of f32;
sub_batch_size stops early; the timer sees every batch; the sharded eval
and the JAX package's XLA route raise."""

import os

import pytest

from fixtures import build_mini_coco, mini_params
from show_tell_tpu_torch.data import transforms
from show_tell_tpu_torch.data.dataset import get_data_loader
from show_tell_tpu_torch.evaluation import tester
from show_tell_tpu_torch.train.checkpoint import read_checkpoint, restore_train_state
from show_tell_tpu_torch.train.loop import captioner_config_from_params, train
from show_tell_tpu_torch.train.train_step import create_train_state
from show_tell_tpu_torch.utils import StepTimer
from show_tell_tpu_torch.vocab import get_vocabulary
from torch_train_helpers import few_torch_threads  # noqa: F401 (an autouse fixture)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_inv")
    data = str(root / "data")
    build_mini_coco(data)
    params = mini_params(data, str(root / "out"), device="cpu", embedding_length=16, num_hidden_units=24,
                         num_layers=1, optimizer_type="Adam", lr=0.01, use_pallas=-1, dp=0, eval_augment=0)
    vocab = get_vocabulary("MSCOCO", params)
    train(params, vocab, get_data_loader(vocab, params, "train"))
    return params, vocab


def _eval(trained, tmp_path, beam_size=0, seed=1, timer=None, sub_batch_size=-1, **over):
    params, vocab = trained
    params = dict(params, output_dir=str(tmp_path), **over)
    cfg = captioner_config_from_params(params, len(vocab))
    ts = create_train_state(cfg, "Adam", 0.01, device="cpu")
    restore_train_state(ts, read_checkpoint(os.path.join(trained[0]["output_dir"], "model_1.ckpt")))
    return tester.test_model(ts, cfg, get_data_loader(vocab, params, "test"), vocab, params, beam_size=beam_size,
                             seed=seed, timer=timer, sub_batch_size=sub_batch_size)


@pytest.fixture(scope="module")
def reference(trained, tmp_path_factory):
    """The pipelined eval's scores: greedy and beam K=2."""
    out = tmp_path_factory.mktemp("ref")
    return {0: _eval(trained, out), 2: _eval(trained, out, beam_size=2)}


@pytest.mark.parametrize("beam_size", [0, 2])
def test_serial_scoring_and_no_staging_are_identical(trained, reference, tmp_path, monkeypatch, beam_size):
    monkeypatch.setattr(tester, "PIPELINE_SCORING", False)
    monkeypatch.setattr(tester, "STAGE_H2D", False)
    assert _eval(trained, tmp_path, beam_size) == reference[beam_size]


@pytest.mark.parametrize("threads", [1, 4])
def test_score_threads_are_identical(trained, reference, tmp_path, threads):
    assert _eval(trained, tmp_path, score_threads=threads) == reference[0]


@pytest.mark.parametrize("beam_size", [0, 2])
def test_early_exit_gives_identical_metrics(trained, reference, tmp_path, beam_size):
    assert _eval(trained, tmp_path, beam_size, early_exit=1) == reference[beam_size]


def test_no_flips_is_deterministic(trained, reference, tmp_path):
    assert _eval(trained, tmp_path, seed=5) == reference[0]  # no draw reads the seed
    assert reference[0]["Bleu_1"] > 0


def test_flips_one_draw_a_batch_and_the_same_seed_the_same_scores(trained, tmp_path, monkeypatch):
    draws = []
    real = transforms._flip_draws

    def counting(b, generator, device):
        draws.append((b, generator.initial_seed()))
        return real(b, generator, device)

    monkeypatch.setattr(transforms, "_flip_draws", counting)
    a = _eval(trained, tmp_path, seed=3, eval_augment=1)
    assert draws == [(4, 3)] * 4  # 16 captions, B=4: four batches, one draw each from the seeded generator
    assert _eval(trained, tmp_path, seed=3, eval_augment=1) == a
    assert len(draws) == 8


def test_bf16_scores_within_005_of_f32(trained, reference, tmp_path):
    """The JAX package's pin (tests/test_e2e.py::test_bf16_serving_quality_pinned)."""
    bf16 = _eval(trained, tmp_path, compute_dtype="bfloat16")
    for k in ("Bleu_1", "Bleu_4", "CIDEr", "ROUGE_L", "test_loss"):
        assert abs(bf16[k] - reference[0][k]) <= 0.05, (k, bf16[k], reference[0][k])


def test_sub_batch_size_and_the_timer(trained, tmp_path, capsys):
    timer = StepTimer()
    _eval(trained, tmp_path, timer=timer, sub_batch_size=2)
    out = capsys.readouterr().out
    assert "Sub-batch size -  2" in out
    summary = timer.summary()
    assert summary["step"]["count"] == summary["score"]["count"] == 2


@pytest.mark.parametrize("over,error,match", [
    (dict(dp=2), ValueError, "needs 2 devices but only 1 are visible"),  # one process
    (dict(mp=2), ValueError, "--mp 2 does not divide vocab_size 69"),  # the fixture's vocabulary: 69 words
    (dict(dp=2, mp=3), ValueError, "needs 6 devices but only 1 are visible"),
    (dict(use_pallas=2), ValueError, "XLA"),  # outside -1, 0, 1 (0 is the library route)
])
def test_what_the_port_does_not_run_raises(trained, tmp_path, over, error, match):
    with pytest.raises(error, match=match):
        _eval(trained, tmp_path, **over)
    assert not os.listdir(str(tmp_path))
