"""The port's CLI (show_tell_tpu_torch/cli: run.py and the four mains, with
its copy of core/config.py) against the JAX package's, on the CPU: every
variant's parser has the JAX CLI's options, types and defaults for both
data sources; load_params gives the same dict (the GRU CLI's beam forces
batch 1); ``run("gru", ... --device cpu)`` trains and tests end to end on
the mini-COCO fixture and writes the JAX CLI's files; its test phase on a
checkpoint the JAX CLI trained gives the JAX CLI's scores; what the port
does not run yet raises before anything is written."""

import importlib
import math
import os
import pickle

import numpy as np
import pytest

from show_tell_tpu.cli.run import run as jax_run
from show_tell_tpu.core import config as jax_config
from show_tell_tpu_torch.cli import run as cli
from show_tell_tpu_torch.core import config
from torch_eval_helpers import cli_argv, jax_trained
from torch_train_helpers import few_torch_threads  # noqa: F401 (an autouse fixture)

VARIANTS = ("gru", "lstm", "attn", "attn_lstm")


def _surface(parser):
    return [(a.option_strings, a.dest, a.default, a.type, a.choices, a.nargs, a.required) for a in parser._actions]


@pytest.mark.parametrize("data_source", ["MSCOCO", "Flickr"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_parser_has_the_jax_cli_options_and_defaults(variant, data_source):
    port = config.build_arg_parser(variant, data_source)
    want = jax_config.build_arg_parser(variant, data_source)
    assert _surface(port) == _surface(want)
    assert ("--device" in port._option_string_actions) == (variant == "gru")


@pytest.mark.parametrize("argv", [
    [],
    ["--beam_size", "3"],
    ["--beam_size", "2", "--faithful_beam", "1", "--batch_size", "8"],
    ["--data_source", "Flickr", "--batch_size", "8", "--shuffle", "0"],
    ["--data_source=Flickr", "--compute_dtype", "bfloat16", "--eval_augment", "0"],
    ["--embedding_length", "64", "--resume_training", "", "--dp", "2", "--ckpt_format", "orbax"],
])
@pytest.mark.parametrize("variant", VARIANTS)
def test_load_params_gives_the_jax_dict(variant, argv):
    port = config.load_params(argv, variant=variant)
    assert port == jax_config.load_params(argv, variant=variant)
    if variant == "gru" and "--beam_size" in argv:
        assert port["batch_size"] == 1
    if variant == "lstm" and "--batch_size" in argv:
        assert port["batch_size"] == 8


def test_apply_device():
    assert cli.apply_device("cpu") == "cpu"
    for device in ("gpu", "tpu"):
        with pytest.raises(RuntimeError, match="no CUDA device"):  # this sandbox has no card
            cli.apply_device(device)
    with pytest.raises(ValueError, match="valid device"):
        cli.apply_device("xpu")


@pytest.mark.parametrize("variant", VARIANTS)
def test_each_main_runs_its_variant(monkeypatch, variant):
    module = importlib.import_module("show_tell_tpu_torch.cli." + ("main" if variant == "gru" else "main_" + variant))
    seen = []
    monkeypatch.setattr(module, "run", seen.append)
    module.run_cli()
    assert seen == [variant]


@pytest.mark.parametrize("flag,error,item", [
    (["--multihost", "localhost:1234,2"], ValueError, "coordinator_host:port,num_processes,process_id"),
    (["--dp", "3"], ValueError, "batch_size 4 does not divide over 3 processes"),
    (["--mp", "3"], ValueError, "batch_size 4 does not divide over 3 processes"),  # every dp x mp rank trains
    (["--ckpt_format", "orbax"], NotImplementedError, "item 2"),
])
def test_what_the_port_does_not_run_raises_first(tmp_path, flag, error, item):
    """A malformed --multihost spec, a batch that does not divide over the
    --dp x --mp processes that train, and --ckpt_format orbax raise before
    anything runs."""
    out = str(tmp_path / "out")
    with pytest.raises(error, match=item):
        cli.run("gru", cli_argv(str(tmp_path / "data"), out, ["--device", "cpu"] + flag))
    assert not os.path.exists(out)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return jax_trained(tmp_path_factory, "gru")


def test_gru_cli_trains_and_tests_on_the_cpu(trained, tmp_path):
    data_root, _ = trained
    out = str(tmp_path / "out")
    res = cli.run("gru", cli_argv(data_root, out, ["--is_training", "1", "--is_testing", "1",
                                                   "--load_model_test", "model_1", "--device", "cpu"]))
    assert sorted(os.listdir(out)) == ["Candidate_Words_Dict.pickle", "Target_Words_Dict.pickle", "metrics.jsonl",
                                       "model_1.ckpt", "model_1_metrics.ckpt", "vocab.pkl"]
    with open(os.path.join(out, "model_1_metrics.ckpt"), "rb") as f:
        assert len(pickle.load(f)["train_loss"]) == 4  # 16 captions / batch 4, drop_last
    with open(os.path.join(out, "Candidate_Words_Dict.pickle"), "rb") as f:
        assert len(pickle.load(f)) == 8  # 8 distinct images
    scores = res["scores"]
    assert sorted(scores) == sorted(["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "CIDEr", "ROUGE_L", "test_loss",
                                     "Final_Bleu_1", "Final_Bleu_2", "Final_Bleu_3", "Final_Bleu_4"])
    assert all(math.isfinite(v) for v in scores.values()) and 0.0 <= scores["Bleu_1"] <= 1.0
    assert res["params"]["device"] == "cpu" and res["train_state"].device.type == "cpu"


@pytest.mark.parametrize("extra", [[], ["--beam_size", "2"]], ids=["greedy", "beam"])
def test_test_phase_on_a_jax_checkpoint_gives_the_jax_scores(trained, extra):
    data_root, out_dir = trained
    argv = cli_argv(data_root, out_dir, ["--is_training", "0", "--is_testing", "1", "--load_model_test", "model_1",
                                         "--eval_augment", "0"] + extra)
    want = jax_run("gru", argv)["scores"]
    got = cli.run("gru", argv + ["--device", "cpu"])["scores"]
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "test_loss":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
        else:
            assert got[k] == want[k], (k, got[k], want[k])
