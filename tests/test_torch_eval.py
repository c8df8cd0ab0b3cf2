"""The port's test_model (evaluation/tester.py) against the JAX package's,
on the CPU, f32, eval_augment 0, on one checkpoint of the pooled GRU that
the JAX package's CLI trained for one epoch on the mini-COCO fixture: the
greedy decode, the batched beam (K=2), early exit (greedy and beam) and
the faithful beam (K=2, batch 1).  Every score equal, test_loss within
1e-5 relative, both pickles equal, the printed lines equal but for the
time."""

import pytest

from torch_eval_helpers import assert_same_eval, jax_trained, port_and_jax  # noqa: F401 (a fixture)
from torch_train_helpers import few_torch_threads  # noqa: F401 (an autouse fixture)

TEST = ["--is_training", "0", "--is_testing", "1", "--load_model_test", "model_1", "--eval_augment", "0"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return jax_trained(tmp_path_factory, "gru")


@pytest.mark.parametrize("extra", [[], ["--early_exit", "1"]], ids=["fixed", "early_exit"])
def test_greedy_equals_the_jax_package(trained, port_and_jax, extra):
    port, jax_run = port_and_jax("gru", *trained, TEST + extra)
    assert_same_eval(port, jax_run)
    assert port[0]["Bleu_1"] > 0  # the captions score: the comparison is not of zeros


@pytest.mark.parametrize("extra", [[], ["--early_exit", "1"]], ids=["fixed", "early_exit"])
def test_beam_equals_the_jax_package(trained, port_and_jax, extra):
    port, jax_run = port_and_jax("gru", *trained, TEST + ["--beam_size", "2"] + extra)
    assert_same_eval(port, jax_run)


def test_faithful_beam_equals_the_jax_package(trained, port_and_jax):
    """--faithful_beam 1 --beam_size 2: batch 1 (load_params forces it for the GRU), the host loop."""
    port, jax_run = port_and_jax("gru", *trained, TEST + ["--beam_size", "2", "--faithful_beam", "1"])
    assert_same_eval(port, jax_run)
    assert len(port[1][1]) == 8 and port[0]["Bleu_1"] > 0


def test_the_100_step_prints_equal_the_jax_package(trained, port_and_jax):
    """112 batches of one image (the fixture's 16 captions, seven times over):
    the running means printed at step 100 and the final lines equal."""
    from show_tell_tpu_torch.core.config import load_params
    from show_tell_tpu_torch.data.dataset import get_data_loader
    from show_tell_tpu_torch.vocab import load_vocab
    from torch_eval_helpers import cli_argv

    params = load_params(cli_argv(*trained, TEST + ["--batch_size", "1"]), variant="gru")
    batches = list(get_data_loader(load_vocab(params["vocab_path"]), params, "test")) * 7
    port, jax_run = port_and_jax("gru", *trained, TEST + ["--batch_size", "1"], batches)
    assert_same_eval(port, jax_run)
    assert [x.split(" - ")[0] for x in port[2] if x.startswith("Step ")] == ["Step 100"]
