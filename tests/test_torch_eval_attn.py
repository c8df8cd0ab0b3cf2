"""The port's test_model against the JAX package's for the attention GRU
(the fused attention step; the batched beam's dense attention step and the
context at step 0), on the CPU, f32, eval_augment 0, on one checkpoint the
JAX package's CLI trained for one epoch on the mini-COCO fixture (ResNet-18
spatial features, C=512, A=16); and the pooled LSTM's greedy decode."""

import pytest

from torch_eval_helpers import ATTN_FLAGS, assert_same_eval, jax_trained, port_and_jax  # noqa: F401
from torch_train_helpers import few_torch_threads  # noqa: F401 (an autouse fixture)

TEST = ["--is_training", "0", "--is_testing", "1", "--load_model_test", "model_1", "--eval_augment", "0"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return jax_trained(tmp_path_factory, "attn")


@pytest.mark.parametrize("extra", [[], ["--beam_size", "2"], ["--beam_size", "2", "--early_exit", "1"]],
                         ids=["greedy", "beam", "beam-early_exit"])
def test_attention_equals_the_jax_package(trained, port_and_jax, extra):
    port, jax_run = port_and_jax("attn", *trained, TEST + ATTN_FLAGS + extra)
    assert_same_eval(port, jax_run)
    if not extra:
        assert port[0]["Bleu_1"] > 0


def test_lstm_greedy_equals_the_jax_package(tmp_path_factory, port_and_jax):
    data_root, out_dir = jax_trained(tmp_path_factory, "lstm")
    port, jax_run = port_and_jax("lstm", data_root, out_dir, TEST)
    assert_same_eval(port, jax_run)
