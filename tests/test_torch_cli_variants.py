"""The port's LSTM and attention mains (no --device flag, as in the
reference: ``run(..., device="cpu")``) train and test end to end on the
mini-COCO fixture on the CPU, and ``--backbone_weights`` loads a
torchvision-layout state dict into the frozen backbone as the JAX CLI does."""

import math
import os

import numpy as np
import pytest
import torch

from fixtures import build_mini_coco
from show_tell_tpu_torch.cli import run as cli
from torch_eval_helpers import ATTN_FLAGS, cli_argv
from torch_resnet_oracle import TorchResNet
from torch_train_helpers import few_torch_threads  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("variant", ["lstm", "attn", "attn_lstm"])
def test_other_mains_train_and_test_on_the_cpu(tmp_path, variant):
    data_root, out = str(tmp_path / "data"), str(tmp_path / "out")
    build_mini_coco(data_root)
    extra = ["--is_training", "1", "--is_testing", "1", "--load_model_test", "model_1"]
    res = cli.run(variant, cli_argv(data_root, out, extra + (ATTN_FLAGS if variant.startswith("attn") else [])),
                  device="cpu")
    assert res["params"]["device"] == "cpu"
    assert math.isfinite(res["scores"]["Bleu_1"]) and math.isfinite(res["scores"]["test_loss"])
    assert os.path.isfile(os.path.join(out, "model_1.ckpt"))
    assert os.path.isfile(os.path.join(out, "Candidate_Words_Dict.pickle"))


def test_backbone_weights_load_as_in_the_jax_cli(tmp_path):
    import jax

    from show_tell_tpu.cli.run import _init_from_backbone as jax_init_from_backbone
    from show_tell_tpu.models.captioner import CaptionerConfig as JaxConfig
    from show_tell_tpu_torch.models.captioner import CaptionerConfig, trainable_parameters

    torch.manual_seed(7)
    backbone = TorchResNet(18)
    pth = str(tmp_path / "resnet18.pth")
    torch.save(backbone.state_dict(), pth)
    jcfg = JaxConfig("gru", 18, 16, 24, 40, 1)
    want_p, want_s = jax_init_from_backbone(pth, jcfg, 1)
    got_p, got_s = cli._init_from_backbone(pth, CaptionerConfig(*jcfg), 1)
    jax_res = jax.tree.map(np.asarray, want_p["encoder"]["resnet"])
    assert sorted(got_p["encoder"]["resnet"]) == sorted(jax_res)
    for k, v in jax_res.items():
        np.testing.assert_array_equal(got_p["encoder"]["resnet"][k], v, err_msg=k)
    for k, v in jax.tree.map(np.asarray, want_s["resnet"]).items():
        np.testing.assert_array_equal(got_s["resnet"][k], v, err_msg=k)

    data_root, out = str(tmp_path / "data"), str(tmp_path / "out")
    build_mini_coco(data_root)
    res = cli.run("gru", cli_argv(data_root, out, ["--is_training", "1", "--is_testing", "0", "--device", "cpu",
                                                   "--backbone_weights", pth]))
    model = res["train_state"].model
    assert "encoder.resnet.conv1.weight" not in trainable_parameters(model)
    # the frozen convolutions are the imported ones; the BN statistics moved (train-mode backbone)
    np.testing.assert_array_equal(model.encoder.resnet.conv1.weight.detach().numpy(),
                                  backbone.state_dict()["conv1.weight"].numpy())
    assert not np.allclose(model.encoder.resnet.bn1.running_mean.numpy(),
                           backbone.state_dict()["bn1.running_mean"].numpy())
