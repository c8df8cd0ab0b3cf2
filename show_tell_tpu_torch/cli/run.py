"""Shared CLI runner behind the four entry points (counterpart of
show_tell_tpu/cli/run.py, one device).

Phase selection and flow mirror reference main.py:116-176: build vocab and
loaders, construct models, train when --is_training (the GRU CLI runs the
in-training eval every 5 epochs), then test when --is_testing by loading
--load_model_test and running the test_model flow.

The port runs on one device: ``--multihost``, ``--dp`` > 1 and ``--mp`` > 1
raise (ROADMAP Queue 1 item 6), as does ``--ckpt_format orbax`` (the port
reads and writes pickle checkpoints only, item 2).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from show_tell_tpu_torch.core.config import load_params
from show_tell_tpu_torch.core.device import resolve_device
from show_tell_tpu_torch.data.dataset import get_data_loader
from show_tell_tpu_torch.evaluation.tester import test_model
from show_tell_tpu_torch.train.checkpoint import read_checkpoint, resolve_checkpoint_path, restore_train_state
from show_tell_tpu_torch.train.loop import captioner_config_from_params, train
from show_tell_tpu_torch.train.train_step import create_train_state
from show_tell_tpu_torch.vocab import get_vocabulary


def apply_device(device: str) -> str:
    """Honor ``--device`` (reference main.py:62,104-113 places on cpu/gpu):
    ``cpu`` is the CPU; ``gpu`` and ``tpu`` both mean the CUDA card (the
    reference's ``.cuda()``), which raises where torch finds none
    (``core.device.resolve_device``).  Returns the port's device name."""
    if device == "cpu":
        return "cpu"
    if device in ("gpu", "tpu"):
        resolve_device("gpu")
        return "gpu"
    raise ValueError("Please specify a valid device - gpu/cpu/tpu. %s doesn't exist." % (device,))


def _one_device(params: Dict[str, Any]) -> None:
    """Raise, naming its ROADMAP item, for what the port does not run yet."""
    if params.get("multihost"):
        raise NotImplementedError("--multihost (torch.distributed across hosts) is ROADMAP Queue 1 item 6")
    for flag, one in (("dp", 0), ("mp", 1)):
        if int(params.get(flag, one) or one) > 1:
            raise NotImplementedError("--%s %d (parallelism) is ROADMAP Queue 1 item 6; the port runs on one device"
                                      % (flag, params[flag]))
    if params.get("ckpt_format", "pickle") != "pickle":
        raise NotImplementedError("--ckpt_format %s: orbax checkpoint directories stay out of the port (ROADMAP "
                                  "Queue 1 item 2); it reads and writes the pickle format" % params["ckpt_format"])


def _init_from_backbone(path: str, cfg, seed: int):
    """--backbone_weights: torchvision .pth state_dict -> frozen backbone
    params, everything else freshly initialized like the reference
    (cnn.py:37-42 head init, torch-default decoder init).  Replaces
    torchvision's pretrained=True download (cnn.py:23-31)."""
    import torch

    from show_tell_tpu_torch.models.captioner import init_captioner
    from show_tell_tpu_torch.models.resnet import resnet_params_from_torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    res_params, res_state = resnet_params_from_torch(sd)
    p, s = init_captioner(cfg, torch.Generator().manual_seed(seed))
    p = {**p, "encoder": {**p["encoder"], "resnet": res_params}}
    s = {**s, "resnet": res_state}
    print("Backbone weights loaded from %s." % path)
    return p, s


def run(variant: str, argv: Optional[List[str]] = None, data_source: str = "MSCOCO",
        device: Optional[str] = None) -> Dict[str, Any]:
    """Parse ``argv`` for ``variant``'s CLI and run its phases.  ``device``
    overrides ``--device`` (which only the GRU CLI has, as in the reference;
    the others run on the card unless a caller passes "cpu")."""
    params = load_params(argv, variant=variant, data_source=data_source)
    data_source = params["data_source"]  # --data_source flag may override
    _one_device(params)
    params["device"] = apply_device(device or params.get("device", "gpu"))
    print("Parameters being used by the Model - ", params)

    vocab = get_vocabulary(data_source, params)
    print("Vocabulary loaded.")

    train_data_loader = get_data_loader(vocab, params, "train")
    print("Training data loaded.")
    # The Flickr config block ships test_ann_path="" (no val split in the
    # reference's layout): skip the test loader — and the GRU CLI's
    # 5-epoch eval — rather than opening a directory as an annotation file.
    have_test_ann = bool(params.get("test_ann_path"))
    if params.get("is_testing") and not have_test_ann:
        raise ValueError("--is_testing 1 requires --test_ann_path (the %s config block has none)" % params["data_source"])
    test_data_loader = (
        get_data_loader(vocab, params, "test")
        if have_test_ann and (params.get("is_testing") or variant == "gru")
        else None
    )
    if test_data_loader is not None:
        print("Testing data loaded.")

    cfg = captioner_config_from_params(params, len(vocab))
    results: Dict[str, Any] = {"params": params, "config": cfg}

    if params["is_training"]:
        init_ps = None
        if params.get("backbone_weights"):
            init_ps = _init_from_backbone(params["backbone_weights"], cfg, params.get("seed", 1))
        results["train_state"] = train(
            params,
            vocab,
            train_data_loader,
            test_data_loader,
            eval_every_epochs=5 if variant == "gru" else 0,
            init_params_state=init_ps,
        )

    if params["is_testing"]:
        ts = create_train_state(cfg, params["optimizer_type"], params["lr"], params.get("momentum", 0.9),
                                device=params["device"], seed=params.get("seed", 1))
        ckpt_path = resolve_checkpoint_path(params["output_dir"], params["load_model_test"])
        restore_train_state(ts, read_checkpoint(ckpt_path))
        print("Model loaded.")
        print("Steps to be taken - %d\n" % len(test_data_loader))
        results["scores"] = test_model(
            ts,
            cfg,
            test_data_loader,
            vocab,
            params,
            sub_batch_size=-1,
            beam_size=params.get("beam_size", 0),
            faithful_beam=bool(params.get("faithful_beam", 0)),
        )
    return results
