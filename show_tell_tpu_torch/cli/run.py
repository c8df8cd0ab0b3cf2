"""Shared CLI runner behind the four entry points (counterpart of
show_tell_tpu/cli/run.py).

Phase selection and flow mirror reference main.py:116-176: build vocab and
loaders, construct models, train when --is_training (the GRU CLI runs the
in-training eval every 5 epochs), then test when --is_testing by loading
--load_model_test and running the test_model flow.

Parallelism is one process per device (parallel/): ``--dp N --mp M``
(N x M > 1) spawns N x M processes in one command, each on its own device
(the CUDA card of its rank, or the CPU), joined into one torch.distributed
group on a free localhost port; ``--multihost HOST:PORT,NPROC,PID`` (or
``auto`` under torchrun) joins this process into a group of processes
started elsewhere.  Training is data parallel only, as in the JAX package
(``--mp`` is its eval-phase flag): the N x M processes train as one
data-parallel mesh of N x M (train/loop.train_mesh), so the batch must
divide over all of them; the test phase and the in-training eval run over
the N x M mesh, the vocabulary sharded over M.  ``--ckpt_format orbax``
raises (the port reads and writes pickle checkpoints only, ROADMAP Queue 1
item 2).
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional

from show_tell_tpu_torch.core.config import load_params
from show_tell_tpu_torch.core.device import resolve_device
from show_tell_tpu_torch.data.dataset import get_data_loader
from show_tell_tpu_torch.evaluation.tester import test_model
from show_tell_tpu_torch.parallel import multihost
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


def _check_supported(params: Dict[str, Any]) -> None:
    """Raise, before anything runs, for what the port does not run (naming
    its ROADMAP item) and for a batch that does not divide over the
    processes: ``--dp`` x ``--mp`` where it trains (every process trains),
    ``--dp`` where it only tests."""
    dp, mp = int(params.get("dp", 0) or 0), int(params.get("mp", 1) or 1)
    if mp < 1:
        raise ValueError("--mp takes 1 or more, not %d" % mp)
    share = max(dp, 1) * mp if params.get("is_training") else dp
    if share > 1 and params["batch_size"] % share:
        raise ValueError("batch_size %d does not divide over %d processes" % (params["batch_size"], share))
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


def _rank_run(variant: str, argv: Optional[List[str]], data_source: str, device: str):
    """One process of a ``--dp``/``--mp`` run, in its group: the phases; returns the scores (None without a test
    phase)."""
    return run(variant, argv, data_source, device).get("scores")


def _processes(params: Dict[str, Any]) -> int:
    """The processes that ``--dp N --mp M`` asks for in one command: N x M (N = 0 counts as 1)."""
    return max(int(params.get("dp", 0) or 0), 1) * int(params.get("mp", 1) or 1)


def _spawn(variant: str, argv: Optional[List[str]], data_source: str, device: str, params: Dict[str, Any]):
    """``--dp N --mp M`` in one command: N x M processes (``multihost.spawn``), one a device; returns rank 0's
    scores."""
    nproc = _processes(params)
    print("Data-parallel run: spawning %d processes." % nproc)
    return multihost.spawn(_rank_run, nproc, (variant, argv, data_source, device), device)[0]


def run(variant: str, argv: Optional[List[str]] = None, data_source: str = "MSCOCO",
        device: Optional[str] = None) -> Dict[str, Any]:
    """Parse ``argv`` for ``variant``'s CLI and run its phases.  ``device``
    overrides ``--device`` (which only the GRU CLI has, as in the reference;
    the others run on the card unless a caller passes "cpu").  ``--dp N
    --mp M`` outside a process group spawns the N x M processes that run
    them (``_spawn``); this process then returns rank 0's scores."""
    params = load_params(argv, variant=variant, data_source=data_source)
    data_source = params["data_source"]  # --data_source flag may override
    _check_supported(params)
    params["device"] = apply_device(device or params.get("device", "gpu"))
    if params.get("multihost") and multihost.process_count() == 1:
        multihost.initialize(params["multihost"], params["device"])
        print("Multi-host run: process %d of %d." % (multihost.process_index(), multihost.process_count()))
    elif _processes(params) > 1 and multihost.process_count() == 1:
        get_vocabulary(data_source, params)  # built and saved once, before the processes read it
        argv = list(sys.argv[1:]) if argv is None else list(argv)
        scores = _spawn(variant, argv, data_source, params["device"], params)
        return {"params": params} if scores is None else {"params": params, "scores": scores}
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
        if multihost.process_count() > 1:
            # Every process evaluates together (the checkpoint must be readable on each; only rank 0 writes).
            print("Multi-process test phase: process %d of %d joins the sharded eval."
                  % (multihost.process_index(), multihost.process_count()))
        ts = create_train_state(cfg, params["optimizer_type"], params["lr"], params.get("momentum", 0.9),
                                device=multihost.local_device(params["device"]), seed=params.get("seed", 1))
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
