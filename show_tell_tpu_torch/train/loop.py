"""The training loop: the reference's main.py:116-170 cadence on the port's
train step (counterpart of show_tell_tpu/train/loop.py).

Per epoch: iterate the loader with each batch staged on the device one
step ahead (data/device_prefetch.py), one train step a batch with its
``float(loss)`` as the sync; print every 500 steps and at the epoch's end;
checkpoint every 5000 steps and at each epoch's end, then keep the newest
``keep_checkpoints`` epochs.  Resume restores weights and optimizer state
but restarts at epoch 0, faithfully (SURVEY.md §3.5).  On SIGTERM the loop
checkpoints at the next batch boundary and exits with code 143.
``metrics.jsonl`` gets a record every print and every epoch, with the
stage timer's host-clock split (data, step); ``profile_dir`` takes a
``torch.profiler`` trace of steps 2-6 of the first epoch.

Not yet ported: data parallelism (``dp`` > 1, ROADMAP Queue 1 item 6)
and the in-training eval (``eval_every_epochs`` with a test loader,
``test_model``, item 5).  Asking for either raises before the first step.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from show_tell_tpu_torch.data.device_prefetch import device_prefetch
from show_tell_tpu_torch.models.captioner import CaptionerConfig
from show_tell_tpu_torch.train.checkpoint import (
    create_checkpoint,
    find_latest_checkpoint,
    prune_checkpoints,
    read_checkpoint,
    resolve_checkpoint_path,
    restore_train_state,
)
from show_tell_tpu_torch.train.train_step import TrainState, create_train_state, make_train_step
from show_tell_tpu_torch.utils import MetricsLogger, StepTimer


def captioner_config_from_params(params: Dict[str, Any], vocab_size: int) -> CaptionerConfig:
    return CaptionerConfig(
        variant=params.get("variant", "gru"),
        resnet_version=params["resnet_version"],
        embed_dim=params["embedding_length"],
        hidden_dim=params["num_hidden_units"],
        vocab_size=vocab_size,
        num_layers=params["num_layers"],
        nos_filters=params.get("nos_cnn_filters", 2048),
        attn_dim=params.get("attn_dim", 512),
        alpha_c=params.get("alpha_c", 1.0),
        max_caption_length=params.get("max_caption_length", 25),
        # A builder vocabulary (or the reference's vocab.pkl) pins <start> at id 1.
        start_token=1,
        attn_next_token=bool(params.get("attn_next_token", 0)),
    )


def train(
    params: Dict[str, Any],
    vocab,
    train_data_loader,
    test_data_loader=None,
    eval_every_epochs: int = 0,
    init_params_state: Optional[Tuple[Dict[str, Any], Dict[str, Any]]] = None,
) -> TrainState:
    """Run the training regime on ``params['device']`` ('gpu' by default,
    which raises without CUDA; 'cpu' on request); returns the TrainState.
    ``init_params_state``: (params, bn_state) numpy trees in the JAX layout
    to start from, e.g. pretrained weights; else they are drawn from
    ``params['seed']``."""
    if (params.get("dp", 0) or 1) > 1:
        raise NotImplementedError("data parallelism (dp=%d) is ROADMAP Queue 1 item 6; the port trains on one device"
                                  % params["dp"])
    if eval_every_epochs and test_data_loader is not None:
        raise NotImplementedError("the in-training eval (test_model every %d epochs) is ROADMAP Queue 1 item 5"
                                  % eval_every_epochs)
    cfg = captioner_config_from_params(params, len(vocab))
    ts = create_train_state(cfg, params["optimizer_type"], params["lr"], params.get("momentum", 0.9),
                            device=params.get("device", "gpu"), seed=params.get("seed", 1), init=init_params_state)
    if params.get("resume_training"):
        if params["resume_model_train"] == "auto":
            ckpt_path = find_latest_checkpoint(params["output_dir"])
            if ckpt_path is None:
                raise FileNotFoundError("no model_<N>.ckpt in %s to auto-resume from" % params["output_dir"])
        else:
            ckpt_path = resolve_checkpoint_path(params["output_dir"], params["resume_model_train"])
        print("Loading the model - %s" % os.path.basename(ckpt_path))
        restore_train_state(ts, read_checkpoint(ckpt_path))
        print("Models loaded.")

    train_dtype = str(params.get("train_dtype", "float32"))
    if train_dtype == "bfloat16":
        print("Training compute dtype: bfloat16 (f32 master weights/optimizer).")
    step = make_train_step(cfg, augment=True, compute_dtype=train_dtype)

    os.makedirs(params["output_dir"], exist_ok=True)
    logger = MetricsLogger(params["output_dir"])
    timer = StepTimer()
    start_time = time.time()
    print("Training started.")
    profile_dir = str(params.get("profile_dir", "") or "")
    profiler = None

    def stop_profile():
        nonlocal profiler
        if profiler is not None:
            profiler.stop()
            os.makedirs(profile_dir, exist_ok=True)
            profiler.export_chrome_trace(os.path.join(profile_dir, "train_steps_2-6.json"))
            profiler = None

    # Preemption: on SIGTERM, checkpoint at the next batch boundary and exit
    # 143 (128 + SIGTERM); resume with resume_model_train auto.
    preempted = {"flag": False}

    def on_sigterm(signum, frame):
        preempted["flag"] = True

    prev_handler, handler_installed = None, False
    try:
        prev_handler = signal.signal(signal.SIGTERM, on_sigterm)
        handler_installed = True
    except ValueError:
        pass  # not the main thread

    idx = -1
    try:
        for epoch in range(params["num_epochs"]):
            print("Epoch %d started." % (epoch + 1))
            train_loss = []
            batches = device_prefetch(train_data_loader, ts.device)
            while True:
                with timer.stage("data"):
                    batch = next(batches, None)
                if batch is None:
                    break
                idx = len(train_loss)
                _, images, captions, lengths = batch
                with timer.stage("step"):
                    loss = float(step(ts, images, captions, lengths))  # device sync: keeps timings honest
                train_loss.append(loss)
                if profile_dir and epoch == 0:
                    if idx + 1 == 1:
                        activities = [torch.profiler.ProfilerActivity.CPU]
                        if ts.device.type == "cuda":
                            activities.append(torch.profiler.ProfilerActivity.CUDA)
                        profiler = torch.profiler.profile(activities=activities)
                        profiler.start()
                    elif idx + 1 >= 6:
                        stop_profile()
                if preempted["flag"]:
                    stop_profile()
                    create_checkpoint(ts, epoch + 1, idx + 1, train_loss, params)
                    print("Preempted (SIGTERM): checkpoint saved at epoch %d step %d; resume with "
                          "--resume_training 1 --resume_model_train auto." % (epoch + 1, idx + 1))
                    raise SystemExit(143)
                if (idx + 1) % 5000 == 0:
                    create_checkpoint(ts, epoch + 1, idx + 1, train_loss, params)
                if (idx + 1) % 500 == 0 or (idx + 1) == len(train_data_loader):
                    print("Epoch %d (Step %d) - %0.4f train loss, %0.2f time."
                          % (epoch + 1, idx + 1, train_loss[-1], time.time() - start_time))
                    logger.log("train_step", step=idx + 1, epoch=epoch + 1, loss=train_loss[-1],
                               timing=timer.summary())
            stop_profile()  # an epoch shorter than the trace window
            print("Epoch %d - %0.4f loss, %.2f time. " % (epoch + 1, np.mean(train_loss), time.time() - start_time))
            logger.log("epoch", step=idx + 1, epoch=epoch + 1, mean_loss=float(np.mean(train_loss)),
                       timing=timer.summary())
            create_checkpoint(ts, epoch + 1, idx + 1, train_loss, params)
            if params.get("keep_checkpoints", 0):
                prune_checkpoints(params["output_dir"], int(params["keep_checkpoints"]))
            timer.reset()
    finally:
        if handler_installed:
            signal.signal(signal.SIGTERM, prev_handler if prev_handler is not None else signal.SIG_DFL)
    print("Training completed.")
    return ts
