"""Checkpoints in the JAX package's pickle layout (counterpart of
show_tell_tpu/train/checkpoint.py).

``model_<epoch>.ckpt`` is a pickle of
``{"format": "show_tell_tpu.v1", "encoder_state_dict": {"trainable": {...},
"frozen": {"resnet": ...}, "bn_state": {...}}, "decoder_state_dict": {...},
"optimizer_state_dict": ..., "epoch": N, "step": S}`` with the weights and
BatchNorm statistics as numpy trees in the JAX layout
(models/convert.params_to_jax), and ``model_<epoch>_metrics.ckpt`` holds
``{"train_loss": [...]}``; both are written atomically (tmp + rename).  So
either package reads the other's: the port's serving and training read
the JAX package's files, and the JAX package's ``load_checkpoint`` +
``restore_train_state`` read the port's.

The optimizer state is each package's own.  The port writes
``{"format": "torch.optim", "type": "SGD" | "Adam", "state": {parameter
name: {"momentum_buffer"} | {"step", "exp_avg", "exp_avg_sq"}}}`` in the
port's names and layouts.  The JAX package's restore cannot map that onto
its optax state: it keeps the weights and BN statistics and resets the
optimizer with its printed notice.  A JAX checkpoint's optax state is read
here through the opaque tuples of ``_NumpyTreeUnpickler``: ``TraceState``
(SGD's momentum) becomes each parameter's ``momentum_buffer``, and
``ScaleByAdamState(count, mu, nu)`` becomes ``step``, ``exp_avg`` and
``exp_avg_sq``, so a JAX run resumes in the port with its optimizer state.

Resume follows the reference: weights and optimizer state are restored,
training restarts at epoch 0 (the saved epoch and step are never read
back).  The JAX package's orbax directories (``model_<N>.orbax``) are not
read or written here: pickle files only.
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from show_tell_tpu_torch.models.captioner import model_trees, trainable_parameters
from show_tell_tpu_torch.models.convert import params_from_jax, trainable_from_jax

FORMAT = "show_tell_tpu.v1"
TORCH_OPTIM = "torch.optim"


class _NumpyTreeUnpickler(pickle.Unpickler):
    """Reads the JAX package's pickle checkpoints without importing jax:
    numpy and builtin types load as themselves, and any other class (the
    optimizer's state tuples) becomes an inert tuple of its fields that
    keeps its class name (``TraceState``, ``ScaleByAdamState``)."""

    _ALLOWED = ("numpy", "ml_dtypes", "builtins", "collections", "copyreg", "_codecs")

    def find_class(self, module: str, name: str):
        if module.split(".")[0] in self._ALLOWED:
            return super().find_class(module, name)
        return type(name, (_Opaque,), {"__module__": module})


class _Opaque(tuple):
    def __new__(cls, *args, **kwargs):
        return tuple.__new__(cls, args)

    def __setstate__(self, state):
        pass


def _atomic_pickle(obj, path: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
    os.replace(tmp, path)


def read_checkpoint(path: str) -> Dict[str, Any]:
    """The raw payload of a show_tell_tpu pickle checkpoint (the JAX
    package's ``load_checkpoint``), written by either package."""
    with open(path, "rb") as f:
        ckpt = _NumpyTreeUnpickler(f).load()
    if not (isinstance(ckpt, dict) and str(ckpt.get("format", "")).startswith("show_tell_tpu")):
        raise ValueError(
            "%s is not a show_tell_tpu pickle checkpoint (reading reference torch .ckpt files "
            "is ROADMAP Queue 1 item 2, serving leftovers)" % path
        )
    return ckpt


def checkpoint_trees(ckpt: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A checkpoint's payload -> (params, bn_state) numpy trees in the JAX layout."""
    enc = ckpt["encoder_state_dict"]
    params = {
        "encoder": {
            "resnet": enc["frozen"]["resnet"],
            "linear_secondlast_layer": enc["trainable"]["linear_secondlast_layer"],
            "last_layer": enc["trainable"]["last_layer"],
        },
        "decoder": ckpt["decoder_state_dict"],
    }
    return params, enc["bn_state"]


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A show_tell_tpu pickle checkpoint -> (params, bn_state) numpy trees
    in the JAX layout (what serving reads)."""
    return checkpoint_trees(read_checkpoint(path))


def _optimizer_payload(ts) -> Dict[str, Any]:
    names = {p: n for n, p in trainable_parameters(ts.model).items()}
    state = {}
    for p, st in ts.optimizer.state.items():
        state[names[p]] = {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
                           for k, v in st.items()}
    return {"format": TORCH_OPTIM, "type": type(ts.optimizer).__name__, "state": state}


def create_checkpoint(ts, epoch: int, step: int, train_loss, params: Dict[str, Any],
                      extra: Optional[Dict[str, Any]] = None) -> str:
    """Write model_<epoch>.ckpt and model_<epoch>_metrics.ckpt into
    params['output_dir'] (atomically); returns the model file's path."""
    model_params, bn_state = model_trees(ts.model)
    model_file = os.path.join(params["output_dir"], "model_%d.ckpt" % epoch)
    payload = {
        "format": FORMAT,
        "encoder_state_dict": {
            "trainable": {k: model_params["encoder"][k] for k in ("linear_secondlast_layer", "last_layer")},
            "frozen": {"resnet": model_params["encoder"]["resnet"]},
            "bn_state": bn_state,
        },
        "decoder_state_dict": model_params["decoder"],
        "optimizer_state_dict": _optimizer_payload(ts),
        "epoch": epoch,
        "step": step,
    }
    if extra:
        payload.update(extra)
    _atomic_pickle(payload, model_file)
    _atomic_pickle({"train_loss": list(train_loss)},
                   os.path.join(params["output_dir"], "model_%d_metrics.ckpt" % epoch))
    print("Checkpoint created for Epoch %d (Step %d)." % (epoch, step))
    return model_file


def resolve_checkpoint_path(output_dir: str, name: str) -> str:
    """``model_N`` -> ``output_dir/model_N.ckpt`` (pickle files only)."""
    return os.path.join(output_dir, name + ".ckpt")


def _list_checkpoints(output_dir: str) -> Dict[int, str]:
    out = {}
    for name in os.listdir(output_dir):
        m = re.fullmatch(r"model_(\d+)\.ckpt", name)
        if m:
            out[int(m.group(1))] = os.path.join(output_dir, name)
    return out


def find_latest_checkpoint(output_dir: str) -> Optional[str]:
    """The newest epoch's checkpoint, for ``resume_model_train auto``."""
    ckpts = _list_checkpoints(output_dir)
    return ckpts[max(ckpts)] if ckpts else None


def prune_checkpoints(output_dir: str, keep_last: int) -> None:
    """Keep the newest ``keep_last`` checkpoint epochs and their metrics files."""
    if keep_last <= 0:
        return
    ckpts = _list_checkpoints(output_dir)
    for epoch in sorted(ckpts)[:-keep_last]:
        for p in (ckpts[epoch], os.path.join(output_dir, "model_%d_metrics.ckpt" % epoch)):
            if os.path.isfile(p):
                os.remove(p)


def _optax_moments(opt_ckpt) -> Optional[Tuple[str, Dict[str, Any]]]:
    """A JAX checkpoint's optax state -> ("SGD" | "Adam", {field: trainable
    tree}) read through its opaque tuples; None if it holds neither."""
    for part in opt_ckpt if isinstance(opt_ckpt, tuple) else ():
        kind = type(part).__name__
        if kind == "TraceState":
            return "SGD", {"momentum_buffer": part[0]}
        if kind == "ScaleByAdamState":
            return "Adam", {"step": part[0], "exp_avg": part[1], "exp_avg_sq": part[2]}
    return None


def _optimizer_state(ts, opt_ckpt) -> Optional[Dict[str, Dict[str, Any]]]:
    """{parameter name: torch optimizer state} from either package's
    optimizer payload, or None if it was written by another optimizer."""
    kind = type(ts.optimizer).__name__
    if isinstance(opt_ckpt, dict) and opt_ckpt.get("format") == TORCH_OPTIM:
        return opt_ckpt["state"] if opt_ckpt["type"] == kind else None
    found = _optax_moments(opt_ckpt)
    if found is None or found[0] != kind:
        return None
    fields = {k: v for k, v in found[1].items() if k != "step"}
    per_field = {k: trainable_from_jax(v) for k, v in fields.items()}
    state = {}
    for name in trainable_parameters(ts.model):
        state[name] = {k: per_field[k][name] for k in fields}
        if kind == "Adam":  # optax counts steps once for the tree; torch once per parameter
            state[name]["step"] = np.float32(found[1]["step"])
    return state


def restore_train_state(ts, ckpt: Dict[str, Any]):
    """Load a checkpoint's weights, BN statistics and optimizer state into
    the TrainState ``ts`` (shapes must match) and return it.  The flips'
    generator and the step count stay as they are (the JAX package keeps
    its fresh key and count).  An optimizer state written by another
    optimizer is reset, with the JAX package's notice."""
    params, bn_state = checkpoint_trees(ckpt)
    sds = params_from_jax(params, bn_state)
    with torch.no_grad():
        for part in ("encoder", "decoder"):
            module = getattr(ts.model, part)
            sd = module.state_dict()
            if sorted(sd) != sorted(sds[part]):
                raise ValueError("checkpoint %s keys differ from the model's: %s"
                                 % (part, sorted(set(sd) ^ set(sds[part]))[:5]))
            for k, v in sds[part].items():
                sd[k].copy_(torch.from_numpy(np.array(v)))
    ts.model.encoder.train(ts.model.encoder.training)  # drop the stem operands built from the old bn1
    state = _optimizer_state(ts, ckpt["optimizer_state_dict"])
    ts.optimizer.state.clear()
    if state is None:
        print("Optimizer state in checkpoint does not match the current optimizer; resetting it.")
        return ts
    params_by_name = trainable_parameters(ts.model)
    for name, st in state.items():
        p = params_by_name[name]
        ts.optimizer.state[p] = {
            k: (torch.tensor(float(v), dtype=torch.float32) if k == "step"
                else torch.from_numpy(np.array(v)).to(p.device))
            for k, v in st.items()
        }
    return ts
