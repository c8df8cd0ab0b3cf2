"""The weight bridge between the JAX package's parameter trees and this
port's state_dicts, in numpy only (counterpart of show_tell_tpu/models/convert.py
and the torch loaders in its resnet.py and encoder.py).

JAX side: ``params = {"encoder": {"resnet": {torchvision-name: HWIO conv |
BN vector}, "linear_secondlast_layer": {"w" [C,E], "b"}, "last_layer":
{"weight", "bias"}}, "decoder": {"embedding" [V,E], "rnn": [{"w_ih" [in,3H],
"w_hh", "b_ih", "b_hh"}, ...], "linear": {"w" [H,V], "b"}}}`` and
``bn_state = {"resnet": {name.running_mean|var}, "last_layer": {...}}``.

Port side: ``{"encoder": state_dict, "decoder": state_dict}`` with
torchvision's names under ``resnet.`` (OIHW convs), ``linear_secondlast_layer.*``
and ``last_layer.*`` (nn.Linear layout), and the reference decoder's names
(``embeddings.weight``, ``unit.weight_ih_l{k}``, ..., ``linear.weight``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

_RUNNING = (".running_mean", ".running_var")


def _T(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a).T)


def params_from_jax(params: Dict[str, Any], bn_state: Dict[str, Any]) -> Dict[str, Dict[str, np.ndarray]]:
    """JAX (params, bn_state) trees -> {"encoder": sd, "decoder": sd}."""
    enc_p, enc_s = params["encoder"], bn_state
    enc: Dict[str, np.ndarray] = {}
    for k, v in enc_p["resnet"].items():
        v = np.asarray(v)
        enc["resnet." + k] = np.ascontiguousarray(v.transpose(3, 2, 0, 1)) if v.ndim == 4 else v  # HWIO->OIHW
    for k, v in enc_s["resnet"].items():
        enc["resnet." + k] = np.asarray(v)
    enc["linear_secondlast_layer.weight"] = _T(enc_p["linear_secondlast_layer"]["w"])
    enc["linear_secondlast_layer.bias"] = np.asarray(enc_p["linear_secondlast_layer"]["b"])
    for k in ("weight", "bias"):
        enc["last_layer." + k] = np.asarray(enc_p["last_layer"][k])
    for k in ("running_mean", "running_var"):
        enc["last_layer." + k] = np.asarray(enc_s["last_layer"][k])

    dec_p = params["decoder"]
    dec: Dict[str, np.ndarray] = {
        "embeddings.weight": np.asarray(dec_p["embedding"]),
        "linear.weight": _T(dec_p["linear"]["w"]),
        "linear.bias": np.asarray(dec_p["linear"]["b"]),
    }
    for l, layer in enumerate(dec_p["rnn"]):
        dec["unit.weight_ih_l%d" % l] = _T(layer["w_ih"])
        dec["unit.weight_hh_l%d" % l] = _T(layer["w_hh"])
        dec["unit.bias_ih_l%d" % l] = np.asarray(layer["b_ih"])
        dec["unit.bias_hh_l%d" % l] = np.asarray(layer["b_hh"])
    return {"encoder": enc, "decoder": dec}


def params_to_jax(state_dicts: Dict[str, Dict[str, Any]]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The inverse of ``params_from_jax``: -> (params, bn_state) numpy trees."""
    enc = {k: np.asarray(v) for k, v in state_dicts["encoder"].items()}
    dec = {k: np.asarray(v) for k, v in state_dicts["decoder"].items()}
    res_p, res_s = {}, {}
    for k, v in enc.items():
        if not k.startswith("resnet."):
            continue
        name = k[len("resnet."):]
        if name.endswith(_RUNNING):
            res_s[name] = v
        else:
            res_p[name] = np.ascontiguousarray(v.transpose(2, 3, 1, 0)) if v.ndim == 4 else v  # OIHW->HWIO
    n_layers = sum(1 for k in dec if k.startswith("unit.weight_ih_l"))
    params = {
        "encoder": {
            "resnet": res_p,
            "linear_secondlast_layer": {
                "w": _T(enc["linear_secondlast_layer.weight"]),
                "b": enc["linear_secondlast_layer.bias"],
            },
            "last_layer": {"weight": enc["last_layer.weight"], "bias": enc["last_layer.bias"]},
        },
        "decoder": {
            "embedding": dec["embeddings.weight"],
            "rnn": [
                {
                    "w_ih": _T(dec["unit.weight_ih_l%d" % l]),
                    "w_hh": _T(dec["unit.weight_hh_l%d" % l]),
                    "b_ih": dec["unit.bias_ih_l%d" % l],
                    "b_hh": dec["unit.bias_hh_l%d" % l],
                }
                for l in range(n_layers)
            ],
            "linear": {"w": _T(dec["linear.weight"]), "b": dec["linear.bias"]},
        },
    }
    bn_state = {
        "resnet": res_s,
        "last_layer": {
            "running_mean": enc["last_layer.running_mean"],
            "running_var": enc["last_layer.running_var"],
        },
    }
    return params, bn_state
