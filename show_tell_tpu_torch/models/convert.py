"""The weight bridge between the JAX package's parameter trees and this
port's state_dicts, in numpy only (counterpart of show_tell_tpu/models/convert.py
and the torch loaders in its resnet.py and encoder.py).

JAX side: ``params = {"encoder": {"resnet": {torchvision-name: HWIO conv |
BN vector}, "linear_secondlast_layer": {"w" [C,E], "b"}, "last_layer":
{"weight", "bias"}}, "decoder": {"embedding" [V,E], "rnn": [{"w_ih" [in,3H],
"w_hh", "b_ih", "b_hh"}, ...], "linear": {"w" [H,V], "b"}}}`` and
``bn_state = {"resnet": {name.running_mean|var}, "last_layer": {...}}``.
The attention decoders add "init_h", "embed" (and "init_c" for the LSTM)
as {"w" [C,out], "b"} and "attn": {"encoder_att", "decoder_att",
"full_att"}, each {"w" [in,out], "b"}.

Port side: ``{"encoder": state_dict, "decoder": state_dict}`` with
torchvision's names under ``resnet.`` (OIHW convs), ``linear_secondlast_layer.*``
and ``last_layer.*`` (nn.Linear layout), and the reference decoder's names
(``embeddings.weight``, ``unit.weight_ih_l{k}``, ..., ``linear.weight``,
and for attention ``init_h.*``, ``embed.*``, ``attn.encoder_att.*``, ...).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

_RUNNING = (".running_mean", ".running_var")
# The attention decoders' extra nn.Linear layers: torch prefix -> path in the JAX tree.
_ATTN_LINEARS = {
    "init_h": ("init_h",),
    "init_c": ("init_c",),
    "embed": ("embed",),
    "attn.encoder_att": ("attn", "encoder_att"),
    "attn.decoder_att": ("attn", "decoder_att"),
    "attn.full_att": ("attn", "full_att"),
}


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

    return {"encoder": enc, "decoder": decoder_from_jax(params["decoder"])}


def decoder_from_jax(dec_p: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A JAX decoder tree (pooled or attention) -> the decoder's state_dict."""
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
    for prefix, path in _ATTN_LINEARS.items():
        node = dec_p
        for key in path:
            node = node.get(key) if isinstance(node, dict) else None
        if node is not None:
            dec[prefix + ".weight"] = _T(node["w"])
            dec[prefix + ".bias"] = np.asarray(node["b"])
    return dec


def params_to_jax(state_dicts: Dict[str, Dict[str, Any]]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The inverse of ``params_from_jax``: -> (params, bn_state) numpy trees."""
    enc = {k: np.asarray(v) for k, v in state_dicts["encoder"].items()}
    res_p, res_s = {}, {}
    for k, v in enc.items():
        if not k.startswith("resnet."):
            continue
        name = k[len("resnet."):]
        if name.endswith(_RUNNING):
            res_s[name] = v
        else:
            res_p[name] = np.ascontiguousarray(v.transpose(2, 3, 1, 0)) if v.ndim == 4 else v  # OIHW->HWIO
    params = {
        "encoder": {
            "resnet": res_p,
            "linear_secondlast_layer": {
                "w": _T(enc["linear_secondlast_layer.weight"]),
                "b": enc["linear_secondlast_layer.bias"],
            },
            "last_layer": {"weight": enc["last_layer.weight"], "bias": enc["last_layer.bias"]},
        },
        "decoder": decoder_to_jax(state_dicts["decoder"]),
    }
    bn_state = {
        "resnet": res_s,
        "last_layer": {
            "running_mean": enc["last_layer.running_mean"],
            "running_var": enc["last_layer.running_var"],
        },
    }
    return params, bn_state


def decoder_to_jax(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of ``decoder_from_jax``."""
    dec = {k: np.asarray(v) for k, v in state_dict.items()}
    n_layers = sum(1 for k in dec if k.startswith("unit.weight_ih_l"))
    tree: Dict[str, Any] = {
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
    }
    for prefix, path in _ATTN_LINEARS.items():
        if prefix + ".weight" in dec:
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = {"w": _T(dec[prefix + ".weight"]), "b": dec[prefix + ".bias"]}
    return tree


def trainable_from_jax(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A tree shaped like the JAX package's trainable split (its weights,
    gradients or optimizer moments: {"decoder": ..., "encoder":
    {"linear_secondlast_layer", "last_layer"}}) -> {the port's parameter
    name under CaptionerModel: array in the port's layout}."""
    out = {"decoder." + k: v for k, v in decoder_from_jax(tree["decoder"]).items()}
    lin, bn = tree["encoder"]["linear_secondlast_layer"], tree["encoder"]["last_layer"]
    out["encoder.linear_secondlast_layer.weight"] = _T(lin["w"])
    out["encoder.linear_secondlast_layer.bias"] = np.asarray(lin["b"])
    out["encoder.last_layer.weight"] = np.asarray(bn["weight"])
    out["encoder.last_layer.bias"] = np.asarray(bn["bias"])
    return out
