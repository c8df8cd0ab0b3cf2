"""How near the f32 pooled steps' new states come to float64, against the plain twin's, on one NVIDIA GPU.

    python tools/f32_step_precision.py [--seeds N]

The f32 greedy step (fused_gru_decode_step_cuda, fused_lstm_decode_step_cuda:
the 3xTF32 layers that the dense, top-k and stack steps share bit for bit) and
its plain twin (cuBLAS in f32, TF32 off) on the same operands, each held to the
recurrence in float64 from those operands: the largest and the root-mean-square
distance of the new states (h, and c for the LSTM), at the flagship widths (L=5,
H=512, E=256 GRU, 512 LSTM), B = 1, 19, 32, 64, 512, weights in +-1/sqrt(H)
(the decoder init's scale) and in +-0.3 (sums of several units), N seeds each.
Prints the card's name and power limit, one line a case, a summary of the cases
in which the kernel was no farther than the twin by B, and a JSON line.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def f64_states(stacked, x, state):
    """The L-layer recurrence in float64 from the same f32 operands: the new states, flattened as ``flat`` does
    (every layer's h, then every layer's c)."""
    import torch

    d = lambda v: v.double()
    lstm = isinstance(state, tuple)
    hs, cs = (d(state[0]), d(state[1])) if lstm else (d(state), None)
    H, inp, out, out_c = hs.shape[2], d(x), [], []
    for l in range(hs.shape[0]):
        w_ih = stacked["w_ih0"] if l == 0 else stacked["w_ihU"][l - 1]
        gx = torch.addmm(d(stacked["b_ih"][l]), inp, d(w_ih).T).split(H, dim=1)
        gh = torch.addmm(d(stacked["b_hh"][l]), hs[l], d(stacked["w_hh"][l]).T).split(H, dim=1)
        if lstm:
            c = torch.sigmoid(gx[1] + gh[1]) * cs[l] + torch.sigmoid(gx[0] + gh[0]) * torch.tanh(gx[2] + gh[2])
            inp = torch.sigmoid(gx[3] + gh[3]) * torch.tanh(c)
            out_c.append(c.flatten())
        else:
            r, z = torch.sigmoid(gx[0] + gh[0]), torch.sigmoid(gx[1] + gh[1])
            inp = (1 - z) * torch.tanh(gx[2] + r * gh[2]) + z * hs[l]
        out.append(inp.flatten())
    return torch.cat(out + out_c)


def flat(state):
    import torch

    return torch.cat([s.double().flatten() for s in (state if isinstance(state, tuple) else (state,))])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import numpy as np
    import torch

    from show_tell_tpu_torch.ops.fused_step import (
        fused_gru_decode_step_cuda,
        fused_gru_decode_step_plain,
        fused_lstm_decode_step_cuda,
        fused_lstm_decode_step_plain,
    )

    if not torch.cuda.is_available():
        cs.fail("torch finds no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    device, f32 = torch.device("cuda", 0), torch.float32
    cases, nearer = [], {}
    for cell, Ed, step, plain in (("gru", cs.E, fused_gru_decode_step_cuda, fused_gru_decode_step_plain),
                                  ("lstm", cs.LE, fused_lstm_decode_step_cuda, fused_lstm_decode_step_plain)):
        G = cs.GATES[cell] * cs.H
        for scale in (cs.H ** -0.5, 0.3):
            for B in (1, 19, 32, 64, 512):
                for seed in range(args.seeds):
                    rng = np.random.RandomState(seed)
                    u = lambda *shape: cs.uniform(rng, shape, scale, f32, device)
                    stacked = {"w_ih0": u(G, Ed), "w_ihU": u(cs.L - 1, G, cs.H), "w_hh": u(cs.L, G, cs.H),
                               "b_ih": u(cs.L, G), "b_hh": u(cs.L, G)}
                    vocab = cs.vocab_inputs(rng, cs.H, f32, device)
                    x = torch.from_numpy(rng.randn(B, Ed).astype("float32")).to(device)
                    state = cs.state_inputs(rng, B, f32, device, cell)
                    exact = f64_states(stacked, x, state)
                    ours = (flat(step(stacked, vocab, x, state)[1]) - exact).abs()
                    twin = (flat(plain(stacked, vocab, x, state)[1]) - exact).abs()
                    row = {"cell": cell, "scale": scale, "B": B, "seed": seed, "kernel_max": ours.max().item(),
                           "kernel_rms": ours.square().mean().sqrt().item(), "twin_max": twin.max().item(),
                           "twin_rms": twin.square().mean().sqrt().item()}
                    cases.append(row)
                    key = "%s B=%d" % (cell, B)
                    hits = nearer.setdefault(key, [0, 0, 0])
                    hits[0] += row["kernel_max"] <= row["twin_max"]
                    hits[1] += row["kernel_rms"] <= row["twin_rms"]
                    hits[2] += 1
                    print("%s float32 %s step B=%d scale %.4f seed %d: from f64, kernel max %.3e rms %.3e; twin max "
                          "%.3e rms %.3e; kernel rms / twin rms %.3f"
                          % (smi, cell, B, scale, seed, row["kernel_max"], row["kernel_rms"], row["twin_max"],
                             row["twin_rms"], row["kernel_rms"] / row["twin_rms"]), flush=True)
    print("%s cases where the kernel is no farther from f64 than the twin (max, rms, of n): %s"
          % (smi, ", ".join("%s %d, %d of %d" % (k, *v) for k, v in nearer.items())), flush=True)
    print(json.dumps({"card": smi, "cases": cases}), flush=True)


if __name__ == "__main__":
    main()
