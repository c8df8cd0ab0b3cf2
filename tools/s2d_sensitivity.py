"""How far differences in the s2d stem's output carry into the captions, on one NVIDIA GPU.

    python tools/s2d_sensitivity.py [--controls N]

For each of chip_smoke.py's four families (pooled GRU and LSTM, attention
GRU and LSTM; ResNet-101, random weights from seed 0, bf16, s2d), 64
images of 224 x 224 go through the fused stem's plain twin
(stem_fused_plain) and its kernel (stem_fused_cuda), and each stem output
through the plain ResNet, head and greedy step (T = 25).  Prints, for
each, the share of id positions (and of whole rows) equal to the decode
from the twin's output:

- the twin's output again (the decode's own repeatability);
- the kernel's output, and how many values it moves against the twin;
- N controls: the twin's output with as many values moved one bf16 ulp,
  at seeded random places (chip_smoke.ulp_nudges), and two with 4 and 16
  times as many;
- five stem faults: the last and the first k16 slice of the 192 taps
  dropped (the weight rows zeroed), the shift's border classes ignored
  (every position takes the interior's), output channel 5 zeroed, and
  the output's columns shifted by one.

A check on these ids tells a fault from one-ulp noise only where the
faults' shares fall below every control's.  Prints the card's name and
power limit first and a JSON line of every share last.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--controls", type=int, default=6, help="one-ulp controls a family")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import numpy as np
    import torch

    from show_tell_tpu_torch.models.attention import init_hidden, start_embeddings
    from show_tell_tpu_torch.models.captioner import CaptionerConfig, init_captioner
    from show_tell_tpu_torch.models.decoder import greedy_loop
    from show_tell_tpu_torch.models.rnn_cells import init_state
    from show_tell_tpu_torch.ops.fused_attn import fused_attn_decode_step_plain, prepare_attn_decode
    from show_tell_tpu_torch.ops.fused_step import fused_gru_decode_step_plain, fused_lstm_decode_step_plain
    from show_tell_tpu_torch.ops.stem import stem_fused_cuda, stem_fused_plain
    from show_tell_tpu_torch.serve import Captioner

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    imgs = np.random.RandomState(cs.SEED + 1).randint(0, 256, (64, cs.IMG, cs.IMG, 3), dtype=np.uint8)
    x = torch.from_numpy(imgs).to(device)

    def decode_from(cap, cfg, y):
        """ids [64, T] of the plain ResNet, head and greedy step from the stem output y (NHWC)."""
        enc, prep = cap.model.encoder, cap.prepared
        with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            feats = enc.head(enc.resnet.forward_from_stem(y.permute(0, 3, 1, 2)))
            if cfg.variant in ("gru", "lstm"):
                plain = fused_lstm_decode_step_plain if cfg.cell_type == "lstm" else fused_gru_decode_step_plain
                state0 = init_state(cfg.cell_type, cs.L, len(y), cs.H, cap.dtype, device)
                ids = greedy_loop(lambda xx, state: plain(prep["stacked"], prep["vocab"], xx, state),
                                  prep["embedding"], feats.to(cap.dtype), state0, cs.T)
            else:
                dec = cap.model.decoder
                aprep = prepare_attn_decode(prep, dec, feats.transpose(1, 2))
                ids = greedy_loop(lambda w_emb, state: fused_attn_decode_step_plain(aprep, w_emb, state),
                                  dec.embeddings.weight, start_embeddings(dec, len(y), cfg.start_token, device),
                                  init_hidden(dec, cfg.decoder_config(), feats), cs.T)
        return ids.cpu().numpy()

    report = {}
    for variant in ("gru", "lstm", "attn", "attn_lstm"):
        if variant in ("gru", "lstm"):
            cfg = CaptionerConfig(variant, 101, cs.E if variant == "gru" else cs.LE, cs.H, cs.V, cs.L)
        else:
            cfg = CaptionerConfig(variant, 101, cs.AE, cs.H, cs.V, cs.L, nos_filters=cs.AC, attn_dim=cs.AA)
        params, bn_state = init_captioner(cfg, torch.Generator().manual_seed(cs.SEED))
        cap = Captioner(params, bn_state, cfg, cs.SyntheticVocab(cs.V), "bfloat16", device="gpu", s2d=True)
        ops = cap.model.encoder.stem_operands()
        with torch.inference_mode():
            twin = stem_fused_plain(x, ops)
            kernel = stem_fused_cuda(x, ops)
            n = int((kernel != twin).sum())
            outputs = [("twin again", twin), ("kernel", kernel)]
            outputs += [("control %d" % k, cs.ulp_nudges(twin, n, k)) for k in range(args.controls)]
            outputs += [("control x%d" % m, cs.ulp_nudges(twin, m * n, 100 + m)) for m in (4, 16)]
            for name, rows in (("fault: last k16 slice dropped", slice(176, 192)),
                               ("fault: first k16 slice dropped", slice(0, 16))):
                w = ops["w"].clone()
                w[rows] = 0
                outputs.append((name, stem_fused_plain(x, dict(ops, w=w))))
            interior = ops["tc"][2, 2].expand_as(ops["t"]).contiguous()
            outputs.append(("fault: border classes ignored", stem_fused_plain(x, dict(ops, t=interior))))
            zeroed = twin.clone()
            zeroed[..., 5] = 0
            shifted = twin.clone()
            shifted[:, :, 1:] = twin[:, :, :-1]
            outputs += [("fault: channel 5 zeroed", zeroed), ("fault: columns shifted by one", shifted)]
        ref = decode_from(cap, cfg, twin)
        report[variant] = {}
        for name, y in outputs:
            ids = decode_from(cap, cfg, y)
            moved = int((y != twin).sum())
            share, rows = float((ids == ref).mean()), int((ids == ref).all(axis=1).sum())
            report[variant][name] = {"values_moved": moved, "share": share, "rows": rows}
            print("%s %s s2d bf16 B=64, decode from the stem's twin against that from %s (%d of %d values moved): "
                  "%.4f of positions, %d of 64 rows equal" % (smi, variant, name, moved, twin.numel(), share, rows),
                  flush=True)
    print(json.dumps({"card": smi, "shares": report}), flush=True)


if __name__ == "__main__":
    main()
