"""The dp x mp meshes of tests/test_torch_mesh_serve.py and
tests/test_torch_mesh_eval.py: groups of gloo ranks spawned apart from the
tests' process (which imports jax).

    python tests/torch_mesh_ranks.py JOB WORKDIR TIMEOUT [WORLDS]

JOB is "serve" or "eval".  Reads WORKDIR/inputs.pkl (weights, images,
batches; no jax here), runs ``serve_rank`` or ``eval_rank`` on a group of
two ranks (meshes (2, 1) and (1, 2); the eval (1, 2)), then on a group of
four (mesh (2, 2)), each group joined by ``parallel.multihost.spawn`` and
ended after TIMEOUT seconds, and writes WORKDIR/results.pkl: {world size:
each rank's results, in rank order}.  WORLDS (default "2,4") names the
group sizes to run.  The eval passes the inputs' "use_pallas" (default -1)
to test_model.  The serve job then runs ``serve.main --dp 2`` on the files
the inputs name and records what it printed.
"""

import contextlib
import io
import os
import pickle
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from show_tell_tpu_torch.evaluation.tester import test_model  # noqa: E402
from show_tell_tpu_torch.models.captioner import CaptionerConfig  # noqa: E402
from show_tell_tpu_torch.ops.vocab import project_logits  # noqa: E402
from show_tell_tpu_torch.parallel import multihost  # noqa: E402
from show_tell_tpu_torch.parallel.mesh import vocab_argmax, vocab_log_softmax, vocab_topk  # noqa: E402
from show_tell_tpu_torch.serve import Captioner  # noqa: E402
from show_tell_tpu_torch.train.train_step import create_train_state  # noqa: E402

SERVE_MESHES = {2: ((2, 1), (1, 2)), 4: ((2, 2),)}
EVAL_MESHES = {2: ((1, 2),), 4: ((2, 2),)}


class EvalVocab:
    """The vocabulary interface the Captioner and test_model read: the four specials, then words w4, w5, ..."""

    def __init__(self, size):
        self.index_to_word = ["<pad>", "<start>", "<end>", "<unk>"] + ["w%d" % i for i in range(4, size)]
        self.word_to_index = {w: i for i, w in enumerate(self.index_to_word)}

    def start_token(self):
        return "<start>"

    def end_token(self):
        return "<end>"

    def __len__(self):
        return len(self.index_to_word)


class ListLoader:
    """Batches from a list, with the ``batch_size`` test_model reads."""

    def __init__(self, batches, batch_size):
        self.batches, self.batch_size = batches, batch_size

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


def _gather_columns(shard, x):
    """A shard's columns [B, size] of every mp rank, as the padded row [B, padded]."""
    parts = [torch.empty_like(x) for _ in range(shard.mesh.mp)]
    dist.all_gather(parts, x.contiguous(), group=shard.mesh.mp_group)
    return torch.cat(parts, dim=-1)


def _shard_checks(cap, inputs):
    """The collectives on this mesh's mp group, on the planted inputs: the
    argmax and top-k of columns cut from a global row (ties across the
    shard boundary), and the full logits and log-probabilities of one top
    activation gathered from the shards."""
    shard = cap.prepared["shard"]
    cols = slice(shard.lo, shard.lo + shard.size)
    ties = torch.from_numpy(inputs["argmax_rows"])
    cand = torch.from_numpy(inputs["topk_cand"])
    vals, idx = vocab_topk(shard, cand[..., cols].contiguous(), inputs["topk_k"])
    logits = project_logits(cap.prepared["vocab"], torch.from_numpy(inputs["top"]))
    return {
        "argmax": vocab_argmax(shard, ties[:, cols].contiguous()).numpy(),
        "topk": (vals.numpy(), idx.numpy()),
        "logits": _gather_columns(shard, logits).numpy(),
        "logp": _gather_columns(shard, vocab_log_softmax(shard, logits)).numpy(),
    }


def _pad_checks(case, inputs, dp, mp):
    """A V that mp does not divide, in f32 and bf16: the pad's bias and
    weights on the rank that holds it, and the ids of greedy and beam
    requests (never a padded column); in both dtypes, columns whose real
    logits are all -1e8 against the pad's -1e9."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = CaptionerConfig(*case["cfg"])
        cap = Captioner(case["params"], case["bn_state"], cfg, EvalVocab(cfg.vocab_size), dtype, device="cpu",
                        dp=dp, mp=mp)
        shard, dec = cap.prepared["shard"], cap.model.decoder
        real = max(0, min(shard.size, cfg.vocab_size - shard.lo))  # this rank's real columns
        low = {"w": torch.zeros_like(cap.prepared["vocab"]["w"]), "b": cap.prepared["vocab"]["b"].clone()}
        low["b"][:real] = -1e8
        logits = project_logits(low, torch.zeros(3, cfg.hidden_dim, dtype=low["w"].dtype))
        out[dtype] = {
            "pad_bias": dec.linear.bias[real:].float().numpy(),
            "pad_weight_max": float(dec.linear.weight[real:].abs().max()) if real < shard.size else 0.0,
            "pad_embedding_max": float(dec.embeddings.weight[real:].abs().max()) if real < shard.size else 0.0,
            "greedy": cap.caption_ids(inputs["images"]),
            "beam": cap.caption_ids(inputs["images"], inputs["beam_size"]),
            "low_argmax": vocab_argmax(shard, logits).numpy(),
            "low_topk": vocab_topk(shard, logits[:, None], 3)[1].numpy(),
            "low_logp_finite": bool(torch.isfinite(vocab_log_softmax(shard, logits)).all()),
        }
    return out


def serve_rank(work):
    """One rank's serving runs on each mesh of its group; returns them."""
    torch.set_num_threads(1)
    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    world = multihost.process_count()
    out = {"rank": multihost.process_index(), "meshes": {}}
    for dp, mp in SERVE_MESHES[world]:
        got = {}
        for name, case in inputs["cases"].items():
            cfg = CaptionerConfig(*case["cfg"])
            vocab = EvalVocab(cfg.vocab_size)
            cap = Captioner(case["params"], case["bn_state"], cfg, vocab, "float32", device="cpu", dp=dp, mp=mp)
            dec = cap.model.decoder
            r = {
                "shapes": {"linear.weight": tuple(dec.linear.weight.shape), "linear.bias": tuple(dec.linear.bias.shape),
                           "embeddings": tuple(dec.embeddings.weight.shape),
                           "prepared.vocab": tuple(cap.prepared["vocab"]["w"].shape)},
                "greedy": cap.caption_ids(inputs["images"]),
                "beam": cap.caption_ids(inputs["images"], inputs["beam_size"]),
            }
            early = Captioner(case["end_params"], case["bn_state"], cfg, vocab, "float32", early_exit=True,
                              device="cpu", dp=dp, mp=mp)
            r["early_greedy"] = early.caption_ids(inputs["images"])
            r["early_beam"] = early.caption_ids(inputs["images"], inputs["beam_size"])
            if mp > 1:
                shard = cap.prepared["shard"]
                r["shard"] = (shard.lo, shard.size, shard.padded)
                r.update(_shard_checks(cap, inputs) if name == inputs["tie_case"] else {})
            got[name] = r
            if dp > 1 and name == inputs["tie_case"]:
                try:
                    cap.caption_ids(inputs["images"][:3])
                except ValueError as e:
                    out["dp_error"] = str(e)
        if mp > 1:
            out.setdefault("pad", {})[(dp, mp)] = _pad_checks(inputs["cases"][inputs["pad_case"]], inputs, dp, mp)
        out["meshes"][(dp, mp)] = got
    return out


def eval_rank(work):
    """One rank's sharded test_model runs on its group's mesh; returns the scores of each."""
    torch.set_num_threads(1)
    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    world = multihost.process_count()
    out = {"rank": multihost.process_index(), "meshes": {}}
    for dp, mp in EVAL_MESHES[world]:
        got = {}
        for name, case in inputs["cases"].items():
            cfg = CaptionerConfig(*case["cfg"])
            ts = create_train_state(cfg, "SGD", 0.05, device="cpu", init=case["init"])
            for beam_size in case["beam_sizes"]:
                out_dir = os.path.join(work, "eval_%s_%d_%d_k%d" % (name, dp, mp, beam_size))
                os.makedirs(out_dir, exist_ok=True)
                got[name, beam_size] = test_model(
                    ts, cfg, ListLoader(inputs["batches"], 8), EvalVocab(cfg.vocab_size),
                    {"output_dir": out_dir, "dp": dp, "mp": mp, "eval_augment": 0, "score_threads": 1,
                     "use_pallas": inputs.get("use_pallas", -1)},
                    beam_size=beam_size, seed=7)
        out["meshes"][(dp, mp)] = got
    return out


def main():
    job, work, timeout = sys.argv[1], sys.argv[2], float(sys.argv[3])
    worlds = [int(w) for w in (sys.argv[4] if len(sys.argv) > 4 else "2,4").split(",")]
    rank_fn = {"serve": serve_rank, "eval": eval_rank}[job]
    results = {world: multihost.spawn(rank_fn, world, (work,), "cpu", timeout=timeout) for world in worlds}
    if job == "serve":
        from show_tell_tpu_torch import serve

        with open(os.path.join(work, "inputs.pkl"), "rb") as f:
            argv = pickle.load(f)["cli_argv"]
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = serve.main(argv)
        results["cli"] = (rc, printed.getvalue())
    with open(os.path.join(work, "results.pkl"), "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main()
