"""tests/test_torch_parallel.py's two-rank gloo group, spawned apart from
the test's process (which imports jax).

    python tests/torch_parallel_driver.py WORKDIR TIMEOUT

Reads WORKDIR/inputs.pkl (the weights, batches and eval batches the test
wrote; no jax here), runs ``rank_main`` on two ranks joined by
``parallel.multihost.spawn`` (ended after TIMEOUT seconds), and writes
WORKDIR/rank<R>.pkl for each rank R: for each family the three train
steps' losses and the final trainable parameters and BatchNorm
statistics; one step with flips; the sharded eval's scores; the
process-sharded loader's batches; the mesh errors and the SIGTERM
agreement.
"""

import os
import pickle
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from show_tell_tpu_torch.data.dataset import MSCOCO, DataLoader  # noqa: E402
from show_tell_tpu_torch.evaluation.tester import test_model  # noqa: E402
from show_tell_tpu_torch.models.captioner import CaptionerConfig, model_trees, trainable_parameters  # noqa: E402
from show_tell_tpu_torch.parallel import multihost  # noqa: E402
from show_tell_tpu_torch.parallel.mesh import any_rank, make_mesh  # noqa: E402
from show_tell_tpu_torch.train.train_step import create_train_state, make_train_step  # noqa: E402
from show_tell_tpu_torch.vocab import load_vocab  # noqa: E402


class EvalVocab:
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
    def __init__(self, batches, batch_size):
        self.batches, self.batch_size = batches, batch_size

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


def rank_and_world():
    """A spawned rank's place in its group (tests/test_torch_parallel.py's spawn test)."""
    return multihost.process_index(), multihost.process_count(), torch.distributed.get_backend()


def sleep_then(seconds):
    """A spawned rank that outlasts a short timeout."""
    import time

    time.sleep(seconds)


def rank_main(work):
    """One rank's runs, in the group; returns its results."""
    torch.set_num_threads(2)
    rank = multihost.process_index()
    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    mesh = make_mesh(2)
    out = {"rank": rank, "primary": multihost.is_primary(), "train": {}}

    for variant, case in inputs["train"].items():
        cfg = CaptionerConfig(*case["cfg"])
        ts = create_train_state(cfg, "SGD", inputs["lr"], device="cpu", init=case["init"], mesh=mesh)
        step = make_train_step(cfg, augment=False)
        losses = [float(step(ts, *batch)) for batch in inputs["batches"]]
        _, bn_state = model_trees(ts.model)
        out["train"][variant] = {
            "losses": losses,
            "trainable": {n: p.detach().numpy().copy() for n, p in trainable_parameters(ts.model).items()},
            "bn_state": bn_state,
        }

    # flips drawn for the global batch, each rank taking its rows
    case = inputs["train"]["gru"]
    cfg = CaptionerConfig(*case["cfg"])
    ts = create_train_state(cfg, "SGD", inputs["lr"], device="cpu", init=case["init"], mesh=mesh)
    out["flips_loss"] = float(make_train_step(cfg, augment=True)(ts, *inputs["batches"][0]))

    # the sharded eval: 2 batches of 8 and a tail of 3 (run whole on both ranks)
    ev = inputs["eval"]
    cfg = CaptionerConfig(*ev["cfg"])
    ets = create_train_state(cfg, "SGD", inputs["lr"], device="cpu", init=ev["init"])
    eval_dir = os.path.join(work, "eval")
    scored = []
    import show_tell_tpu_torch.evaluation.tester as tester

    evaluate = tester.evaluate

    def counting(*args):
        scored.append(1)
        return evaluate(*args)

    tester.evaluate = counting
    out["eval"] = test_model(ets, cfg, ListLoader(ev["batches"], 8), EvalVocab(cfg.vocab_size),
                             {"output_dir": eval_dir, "dp": 2, "score_threads": 1}, seed=7)
    tester.evaluate = evaluate
    out["eval_batches_scored"] = len(scored)

    # the process-sharded train loader
    data = inputs["data"]
    ds = MSCOCO(data["ann"], data["img_dir"], load_vocab(data["vocab"]), use_native_decode=False)
    loader = DataLoader(ds, 4, shuffle=True, drop_last=True, seed=1, process_shard=(rank, 2))
    out["loader"] = [(paths, images, captions, lengths) for paths, images, captions, lengths in loader]
    loader.close()

    errors = {}
    for name, dp in (("uneven", 1), ("oversized", 4)):
        try:
            make_mesh(dp)
        except ValueError as e:
            errors[name] = str(e)
    out["mesh_errors"] = errors
    out["preempt_one"] = any_rank(rank == 1, mesh)
    out["preempt_none"] = any_rank(False, mesh)
    return out


def main():
    work, timeout = sys.argv[1], float(sys.argv[2])
    for rank, out in enumerate(multihost.spawn(rank_main, 2, (work,), "cpu", timeout=timeout)):
        with open(os.path.join(work, "rank%d.pkl" % rank), "wb") as f:
            pickle.dump(out, f)


if __name__ == "__main__":
    main()
