"""Data parallelism over torch.distributed (parallel/), two gloo ranks on the CPU.

A driver process (tests/torch_parallel_driver.py, with its own timeout)
spawns two ranks that form one group and run, each on its rows of every
batch:
three train steps of each family (SGD, no flips) from the JAX package's
seeded weights; one step with flips; the sharded ``test_model``; the
process-sharded loader; the mesh errors and the SIGTERM agreement.  Held
here against one process: the ranks agree exactly; their losses and
trainable checksum equal the JAX package's single-process steps on the
same weights and batches within rtol 1e-5, atol 1e-6 (the JAX multi-host
test's bars, tests/test_multihost.py); their BatchNorm running statistics,
backbone and head, equal the port's own one-process run (rtol 1e-5,
atol 1e-6); the flips are the one-process step's; the sharded eval's
word-level scores equal one process's float for float and its
teacher-forced loss within rtol 1e-5 (the JAX sharded eval's bars,
tests/test_eval_sharded.py); the sharded loader's rows concatenate to the
JAX loader's batches.  Then ``cli.main --dp 2`` trains the mini-COCO
fixture for an epoch in two spawned processes, rank 0 alone writing.
"""

import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from fixtures import build_mini_coco, mini_params
from show_tell_tpu.data.dataset import DataLoader as JaxDataLoader
from show_tell_tpu.data.dataset import MSCOCO as JaxMSCOCO
from show_tell_tpu.train.optim import make_optimizer as jax_make_optimizer
from show_tell_tpu.train.train_step import make_train_step as jax_make_train_step
from show_tell_tpu.vocab.vocabulary import load_vocab as jax_load_vocab
from show_tell_tpu_torch.evaluation import tester
from show_tell_tpu_torch.models.captioner import CaptionerConfig, model_trees
from show_tell_tpu_torch.models.convert import trainable_from_jax
from show_tell_tpu_torch.parallel import multihost
from show_tell_tpu_torch.parallel.mesh import make_mesh
from show_tell_tpu_torch.train.train_step import create_train_state, make_train_step
from show_tell_tpu_torch.vocab import get_vocabulary
from torch_parallel_driver import EvalVocab, ListLoader
from torch_train_helpers import VARIANTS, jax_cfg, jax_init, jax_train_state, make_batch, np_tree
from torch_train_helpers import few_torch_threads  # noqa: F401 (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVER = os.path.join(REPO, "tests", "torch_parallel_driver.py")
LR = 0.05
DRIVER_TIMEOUT = 240  # seconds, the driver process (its ranks are ended 20 s sooner)
CLI_TIMEOUT = 300


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _eval_batches(seed=0, vocab=40):
    """The JAX sharded-eval test's batches: two of 8 and a tail of 3 (run whole on both ranks)."""
    rng = np.random.RandomState(seed)
    batches, n = [], 0
    for rows in (8, 8, 3):
        imgs = rng.randint(0, 255, (rows, 64, 64, 3), dtype=np.uint8)
        lengths = np.sort(rng.randint(4, 10, rows))[::-1].astype(np.int32).copy()
        caps = np.zeros((rows, 12), np.int32)
        for b in range(rows):
            caps[b, : lengths[b]] = rng.randint(4, vocab, lengths[b])
        batches.append((tuple("img_%d.jpg" % (n + i) for i in range(rows)), imgs, caps, lengths))
        n += rows
    return batches


def _checksum(trainable):
    return float(sum(np.abs(np.asarray(v, np.float64)).sum() for v in trainable.values()))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, both ranks' results, and the one-process references."""
    work = str(tmp_path_factory.mktemp("dp2"))
    build_mini_coco(os.path.join(work, "data"))
    params = mini_params(os.path.join(work, "data"), os.path.join(work, "out"), batch_size=4)
    get_vocabulary("MSCOCO", params)  # writes vocab.pkl
    train = {v: {"cfg": tuple(jax_cfg(v)), "init": jax_init(jax_cfg(v), seed=3)} for v in VARIANTS}
    ecfg = jax_cfg("gru")._replace(hidden_dim=32, max_caption_length=8)
    inputs = {
        "lr": LR,
        "train": train,
        "batches": [make_batch(20 + i) for i in range(3)],
        "eval": {"cfg": tuple(ecfg), "init": jax_init(ecfg, seed=4), "batches": _eval_batches()},
        "data": {"ann": params["ann_path_train"], "img_dir": params["data_path_train"], "vocab": params["vocab_path"]},
    }
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    os.makedirs(os.path.join(work, "eval"))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    try:
        result = subprocess.run([sys.executable, DRIVER, work, str(DRIVER_TIMEOUT - 20)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True, env=env, timeout=DRIVER_TIMEOUT)
    except subprocess.TimeoutExpired:
        pytest.fail("the dp=2 driver process timed out after %d s" % DRIVER_TIMEOUT)
    assert result.returncode == 0, result.stdout[-3000:]
    ranks = []
    for rank in (0, 1):
        with open(os.path.join(work, "rank%d.pkl" % rank), "rb") as f:
            ranks.append(pickle.load(f))
    return {"work": work, "inputs": inputs, "ranks": ranks, "params": params}


@pytest.mark.parametrize("variant", VARIANTS)
def test_ranks_agree_exactly(runs, variant):
    r0, r1 = (r["train"][variant] for r in runs["ranks"])
    assert r0["losses"] == r1["losses"]
    assert sorted(r0["trainable"]) == sorted(r1["trainable"])
    for k, v in r0["trainable"].items():
        np.testing.assert_array_equal(v, r1["trainable"][k], err_msg=k)
    assert runs["ranks"][0]["primary"] and not runs["ranks"][1]["primary"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_dp2_steps_equal_the_jax_single_process_steps(runs, variant):
    """Three steps of two ranks against the JAX package's one-process steps
    on the same weights and batches: the losses and the trainable checksum."""
    jcfg = jax_cfg(variant)
    tx = jax_make_optimizer("SGD", LR)
    init = runs["inputs"]["train"][variant]["init"]
    jts = jax_train_state(*init, tx)
    jstep = jax_make_train_step(jcfg, tx, augment=False)
    losses = []
    for batch in runs["inputs"]["batches"]:
        jts, loss = jstep(jts, *batch)
        losses.append(float(loss))
    got = runs["ranks"][0]["train"][variant]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5, atol=1e-6)
    want = trainable_from_jax(np_tree(jts.trainable))
    assert sorted(want) == sorted(got["trainable"])
    np.testing.assert_allclose(_checksum(got["trainable"]), _checksum(want), rtol=1e-5)


@pytest.mark.parametrize("variant", VARIANTS)
def test_batchnorm_statistics_equal_one_process(runs, variant):
    """The frozen backbone's and the head's running statistics after the
    steps: the mean and variance of the global batch, as one process takes them."""
    case = runs["inputs"]["train"][variant]
    cfg = CaptionerConfig(*case["cfg"])
    ts = create_train_state(cfg, "SGD", LR, device="cpu", init=case["init"])
    step = make_train_step(cfg, augment=False)
    for batch in runs["inputs"]["batches"]:
        step(ts, *batch)
    _, want = model_trees(ts.model)
    got = runs["ranks"][0]["train"][variant]["bn_state"]
    for part in ("resnet", "last_layer"):
        assert sorted(got[part]) == sorted(want[part])
        for k, v in want[part].items():
            np.testing.assert_allclose(got[part][k], v, rtol=1e-5, atol=1e-6, err_msg="%s %s" % (part, k))
    moved = [k for k, v in want["resnet"].items() if k.endswith("running_mean") and np.abs(v).max() > 0]
    assert moved  # the steps did move them


def test_flips_are_drawn_for_the_global_batch(runs):
    case = runs["inputs"]["train"]["gru"]
    cfg = CaptionerConfig(*case["cfg"])
    ts = create_train_state(cfg, "SGD", LR, device="cpu", init=case["init"])
    loss = float(make_train_step(cfg, augment=True)(ts, *runs["inputs"]["batches"][0]))
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["flips_loss"], loss, rtol=1e-5, atol=1e-6)


def test_sharded_eval_scores_equal_one_process(runs, tmp_path):
    ev = runs["inputs"]["eval"]
    cfg = CaptionerConfig(*ev["cfg"])
    ts = create_train_state(cfg, "SGD", LR, device="cpu", init=ev["init"])
    single = tester.test_model(ts, cfg, ListLoader(ev["batches"], 8), EvalVocab(cfg.vocab_size),
                        {"output_dir": str(tmp_path), "score_threads": 1}, seed=7)
    for r in runs["ranks"]:
        assert sorted(r["eval"]) == sorted(single)
        for k, v in single.items():
            if k == "test_loss":
                np.testing.assert_allclose(r["eval"][k], v, rtol=1e-5)
            else:
                assert r["eval"][k] == v, (k, r["eval"][k], v)
    # batch i scored on rank i % 2 (three batches), the pickles from rank 0 only, equal to one process's
    assert [r["eval_batches_scored"] for r in runs["ranks"]] == [2, 1]
    for name in ("Target_Words_Dict.pickle", "Candidate_Words_Dict.pickle"):
        with open(os.path.join(runs["work"], "eval", name), "rb") as f, open(str(tmp_path / name), "rb") as g:
            assert pickle.load(f) == pickle.load(g)


def test_process_sharded_loader_concatenates_to_the_jax_batches(runs):
    data = runs["inputs"]["data"]
    jds = JaxMSCOCO(data["ann"], data["img_dir"], jax_load_vocab(data["vocab"]), use_native_decode=False)
    want = list(JaxDataLoader(jds, batch_size=4, shuffle=True, drop_last=True, seed=1))
    got0, got1 = (r["loader"] for r in runs["ranks"])
    assert len(got0) == len(got1) == len(want) > 0
    for (p0, i0, c0, l0), (p1, i1, c1, l1), (wp, wi, wc, wl) in zip(got0, got1, want):
        assert p0 == p1 == tuple(wp)
        assert len(i0) == len(i1) == len(wi) // 2  # each rank decoded its half of the sorted rows
        np.testing.assert_array_equal(np.concatenate([i0, i1]), wi)
        for c, l in ((c0, l0), (c1, l1)):
            np.testing.assert_array_equal(c, wc)
            np.testing.assert_array_equal(l, wl)


def test_mesh_errors_and_sigterm_agreement(runs):
    for r in runs["ranks"]:
        assert "covers processes unevenly" in r["mesh_errors"]["uneven"]
        assert "needs 4 devices but only 2 are visible" in r["mesh_errors"]["oversized"]
        assert r["preempt_one"] is True and r["preempt_none"] is False
    with pytest.raises(ValueError, match="needs 2 devices but only 1 are visible"):
        make_mesh(2)  # one process here
    with pytest.raises(ValueError, match="mesh dp=1 x mp=2 needs 2 devices but only 1 are visible"):
        make_mesh(1, mp=2)


def test_one_rank_group_runs_ddp_and_equals_one_process(tmp_path):
    """A one-rank gloo group (the card's one-rank nccl run in chip_smoke.py,
    on the CPU): DDP and the synced BatchNorms over the single rank give one
    process's losses and statistics for three steps (the attention GRU), and
    the sharded eval one process's scores."""
    import torch.distributed as dist

    case = {"cfg": tuple(jax_cfg("attn")), "init": jax_init(jax_cfg("attn"), seed=5)}
    cfg = CaptionerConfig(*case["cfg"])
    batches = [make_batch(30 + i) for i in range(3)]
    ref = create_train_state(cfg, "SGD", LR, device="cpu", init=case["init"])
    step = make_train_step(cfg)  # flips on
    want = [float(step(ref, *b)) for b in batches]
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % _free_port(), world_size=1, rank=0)
    try:
        mesh = make_mesh(0)
        assert mesh.dp == 1 and mesh.group is not None
        ts = create_train_state(cfg, "SGD", LR, device="cpu", init=case["init"], mesh=mesh)
        assert isinstance(ts.forward, torch.nn.parallel.DistributedDataParallel) and ts.mesh is mesh
        got = [float(step(ts, *b)) for b in batches]
        ev = {"output_dir": str(tmp_path), "score_threads": 1, "eval_augment": 0}
        ecfg = CaptionerConfig(*tuple(jax_cfg("gru")._replace(max_caption_length=8)))
        ets = create_train_state(ecfg, "SGD", LR, device="cpu", init=jax_init(jax_cfg("gru"), seed=6))
        sharded = tester.test_model(ets, ecfg, ListLoader(_eval_batches(), 8), EvalVocab(40), ev)
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for (k, a), b in zip(model_trees(ts.model)[1]["resnet"].items(), model_trees(ref.model)[1]["resnet"].values()):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=k)
    single = tester.test_model(ets, ecfg, ListLoader(_eval_batches(), 8), EvalVocab(40), ev)
    for k, v in single.items():
        if k == "test_loss":
            np.testing.assert_allclose(sharded[k], v, rtol=1e-5)
        else:
            assert sharded[k] == v, (k, sharded[k], v)


def test_spawn_returns_each_ranks_result_and_ends_ranks_past_the_timeout():
    """parallel.multihost.spawn, the helper behind ``--dp N`` and every
    harness of ranks: each rank's return value in rank order, from a
    group of the given size; ranks that outlast the timeout are ended and
    the call raises."""
    import time

    from torch_parallel_driver import rank_and_world, sleep_then

    assert multihost.spawn(rank_and_world, 2, (), "cpu", timeout=120) == [(0, 2, "gloo"), (1, 2, "gloo")]
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError, match="did not finish within"):
        multihost.spawn(sleep_then, 2, (300,), "cpu", timeout=5)
    assert time.perf_counter() - t0 < 120
    assert multihost.process_count() == 1  # this process joined no group


def test_malformed_multihost_spec_raises():
    with pytest.raises(ValueError, match="coordinator_host:port,num_processes,process_id"):
        multihost.initialize("localhost:1234,2", "cpu")
    assert multihost.process_count() == 1 and multihost.is_primary()


def test_cli_dp2_trains_an_epoch_and_rank0_alone_writes(tmp_path):
    """``cli.main --dp 2 --device cpu``: two spawned processes train one
    epoch of the mini-COCO fixture (B=4: two rows a rank); model_1.ckpt is
    written once, by rank 0, and metrics.jsonl holds one process's records."""
    data_root, out = str(tmp_path / "data"), str(tmp_path / "out")
    build_mini_coco(data_root)
    argv = ["--data_dir", data_root, "--output_dir", out,
            "--train_ann_path", "annotations/captions_train2014.json", "--train_img_dir", "train2014",
            "--test_ann_path", "", "--vocab_threshold", "1", "--embedding_length", "16", "--num_hidden_units", "24",
            "--num_layers", "1", "--batch_size", "4", "--num_epochs", "1", "--resnet_version", "18", "--lr", "0.01",
            "--optimizer_type", "SGD", "--is_training", "1", "--is_testing", "0", "--device", "cpu", "--dp", "2"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    result = subprocess.run([sys.executable, "-m", "show_tell_tpu_torch.cli.main"] + argv, cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=CLI_TIMEOUT)
    assert result.returncode == 0, result.stdout[-3000:] + result.stderr[-3000:]
    log = result.stdout
    assert "Data-parallel run: spawning 2 processes." in log
    assert "process 0 (primary" in log and "process 1 (worker)" in log
    assert log.count("Checkpoint created for Epoch 1") == 1  # rank 0 alone
    assert sorted(f for f in os.listdir(out) if f.endswith(".ckpt")) == ["model_1.ckpt", "model_1_metrics.ckpt"]
    with open(os.path.join(out, "model_1_metrics.ckpt"), "rb") as f:
        losses = pickle.load(f)["train_loss"]
    assert len(losses) == 4 and np.isfinite(losses).all()  # 16 captions, B=4
    with open(os.path.join(out, "metrics.jsonl")) as f:
        events = [json.loads(line)["event"] for line in f]
    assert events == ["train_step", "epoch"]
