"""The eval over a dp x mp mesh: the port's ``test_model`` with ``--mp 2``
(the vocabulary sharded over the mp axis, train_step.shard_train_state) in
gloo ranks on the CPU against the JAX package's ``test_model`` on the same
mesh of its virtual devices.

A launcher process (tests/torch_mesh_ranks.py, with its own timeout)
spawns a group of two ranks, which evaluates at (dp, mp) = (1, 2), and a
group of four, at (2, 2), while this process runs the JAX package's
sharded eval on the same weights (its seeded trees, ResNet-18, E=16, H=24,
L=2, V=40) and batches (two of 8 and a tail of 3, no flips): the pooled GRU
greedy and beam (K=2), the attention GRU greedy.  Held here by the JAX
sharded eval's bars (tests/test_eval_sharded.py:109-118): on every rank the
word-level scores exactly equal, test_loss within 1e-5 relative; and an
mp that does not divide the vocabulary raises, with the JAX message.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from show_tell_tpu.evaluation.tester import test_model as jax_test_model
from show_tell_tpu.train.optim import make_optimizer as jax_make_optimizer
from show_tell_tpu_torch.evaluation.tester import check_eval_params, eval_mesh
from torch_mesh_ranks import EvalVocab, ListLoader
from torch_train_helpers import jax_cfg, jax_init, jax_train_state
from torch_train_helpers import few_torch_threads  # noqa: F401 (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = os.path.join(REPO, "tests", "torch_mesh_ranks.py")
LAUNCH_TIMEOUT = 300  # seconds, the launcher process (each group of ranks is ended 30 s sooner)
MESHES = ((1, 2), (2, 2))
CASES = {"gru": (0, 2), "attn": (0,)}  # variant: the beam sizes it is evaluated with (0: greedy)


def _batches(seed=0, vocab=40):
    """Two batches of 8 and a tail of 3 (run whole on every rank), captions of words 4 .. vocab - 1."""
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results and the JAX package's sharded scores, taken while the ranks run."""
    work = str(tmp_path_factory.mktemp("mesh_eval"))
    cases = {}
    for i, (variant, beams) in enumerate(CASES.items()):
        cfg = jax_cfg(variant, max_caption_length=10)
        cases[variant] = {"cfg": tuple(cfg), "init": jax_init(cfg, seed=30 + i), "beam_sizes": beams}
    inputs = {"cases": cases, "batches": _batches()}
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    launcher = subprocess.Popen([sys.executable, RANKS, "eval", work, str(LAUNCH_TIMEOUT - 30)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        want = {}
        for dp, mp in MESHES:
            for name, case in cases.items():
                from show_tell_tpu.models.captioner import CaptionerConfig as JaxConfig

                cfg = JaxConfig(*case["cfg"])
                for beam_size in case["beam_sizes"]:
                    out_dir = os.path.join(work, "jax_%s_%d_%d_k%d" % (name, dp, mp, beam_size))
                    os.makedirs(out_dir)
                    ts = jax_train_state(*case["init"], jax_make_optimizer("SGD", 0.05))
                    want[dp, mp, name, beam_size] = jax_test_model(
                        ts, cfg, ListLoader(inputs["batches"], 8), EvalVocab(cfg.vocab_size),
                        {"output_dir": out_dir, "dp": dp, "mp": mp, "eval_augment": 0, "score_threads": 1},
                        beam_size=beam_size, seed=7)
        out, _ = launcher.communicate(timeout=LAUNCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        launcher.kill()
        pytest.fail("the mesh launcher process timed out after %d s" % LAUNCH_TIMEOUT)
    finally:
        if launcher.poll() is None:
            launcher.kill()
    assert launcher.returncode == 0, out[-3000:]
    with open(os.path.join(work, "results.pkl"), "rb") as f:
        results = pickle.load(f)
    return {"results": results, "jax": want}


@pytest.mark.parametrize("case", [(name, k) for name, beams in CASES.items() for k in beams])
@pytest.mark.parametrize("dp,mp", MESHES)
def test_sharded_eval_scores_equal_the_jax_sharded_eval(runs, case, dp, mp):
    name, beam_size = case
    want = runs["jax"][dp, mp, name, beam_size]
    ranks = runs["results"][dp * mp]
    assert len(ranks) == dp * mp
    for r in ranks:
        got = r["meshes"][dp, mp][name, beam_size]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            if k == "test_loss":
                np.testing.assert_allclose(got[k], v, rtol=1e-5)
            else:
                assert got[k] == v, (k, got[k], v)
    assert want["Bleu_1"] > 0  # the captions share words with the targets: the scores carry signal


def test_mp_that_does_not_divide_the_vocabulary_raises():
    """The JAX package's rule (show_tell_tpu/evaluation/tester.py:265-270),
    before any mesh forms; --mp itself no longer raises."""
    check_eval_params({"mp": 2})
    with pytest.raises(ValueError, match="--mp 2 does not divide vocab_size 41"):
        eval_mesh({"mp": 2}, ListLoader([], 8), None, 41)
    with pytest.raises(ValueError, match="needs 2 devices but only 1 are visible"):
        eval_mesh({"mp": 2}, ListLoader([], 8), None, 40)
