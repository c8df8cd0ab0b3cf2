"""The eval's ``--use_pallas 0`` route, the library route, against the JAX
package's ``use_pallas=0`` (its XLA decode), on the CPU, f32, eval_augment 0.

  * One process: the port's test_model against the JAX package's on a
    checkpoint of each family that the JAX package's CLI trained for one
    epoch on the mini-COCO fixture, greedy and beam K=3, and early exit on
    a pooled and an attention family of each cell; every score equal,
    test_loss within 1e-5 relative, both pickles and the printed lines
    equal but for the time.
  * No kernel: with ``uses_kernel`` patched to raise in the ops package and
    in every ops module that holds it, a ``--use_pallas 0`` eval of each
    family still runs, greedy and beam, so the route reaches neither a
    kernel nor its twin; the default route raises under the same patch.
  * ``--mp 2``: two gloo ranks (tests/torch_mesh_ranks.py) evaluate the
    JAX package's seeded weights by the library route with the vocabulary
    sharded, against the JAX package's sharded ``use_pallas=0`` eval on
    two of its virtual devices, by the bars of tests/test_torch_mesh_eval.py.
"""

import importlib
import os
import pickle
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

from torch_eval_helpers import ATTN_FLAGS, assert_same_eval, jax_trained, port_and_jax, port_test_model  # noqa: F401
from torch_train_helpers import few_torch_threads  # noqa: F401 (an autouse fixture)

VARIANTS = ("gru", "lstm", "attn", "attn_lstm")
TEST = ["--is_training", "0", "--is_testing", "1", "--load_model_test", "model_1", "--eval_augment", "0"]
LIBRARY = ["--use_pallas", "0"]
MODES = {"greedy": [], "beam": ["--beam_size", "3"], "greedy-early_exit": ["--early_exit", "1"],
         "beam-early_exit": ["--beam_size", "3", "--early_exit", "1"]}
CASES = [(v, m) for v in VARIANTS for m in ("greedy", "beam")] + [
    ("gru", "greedy-early_exit"), ("lstm", "beam-early_exit"), ("attn", "beam-early_exit"),
    ("attn_lstm", "greedy-early_exit")]


def _argv(variant, mode, route=LIBRARY):
    return TEST + route + MODES[mode] + (ATTN_FLAGS if variant.startswith("attn") else [])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return {v: jax_trained(tmp_path_factory, v) for v in VARIANTS}


@pytest.mark.parametrize("variant,mode", CASES, ids=["%s-%s" % c for c in CASES])
def test_library_route_equals_the_jax_xla_route(trained, port_and_jax, variant, mode):
    port, jax_run = port_and_jax(variant, *trained[variant], _argv(variant, mode))
    assert_same_eval(port, jax_run)
    if mode == "greedy":
        assert port[0]["Bleu_1"] > 0  # the captions score: the comparison is not of zeros


@pytest.fixture
def no_kernel(monkeypatch):
    """``uses_kernel`` raising wherever the port's ops look it up."""
    import show_tell_tpu_torch.ops as ops

    def refuse(t):
        raise AssertionError("the library route asked uses_kernel about a %s tensor" % (tuple(t.shape),))

    monkeypatch.setattr(ops, "uses_kernel", refuse)
    patched = []
    for info in pkgutil.iter_modules(ops.__path__):
        module = importlib.import_module("show_tell_tpu_torch.ops." + info.name)
        if hasattr(module, "uses_kernel"):
            monkeypatch.setattr(module, "uses_kernel", refuse)
            patched.append(info.name)
    return patched


@pytest.mark.parametrize("variant", VARIANTS)
def test_library_route_reaches_no_kernel_and_no_twin(trained, no_kernel, capsys, variant):
    assert {"rnn", "fused_step", "fused_attn", "fused_beam", "attention", "vocab"} <= set(no_kernel)
    for mode in ("greedy", "beam"):
        scores = port_test_model(variant, *trained[variant], _argv(variant, mode), capsys)[0]
        assert np.isfinite(scores["test_loss"])
    with pytest.raises(AssertionError, match="asked uses_kernel"):  # the control: the kernel route asks
        port_test_model(variant, *trained[variant], _argv(variant, "greedy", route=[]), capsys)


# --mp 2 over two gloo ranks against the JAX package's sharded XLA eval
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = os.path.join(REPO, "tests", "torch_mesh_ranks.py")
LAUNCH_TIMEOUT = 240  # seconds, the launcher process (the group of ranks is ended 30 s sooner)
MESH_CASES = {"gru": (0, 3), "attn_lstm": (0, 3)}  # variant: the beam sizes it is evaluated with (0: greedy)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The two ranks' results at (dp, mp) = (1, 2) and the JAX package's sharded scores, taken while the ranks run."""
    from show_tell_tpu.evaluation.tester import test_model as jax_test_model
    from show_tell_tpu.models.captioner import CaptionerConfig as JaxConfig
    from show_tell_tpu.train.optim import make_optimizer as jax_make_optimizer
    from test_torch_mesh_eval import _batches
    from torch_mesh_ranks import EvalVocab, ListLoader
    from torch_train_helpers import jax_cfg, jax_init, jax_train_state

    work = str(tmp_path_factory.mktemp("mesh_library"))
    cases = {}
    for i, (variant, beams) in enumerate(MESH_CASES.items()):
        cfg = jax_cfg(variant, max_caption_length=10)
        cases[variant] = {"cfg": tuple(cfg), "init": jax_init(cfg, seed=40 + i), "beam_sizes": beams}
    inputs = {"cases": cases, "batches": _batches(seed=1), "use_pallas": 0}
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    launcher = subprocess.Popen([sys.executable, RANKS, "eval", work, str(LAUNCH_TIMEOUT - 30), "2"],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        want = {}
        for name, case in cases.items():
            cfg = JaxConfig(*case["cfg"])
            for beam_size in case["beam_sizes"]:
                out_dir = os.path.join(work, "jax_%s_k%d" % (name, beam_size))
                os.makedirs(out_dir)
                ts = jax_train_state(*case["init"], jax_make_optimizer("SGD", 0.05))
                want[name, beam_size] = jax_test_model(
                    ts, cfg, ListLoader(inputs["batches"], 8), EvalVocab(cfg.vocab_size),
                    {"output_dir": out_dir, "dp": 1, "mp": 2, "eval_augment": 0, "score_threads": 1,
                     "use_pallas": 0}, beam_size=beam_size, seed=7)
        out, _ = launcher.communicate(timeout=LAUNCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        launcher.kill()
        pytest.fail("the mesh launcher process timed out after %d s" % LAUNCH_TIMEOUT)
    finally:
        if launcher.poll() is None:
            launcher.kill()
    assert launcher.returncode == 0, out[-3000:]
    with open(os.path.join(work, "results.pkl"), "rb") as f:
        return {"ranks": pickle.load(f)[2], "jax": want}


@pytest.mark.parametrize("case", [(n, k) for n, beams in MESH_CASES.items() for k in beams],
                         ids=["%s-k%d" % (n, k) for n, beams in MESH_CASES.items() for k in beams])
def test_mp2_library_route_equals_the_jax_sharded_xla_eval(mesh_runs, case):
    want = mesh_runs["jax"][case]
    assert len(mesh_runs["ranks"]) == 2
    for r in mesh_runs["ranks"]:
        got = r["meshes"][1, 2][case]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            if k == "test_loss":
                np.testing.assert_allclose(got[k], v, rtol=1e-5)
            else:
                assert got[k] == v, (k, got[k], v)
    assert want["Bleu_1"] > 0  # the captions share words with the targets: the scores carry signal
