"""Serving over a dp x mp mesh: the port's ``Captioner(dp, mp)`` in gloo
ranks on the CPU against the JAX package's ``Captioner(dp, mp)`` on its
virtual devices (tests/conftest.py gives JAX eight).

A launcher process (tests/torch_mesh_ranks.py, with its own timeout)
spawns a group of two ranks, which serves at (dp, mp) = (2, 1) and then
(1, 2), and a group of four, which serves at (2, 2), while this process
takes the JAX package's ids.  The weights are the JAX package's seeded
trees (ResNet-18, E=16, H=24, L=2, 64 x 64 images): the pooled GRU at
V=40 and the attention LSTM at V=41, which mp=2 pads to 42.  Held here:
every rank's f32 ids, greedy and beam (K=3), bit-equal to the JAX
Captioner's on the same mesh; early exit with an <end>-biased bias (as
tests/test_serve.py pins the JAX package's) equal to the JAX
Captioner's early exit; each rank's share of the vocabulary-sized tensors
(V/mp rows of the torch projection, its bias and the embedding);
``vocab_argmax`` and ``vocab_topk`` on planted ties across the shard
boundary (the lower global index first); the logits and log-probabilities
gathered from the shards within 1e-5 of the unsharded ones; padded columns
that never win, f32 and bf16; the dp divisibility ValueError; and
``serve.main --dp 2 --batch_size 3`` captioning three files once each, in
input order, as one process does.
"""

import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from fixtures import build_mini_coco
from show_tell_tpu.models import captioner as jax_captioner
from show_tell_tpu.serve import Captioner as JaxCaptioner
from show_tell_tpu_torch import serve as port_serve
from show_tell_tpu_torch.ops.vocab import project_logits, stable_topk
from torch_mesh_ranks import EvalVocab
from torch_train_helpers import few_torch_threads  # noqa: F401 (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = os.path.join(REPO, "tests", "torch_mesh_ranks.py")
LAUNCH_TIMEOUT = 300  # seconds, the launcher process (each group of ranks is ended 30 s sooner)
MESHES = ((2, 1), (1, 2), (2, 2))
K = 3
CASES = {"gru": 40, "attn_lstm": 41}  # variant: V (41: mp=2 pads a column)


def _cfg(variant, V):
    return jax_captioner.CaptionerConfig(variant, 18, 16, 24, V, 2, nos_filters=512, attn_dim=16)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _end_biased(params, end=2, by=4.0):
    """The weights with the projection's <end> bias raised, so that rows retire early."""
    out = jax.tree.map(np.array, params)
    out["decoder"]["linear"]["b"][end] += by
    return out


def _write_checkpoint(root):
    """A JAX-format checkpoint and vocab.pkl of the pooled GRU (L=1) for the serve CLI."""
    import optax

    from show_tell_tpu.train.checkpoint import create_checkpoint
    from show_tell_tpu.train.train_step import TrainState
    from show_tell_tpu.vocab.vocabulary import DatasetVocabulary, save_vocab

    vocab = DatasetVocabulary()
    for w in ["<pad>", "<start>", "<end>", "<unk>"] + ["w%d" % i for i in range(13)]:
        vocab.add_new_word(w)
    cfg = jax_captioner.CaptionerConfig("gru", 18, 16, 24, len(vocab), 1)
    params, bn_state = jax_captioner.init_captioner(jax.random.PRNGKey(9), cfg)
    trainable, frozen = jax_captioner.split_trainable(params)
    state = TrainState(trainable, frozen, bn_state, optax.adam(1e-3).init(trainable), jax.random.PRNGKey(1),
                       np.int32(0))
    ckpt = create_checkpoint(state, 1, 0, [], {"output_dir": root})
    vocab_path = os.path.join(root, "vocab.pkl")
    save_vocab(vocab, vocab_path)
    return ckpt, vocab_path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results and this process's JAX references, taken while the ranks run."""
    work = str(tmp_path_factory.mktemp("mesh_serve"))
    rng = np.random.RandomState(0)
    cases = {}
    for i, (variant, V) in enumerate(CASES.items()):
        params, bn_state = _np(jax_captioner.init_captioner(jax.random.PRNGKey(20 + i), _cfg(variant, V)))
        cases[variant] = {"cfg": tuple(_cfg(variant, V)), "params": params, "bn_state": bn_state,
                          "end_params": _end_biased(params)}
    build_mini_coco(os.path.join(work, "data"))
    img_dir = os.path.join(work, "data", "train2014")
    files = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir) if f.endswith(".jpg"))[:3]
    ckpt, vocab_path = _write_checkpoint(work)
    cli_argv = ["--ckpt", ckpt, "--vocab", vocab_path, "--resnet_version", "18", "--embedding_length", "16",
                "--num_hidden_units", "24", "--num_layers", "1", "--compute_dtype", "float32", "--device", "cpu",
                "--batch_size", "3"] + files
    grid = np.arange(3 * 40, dtype=np.float32).reshape(3, 40) / 64.0
    grid[0, 19] = grid[0, 20] = 5.0  # a tie on either side of the shard boundary: 19 wins
    grid[1, 5] = grid[1, 35] = 5.0  # 5 wins
    grid[2, 33] = 5.0
    inputs = {
        "cases": cases, "tie_case": "gru", "pad_case": "attn_lstm", "beam_size": K,
        "images": rng.randint(0, 256, (4, 64, 64, 3), dtype=np.uint8),
        "argmax_rows": grid,
        "topk_cand": (rng.randint(0, 4, (2, 2, 40)) / 4.0).astype(np.float32),  # on a 1/4 grid: many ties
        "topk_k": 5,
        "top": rng.uniform(-1, 1, (3, 24)).astype(np.float32),
        "cli_argv": cli_argv + ["--dp", "2"],
    }
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    launcher = subprocess.Popen([sys.executable, RANKS, "serve", work, str(LAUNCH_TIMEOUT - 30)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        jax_ids = {}
        for name, case in cases.items():
            cfg = jax_captioner.CaptionerConfig(*case["cfg"])
            vocab = EvalVocab(cfg.vocab_size)
            for dp, mp in MESHES:
                cap = JaxCaptioner(case["params"], case["bn_state"], cfg, vocab, compute_dtype="float32", dp=dp, mp=mp)
                jax_ids[name, dp, mp] = (cap.caption_ids(inputs["images"]), cap.caption_ids(inputs["images"], K))
            early = JaxCaptioner(case["end_params"], case["bn_state"], cfg, vocab, compute_dtype="float32", dp=2,
                                 mp=2, early_exit=True)
            jax_ids[name, "early"] = (early.caption_ids(inputs["images"]), early.caption_ids(inputs["images"], K))
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
    return {"inputs": inputs, "results": results, "jax": jax_ids, "cli_argv": cli_argv, "files": files}


def _ranks(runs, dp, mp):
    return [r for r in runs["results"][dp * mp] if (dp, mp) in r["meshes"]]


@pytest.mark.parametrize("variant", list(CASES))
@pytest.mark.parametrize("dp,mp", MESHES)
def test_ids_equal_the_jax_captioner_on_the_same_mesh(runs, variant, dp, mp):
    want_greedy, want_beam = runs["jax"][variant, dp, mp]
    ranks = _ranks(runs, dp, mp)
    assert len(ranks) == dp * mp
    for r in ranks:
        got = r["meshes"][dp, mp][variant]
        assert got["greedy"].shape == (4, 25) and got["greedy"].dtype == np.int32
        np.testing.assert_array_equal(got["greedy"], np.asarray(want_greedy))
        np.testing.assert_array_equal(got["beam"], np.asarray(want_beam))


@pytest.mark.parametrize("variant", list(CASES))
@pytest.mark.parametrize("dp,mp", MESHES)
def test_early_exit_equals_the_jax_captioner(runs, variant, dp, mp):
    """An <end>-biased bias retires rows early; the ids (<pad> after <end>)
    equal the JAX Captioner's early exit on its (2, 2) mesh, which its own
    tests hold to the one-device decode."""
    want_greedy, want_beam = (np.asarray(x) for x in runs["jax"][variant, "early"])
    assert (want_greedy == 2).any(axis=1).all()  # every row does emit <end>
    for r in _ranks(runs, dp, mp):
        got = r["meshes"][dp, mp][variant]
        np.testing.assert_array_equal(got["early_greedy"], want_greedy)
        np.testing.assert_array_equal(got["early_beam"], want_beam)


@pytest.mark.parametrize("dp,mp", MESHES)
def test_each_rank_holds_its_share_of_the_vocabulary(runs, dp, mp):
    """V/mp rows of the torch projection (the JAX weight's columns), its bias
    and the embedding, V padded to a multiple of mp; shards in mp_rank order."""
    for variant, V in CASES.items():
        padded = -(-V // mp) * mp
        size = padded // mp
        los = set()
        for r in _ranks(runs, dp, mp):
            got = r["meshes"][dp, mp][variant]
            assert got["shapes"] == {"linear.weight": (size, 24), "linear.bias": (size,), "embeddings": (size, 16),
                                     "prepared.vocab": (size, 24)}, (variant, got["shapes"])
            if mp > 1:
                lo, s, p = got["shard"]
                assert (s, p) == (size, padded) and lo % size == 0
                los.add(lo)
        assert los == (set(range(0, padded, size)) if mp > 1 else set())


@pytest.mark.parametrize("dp,mp", [(1, 2), (2, 2)])
def test_vocab_collectives_on_planted_ties(runs, dp, mp):
    """vocab_argmax: of equal maxima in two shards the lower global index
    wins; vocab_topk: the stable top-k of the whole row (value descending,
    then global index), over many ties on a 1/4 grid."""
    inputs = runs["inputs"]
    want_tok = np.argmax(inputs["argmax_rows"], axis=1)
    assert list(want_tok) == [19, 5, 33]
    cand = torch.from_numpy(inputs["topk_cand"])
    want_vals, want_idx = stable_topk(cand.reshape(2, -1), inputs["topk_k"])
    for r in _ranks(runs, dp, mp):
        got = r["meshes"][dp, mp]["gru"]
        np.testing.assert_array_equal(got["argmax"], want_tok)
        np.testing.assert_array_equal(got["topk"][0], want_vals.numpy())
        np.testing.assert_array_equal(got["topk"][1], want_idx.numpy())


@pytest.mark.parametrize("dp,mp", [(1, 2), (2, 2)])
def test_sharded_logits_and_logp_equal_the_unsharded(runs, dp, mp):
    case = runs["inputs"]["cases"]["gru"]
    lin = case["params"]["decoder"]["linear"]
    vocab = {"w": torch.from_numpy(np.array(lin["w"].T)), "b": torch.from_numpy(np.array(lin["b"]))}
    logits = project_logits(vocab, torch.from_numpy(runs["inputs"]["top"]))
    logp = torch.log_softmax(logits, dim=-1)
    for r in _ranks(runs, dp, mp):
        got = r["meshes"][dp, mp]["gru"]
        np.testing.assert_allclose(got["logits"], logits.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["logp"], logp.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dp,mp", [(1, 2), (2, 2)])
def test_padded_columns_never_win(runs, dtype, dp, mp):
    """V=41 over mp=2: the rank holding column 41 keeps it with bias -1e9
    (finite in bf16), zero weights and a zero embedding row; no served id,
    greedy or beam, reaches it; against real logits of -1e8 the argmax and
    top-3 stay in the real columns and log_softmax stays finite."""
    V = CASES["attn_lstm"]
    pads = []
    for r in _ranks(runs, dp, mp):
        got = r["pad"][dp, mp][dtype]
        pads.append(len(got["pad_bias"]))
        assert np.isfinite(got["pad_bias"]).all() and (got["pad_bias"] <= -9.9e8).all()
        assert got["pad_weight_max"] == 0.0 and got["pad_embedding_max"] == 0.0
        for ids in (got["greedy"], got["beam"]):
            assert ids.shape == (4, 25) and ids.min() >= 0 and ids.max() < V
        assert (got["low_argmax"] < V).all() and (got["low_topk"] < V).all() and got["low_logp_finite"]
    assert sorted(set(pads)) == [0, 1]  # one pad column, on the last shard


def test_a_batch_that_does_not_divide_over_dp_raises(runs):
    for dp, mp in ((2, 1), (2, 2)):
        for r in _ranks(runs, dp, mp):
            assert "does not divide over dp=2" in r["dp_error"]


def test_serve_cli_dp2_captions_each_file_once_in_order(runs, capsys):
    """``serve.main --dp 2 --batch_size 3`` spawns two ranks; the batch is
    rounded up to 4 (the last file repeated), and rank 0's lines are
    printed: three files, once each, in input order, with one process's
    captions."""
    rc, printed = runs["results"]["cli"]
    assert rc == 0
    assert port_serve.main(runs["cli_argv"]) == 0
    want = capsys.readouterr().out.strip().splitlines()
    lines = printed.strip().splitlines()
    assert [line.partition("\t")[0] for line in lines] == runs["files"]
    assert lines == want


@pytest.mark.parametrize("variant", ["attn", "attn_lstm"])
def test_attention_vocab_sharded_flag_takes_the_stack_step_route(monkeypatch, variant):
    """The attention families read ``vocab_sharded`` (it was dropped): on
    one device it takes the route of a sharded projection, the context,
    the stack step T times and the projection outside any kernel, never the
    fused step or the projection + argmax kernel; its f32 ids equal the
    JAX package's greedy decode."""
    from show_tell_tpu_torch.models import captioner as port_captioner
    from show_tell_tpu_torch.ops import attention as port_attention
    from show_tell_tpu_torch.ops import fused_attn as port_fused_attn
    from show_tell_tpu_torch.ops import rnn as port_rnn
    from show_tell_tpu_torch.ops import vocab as port_vocab

    cfg = _cfg(variant, 40)
    params, bn_state = _np(jax_captioner.init_captioner(jax.random.PRNGKey(40), cfg))
    images = np.random.RandomState(4).randint(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    from show_tell_tpu.data.transforms import preprocess_images

    normalized = preprocess_images(images, jax.random.PRNGKey(0), augment=False, dtype=np.float32)
    want = np.asarray(jax_captioner.captioner_greedy_decode(jax.tree.map(jax.numpy.asarray, params), bn_state, cfg,
                                                            normalized, use_pallas=False))

    def barred(*args, **kwargs):
        raise AssertionError("a kernel of the unsharded route ran")

    calls = {"stack": 0, "context": 0}
    stack_name = "lstm_stack_step" if variant == "attn_lstm" else "gru_stack_step"
    stack, context = getattr(port_rnn, stack_name), port_attention.attention_context

    def counted_stack(*args):
        calls["stack"] += 1
        return stack(*args)

    def counted_context(*args):
        calls["context"] += 1
        return context(*args)

    monkeypatch.setattr(port_rnn, stack_name, counted_stack)
    monkeypatch.setattr(port_attention, "attention_context", counted_context)
    monkeypatch.setattr(port_vocab, "project_argmax", barred)
    monkeypatch.setattr(port_fused_attn, "attn_greedy_decode_fused", barred)
    model = port_captioner.build_model(params, bn_state, port_captioner.CaptionerConfig(*cfg), torch.float32,
                                       torch.device("cpu"))
    with torch.inference_mode():
        ids = port_captioner.captioner_greedy_decode(model, port_captioner.CaptionerConfig(*cfg),
                                                     torch.from_numpy(images), vocab_sharded=True)
    np.testing.assert_array_equal(ids.numpy(), want)
    assert calls == {"stack": 25, "context": 25}
