"""The PyTorch port imports no jax and nothing of the JAX package.

tests/conftest.py imports jax into every test process, so the import
checks run in a fresh interpreter."""

import os
import re
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "show_tell_tpu_torch")


def test_port_imports_without_jax():
    code = (
        "import show_tell_tpu_torch, show_tell_tpu_torch.serve, show_tell_tpu_torch.models.captioner, "
        "show_tell_tpu_torch.ops.fused_step, show_tell_tpu_torch.ops.build, show_tell_tpu_torch.models.attention, "
        "show_tell_tpu_torch.ops.attention, show_tell_tpu_torch.ops.fused_attn, show_tell_tpu_torch.ops.vocab, "
        "show_tell_tpu_torch.ops.fused_beam, show_tell_tpu_torch.decode.beam, show_tell_tpu_torch.vocab, "
        "show_tell_tpu_torch.data.images, show_tell_tpu_torch.data.serve_cache, show_tell_tpu_torch.ops.preprocess, "
        "show_tell_tpu_torch.ops.stem, show_tell_tpu_torch.ops.s2d_stem, show_tell_tpu_torch.ops.whole_decode, "
        "show_tell_tpu_torch.native.build, show_tell_tpu_torch.native.fastimage, show_tell_tpu_torch.train.optim, "
        "show_tell_tpu_torch.train.train_step, show_tell_tpu_torch.train.checkpoint, show_tell_tpu_torch.train.loop, "
        "show_tell_tpu_torch.data.coco, show_tell_tpu_torch.data.dataset, show_tell_tpu_torch.data.image_cache, "
        "show_tell_tpu_torch.data.device_prefetch, show_tell_tpu_torch.utils, show_tell_tpu_torch.utils.logging, "
        "show_tell_tpu_torch.utils.profiling, show_tell_tpu_torch.evaluation.metrics, "
        "show_tell_tpu_torch.evaluation.tester, show_tell_tpu_torch.native.fastmetrics, "
        "show_tell_tpu_torch.decode.faithful_beam, show_tell_tpu_torch.decode.generic, show_tell_tpu_torch.core.config, "
        "show_tell_tpu_torch.cli.run, show_tell_tpu_torch.cli.main, show_tell_tpu_torch.cli.main_lstm, "
        "show_tell_tpu_torch.cli.main_attn, show_tell_tpu_torch.cli.main_attn_lstm, show_tell_tpu_torch.models.serving, "
        "show_tell_tpu_torch.parallel, show_tell_tpu_torch.parallel.mesh, show_tell_tpu_torch.parallel.multihost; "
        "import sys; "
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if m.startswith('jax')); "
        "assert not any(m.split('.')[0] in ('optax', 'nltk', 'show_tell_tpu') for m in sys.modules), "
        "sorted(m for m in sys.modules if m.split('.')[0] in ('optax', 'nltk', 'show_tell_tpu'))"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                            timeout=120)
    assert result.returncode == 0, result.stderr


def test_port_trains_without_nltk(tmp_path):
    """With nltk unimportable (the GPU host's package list has none), the
    training modules import, a saved vocabulary loads without tokenizing,
    and tokenizing raises and says why; a dataset given its own
    ``tokenize`` builds batches."""
    import json

    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps({"images": [{"id": 1, "file_name": "x.jpg"}],
                               "annotations": [{"id": 5, "image_id": 1, "caption": "A red bus"}]}))
    code = textwrap.dedent("""
        import sys
        sys.modules["nltk"] = None  # import nltk raises ImportError
        import show_tell_tpu_torch.train.loop, show_tell_tpu_torch.data.dataset
        from show_tell_tpu_torch import vocab as V
        from show_tell_tpu_torch.data.dataset import MSCOCO
        assert V.tokenizer_name() is None
        try:
            V.word_tokenize("a red bus")
            raise SystemExit("word_tokenize ran without nltk")
        except ImportError as e:
            assert "nltk" in str(e), e
        v = V.DatasetVocabulary()
        for w in ["<pad>", "<start>", "<end>", "<unk>", "a", "red", "bus"]:
            v.add_new_word(w)
        V.save_vocab(v, %r)
        loaded = V.get_vocabulary("MSCOCO", {"vocab_path": %r})
        ds = MSCOCO(%r, %r, loaded, tokenize=str.split)
        assert ds.caption_ids(0) == [1, 4, 5, 6, 2], ds.caption_ids(0)
    """) % (str(tmp_path / "v.pkl"), str(tmp_path / "v.pkl"), str(ann), str(tmp_path))
    env = dict(os.environ, PYTHONPATH=REPO)
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                            timeout=120)
    assert result.returncode == 0, result.stderr


def test_port_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import (jax|optax)|from (jax|optax))\b", re.M)
    offenders = []
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    if pattern.search(fh.read()):
                        offenders.append(os.path.join(root, f))
    assert not offenders
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        smoke = fh.read()
    assert not pattern.search(smoke)
    assert "show_tell_tpu." not in smoke  # nothing of the JAX package either


def test_serving_from_a_checkpoint_imports_nothing_of_the_jax_package(tmp_path):
    """A checkpoint and vocab.pkl written by the JAX package, then
    ``Captioner.from_checkpoint``, ``caption_files`` (greedy and beam), the
    s2d Captioner through ``caption_paths`` with an image cache, and the
    CLI (stock, with --s2d 1 --image_cache, and with --fast_jpeg 1, the
    native decoder's scaled decode) in a fresh interpreter: no
    ``jax`` and no ``show_tell_tpu`` module gets imported on the way."""
    import jax
    import numpy as np
    import optax

    from fixtures import build_mini_coco
    from show_tell_tpu.models import captioner as jax_captioner
    from show_tell_tpu.train.checkpoint import create_checkpoint
    from show_tell_tpu.train.train_step import TrainState
    from show_tell_tpu.vocab.vocabulary import DatasetVocabulary, save_vocab

    vocab = DatasetVocabulary()
    for w in ["<pad>", "<start>", "<end>", "<unk>", "a", "dog", "on", "the", "bus"]:
        vocab.add_new_word(w)
    cfg = jax_captioner.CaptionerConfig("gru", 18, 16, 24, len(vocab), 1)
    params, bn_state = jax_captioner.init_captioner(jax.random.PRNGKey(0), cfg)
    trainable, frozen = jax_captioner.split_trainable(params)
    state = TrainState(trainable, frozen, bn_state, optax.adam(1e-3).init(trainable), jax.random.PRNGKey(1),
                       np.int32(0))
    ckpt = create_checkpoint(state, 1, 0, [], {"output_dir": str(tmp_path)})
    vocab_path = str(tmp_path / "vocab.pkl")
    save_vocab(vocab, vocab_path)
    build_mini_coco(str(tmp_path / "data"))
    img_dir = str(tmp_path / "data" / "train2014")
    code = textwrap.dedent("""
        import os, sys
        from show_tell_tpu_torch import serve
        kw = dict(resnet_version=18, embed_dim=16, hidden_dim=24, num_layers=1, compute_dtype="float32")
        cap = serve.Captioner.from_checkpoint(%r, %r, device="cpu", **kw)
        paths = sorted(os.path.join(%r, f) for f in os.listdir(%r))[:2]
        assert len(cap.caption_files(paths)) == len(cap.caption_files(paths, beam_size=2)) == 2
        cli = ["--ckpt", %r, "--vocab", %r, "--resnet_version", "18", "--embedding_length", "16",
               "--num_hidden_units", "24", "--num_layers", "1", "--compute_dtype", "float32", "--device", "cpu"]
        assert serve.main(cli + ["--beam_size", "2", paths[0]]) == 0
        s2d = serve.Captioner.from_checkpoint(%r, %r, device="cpu", s2d=True, **kw)
        cache = serve.ServeImageCache(os.path.join(%r, "cache"), 224)
        assert len(list(serve.caption_paths(s2d, paths, 2, cache=cache))) == 2 and cache.misses == 2
        assert serve.main(cli + ["--s2d", "1", "--image_cache", os.path.join(%r, "cache"), paths[1]]) == 0
        assert serve.main(cli + ["--fast_jpeg", "1", paths[0]]) == 0
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "show_tell_tpu"))
        assert not leaked, leaked
    """) % (ckpt, vocab_path, img_dir, img_dir, ckpt, vocab_path, ckpt, vocab_path, str(tmp_path), str(tmp_path))
    env = dict(os.environ, PYTHONPATH=REPO)
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                            timeout=300)
    assert result.returncode == 0, result.stderr
    assert result.stdout.count("\t") == 3  # each CLI run's one path<TAB>caption line
    assert "1 hits, 0 misses" in result.stderr  # the s2d CLI run found its image in the cache


def _small_gru_checkpoint(tmp_path):
    """(data_root, out_dir): the mini-COCO fixture, and a port checkpoint and vocab.pkl of a small pooled GRU
    (the CLI flags of tests/torch_eval_helpers.cli_argv)."""
    import torch

    from fixtures import build_mini_coco
    from show_tell_tpu_torch.models.captioner import CaptionerConfig
    from show_tell_tpu_torch.train.checkpoint import create_checkpoint
    from show_tell_tpu_torch.train.train_step import create_train_state
    from show_tell_tpu_torch.vocab import get_vocabulary

    data_root, out = str(tmp_path / "data"), str(tmp_path / "out")
    build_mini_coco(data_root)
    os.makedirs(out)
    params = {"vocab_path": os.path.join(out, "vocab.pkl"), "data_dir": data_root, "vocab_threshold": 1,
              "train_ann_path": "annotations/captions_train2014.json", "output_dir": out}
    vocab = get_vocabulary("MSCOCO", params)  # builds and saves vocab.pkl (nltk here)
    ts = create_train_state(CaptionerConfig("gru", 18, 16, 24, len(vocab), 1), "Adam", 0.01, device="cpu")
    with torch.no_grad():
        create_checkpoint(ts, 1, 0, [], params)
    return data_root, out


def test_test_model_imports_neither_nltk_nor_the_jax_package(tmp_path):
    """test_model from a port checkpoint, with nltk unimportable (the GPU
    host has none) and the loader's captions split by str.split: no jax,
    optax, nltk or show_tell_tpu module is imported."""
    data_root, out = _small_gru_checkpoint(tmp_path)
    code = textwrap.dedent("""
        import os, sys
        sys.modules["nltk"] = None  # import nltk raises ImportError
        import torch
        torch.set_num_threads(2)  # the suite's other workers share the cores
        from show_tell_tpu_torch.data.dataset import MSCOCO, DataLoader
        from show_tell_tpu_torch.evaluation.tester import test_model
        from show_tell_tpu_torch.models.captioner import CaptionerConfig
        from show_tell_tpu_torch.train.checkpoint import read_checkpoint, restore_train_state
        from show_tell_tpu_torch.train.train_step import create_train_state
        from show_tell_tpu_torch.vocab import load_vocab
        data, out = %r, %r
        vocab = load_vocab(os.path.join(out, "vocab.pkl"))
        ds = MSCOCO(os.path.join(data, "annotations/captions_train2014.json"), os.path.join(data, "train2014"), vocab,
                    tokenize=str.split)
        cfg = CaptionerConfig("gru", 18, 16, 24, len(vocab), 1)
        ts = restore_train_state(create_train_state(cfg, "Adam", 0.01, device="cpu"),
                                 read_checkpoint(os.path.join(out, "model_1.ckpt")))
        scores = test_model(ts, cfg, DataLoader(ds, 4), vocab, {"output_dir": out}, beam_size=2)
        assert len(scores) == 11, scores
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "optax", "show_tell_tpu"))
        assert not leaked and sys.modules["nltk"] is None, leaked
    """) % (data_root, out)
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                            capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr
    assert "Testing completed." in result.stdout


def test_cli_test_phase_imports_nothing_of_the_jax_package(tmp_path):
    """The GRU CLI's test phase on the CPU from a saved vocabulary and a
    port checkpoint: no jax, optax or show_tell_tpu module is imported (the
    CLI's loader tokenizes the test captions with nltk, the reference's
    tokenizer)."""
    data_root, out = _small_gru_checkpoint(tmp_path)
    code = textwrap.dedent("""
        import sys
        sys.path.insert(0, "tests")
        import torch
        torch.set_num_threads(2)  # the suite's other workers share the cores
        from torch_eval_helpers import cli_argv
        from show_tell_tpu_torch.cli.run import run
        res = run("gru", cli_argv(%r, %r, ["--is_training", "0", "--is_testing", "1", "--load_model_test", "model_1",
                                            "--device", "cpu"]))
        assert len(res["scores"]) == 11, res["scores"]
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "optax", "show_tell_tpu"))
        assert not leaked, leaked
    """) % (data_root, out)
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                            capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr
    assert "Loading vocabulary from the existing file." in result.stdout
