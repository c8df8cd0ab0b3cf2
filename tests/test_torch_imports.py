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
        "import sys; import show_tell_tpu_torch, show_tell_tpu_torch.serve, show_tell_tpu_torch.models.captioner, "
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
        "show_tell_tpu_torch.parallel, show_tell_tpu_torch.parallel.mesh, show_tell_tpu_torch.parallel.multihost, "
        "show_tell_tpu_torch.treebank; "
        "sys.path.insert(0, 'tools'); import demo_synthetic_torch, bf16_convergence_torch; "
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if m.startswith('jax')); "
        "assert not any(m.split('.')[0] in ('optax', 'nltk', 'show_tell_tpu', 'demo_synthetic', 'bf16_convergence') "
        "for m in sys.modules), sorted(m for m in sys.modules if m.split('.')[0] in ('optax', 'nltk', 'show_tell_tpu', "
        "'demo_synthetic', 'bf16_convergence'))"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                            timeout=120)
    assert result.returncode == 0, result.stderr


def test_port_trains_without_nltk(tmp_path):
    """With nltk unimportable (the GPU host's package list has none), the
    training modules import, ``get_vocabulary`` builds a vocabulary from the
    mini-COCO annotations (captions with capitals and final periods) with
    the port's copy of nltk's Treebank tokenizer, word for word and id for
    id the JAX package's built with nltk in this process, and the dataset
    tokenizes its captions the same way."""
    import json

    from fixtures import build_mini_coco
    from show_tell_tpu.vocab.tokenize import word_tokenize as jax_word_tokenize
    from show_tell_tpu.vocab.vocabulary import get_vocabulary as jax_get_vocabulary

    data = str(tmp_path / "data")
    build_mini_coco(data)
    params = {"data_dir": data, "train_ann_path": "annotations/captions_train2014.json", "vocab_threshold": 1}
    want = jax_get_vocabulary("MSCOCO", dict(params, vocab_path=str(tmp_path / "jax_vocab.pkl")))
    assert "." in want.word_to_index and "surfboard" in want.word_to_index
    first = json.load(open(os.path.join(data, params["train_ann_path"])))["annotations"][0]
    want_ids = [want("<start>")] + [want(t) for t in jax_word_tokenize(first["caption"].lower())] + [want("<end>")]
    code = textwrap.dedent("""
        import json, sys
        sys.modules["nltk"] = None  # import nltk raises ImportError
        import show_tell_tpu_torch.train.loop, show_tell_tpu_torch.data.dataset
        from show_tell_tpu_torch import vocab as V
        from show_tell_tpu_torch.data.dataset import MSCOCO
        assert V.tokenizer_name().endswith("(nltk is not installed)"), V.tokenizer_name()
        v = V.get_vocabulary("MSCOCO", dict(%r, vocab_path=%r))
        ds = MSCOCO(%r, %r, v)
        print(json.dumps({"words": v.word_to_index, "ids": ds.caption_ids(0)}))
        assert sys.modules["nltk"] is None
    """) % (params, str(tmp_path / "port_vocab.pkl"), os.path.join(data, params["train_ann_path"]),
            os.path.join(data, "train2014"))
    env = dict(os.environ, PYTHONPATH=REPO)
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                            timeout=120)
    assert result.returncode == 0, result.stderr
    got = json.loads(result.stdout.strip().splitlines()[-1])
    assert got["words"] == want.word_to_index
    assert list(got["words"]) == list(want.word_to_index)  # the same first-occurrence order, so the same ids
    assert got["ids"] == want_ids


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
    jax_tools = re.compile(r"^\s*(import|from) (demo_synthetic|bf16_convergence|prefill_cache|sweep|"
                           r"reproduce_reference)\b(?!_torch)", re.M)
    for name in ("chip_smoke.py", "tools/demo_synthetic_torch.py", "tools/bf16_convergence_torch.py",
                 "tools/prefill_cache_torch.py", "tools/sweep_torch.py", "tools/reproduce_reference_torch.py"):
        with open(os.path.join(REPO, name)) as fh:
            text = fh.read()
        assert not pattern.search(text), name
        assert "show_tell_tpu." not in text and "show_tell_tpu " not in text, name  # nothing of the JAX package
        assert not jax_tools.search(text), name  # nor the JAX package's tools


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
    host has none), so that the loader's captions go through the port's copy
    of the Treebank tokenizer: no jax, optax, nltk or show_tell_tpu module is
    imported."""
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
        ds = MSCOCO(os.path.join(data, "annotations/captions_train2014.json"), os.path.join(data, "train2014"), vocab)
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
    CLI's loader tokenizes the test captions with the port's
    ``word_tokenize``)."""
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


def test_coco_tools_import_neither_nltk_nor_the_jax_package(tmp_path):
    """tools/prefill_cache_torch.py, tools/sweep_torch.py and
    tools/reproduce_reference_torch.py in a fresh interpreter with nltk
    unimportable (the GPU host has none): the cache prefilled from the
    mini-COCO fixture, a one-run sweep that trains an epoch and tests
    through the port's CLI on that cache, and a dry run of a published row;
    no jax, optax, nltk or show_tell_tpu module is imported."""
    from fixtures import build_mini_coco
    from torch_eval_helpers import cli_argv

    data_root = str(tmp_path / "data")
    build_mini_coco(data_root)
    cache = str(tmp_path / "cache")
    argv = cli_argv(data_root, str(tmp_path / "unused"), ["--is_training", "1", "--is_testing", "1",
                                                          "--load_model_test", "model_1", "--image_cache", cache,
                                                          "--device", "cpu"])
    code = textwrap.dedent("""
        import json, os, sys
        sys.modules["nltk"] = None  # import nltk raises ImportError
        import torch
        torch.set_num_threads(2)  # the suite's other workers share the cores
        sys.path.insert(0, "tools")
        import prefill_cache_torch, reproduce_reference_torch, sweep_torch
        ann = os.path.join(%r, "annotations", "captions_train2014.json")
        for split in ("train", "test"):
            assert prefill_cache_torch.main(["--ann_path", ann, "--img_dir", os.path.join(%r, "train2014"),
                                             "--image_cache", os.path.join(%r, split)]) == 0
        out = %r
        assert sweep_torch.main(["--sweep_output", out, "--lrs", "0.01", "--embeds", "16",
                                 "--optimizers", "Adam"] + %r) == 0
        runs = json.load(open(os.path.join(out, "sweep_summary.json")))
        assert [r["run"] for r in runs] == ["GRU_COCO_lr_0_01_Embed16_Adam"] and "Bleu_1" in runs[0]["scores"]
        assert reproduce_reference_torch.main(["--row", "lstm_512_lr0001_adam"]) == 0
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "optax", "show_tell_tpu",
                                                                      "prefill_cache", "sweep",
                                                                      "reproduce_reference"))
        assert not leaked and sys.modules["nltk"] is None, leaked
    """) % (data_root, data_root, cache, str(tmp_path / "sweep"), argv)
    env = dict(os.environ, PYTHONPATH=REPO)
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                            timeout=300)
    assert result.returncode == 0, result.stderr[-3000:]
    assert "python -m show_tell_tpu_torch.cli.main_lstm" in result.stdout
    assert "8 images, 0 to decode" not in result.stdout and result.stdout.count("8 images, 8 to decode") == 2
