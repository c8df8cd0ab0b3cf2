"""The port's learning demonstration on the CPU (tools/demo_synthetic_torch.py
and tools/bf16_convergence_torch.py): its build_dataset writes the JAX
package's tool's files byte for byte, its unseen images are that tool's, and
the tools run end to end through the port's CLI with nltk unimportable (the
GPU host has none), importing nothing of the JAX package."""

import json
import os
import random
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from torch_train_helpers import few_torch_threads  # noqa: F401 (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import demo_synthetic as jax_demo  # noqa: E402
import demo_synthetic_torch as demo  # noqa: E402

NO_NLTK = textwrap.dedent("""
    import runpy, sys
    sys.modules["nltk"] = None  # import nltk raises ImportError
    import torch
    torch.set_num_threads(2)  # the suite's other workers share the cores
    sys.argv = [%r] + %r
    runpy.run_path(sys.argv[0], run_name="__main__")
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "optax", "show_tell_tpu",
                                                                  "demo_synthetic"))
    assert not leaked and sys.modules["nltk"] is None, leaked
""")


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


@pytest.mark.parametrize("compositional, seed", [(False, 0), (False, 7), (True, 0)])
def test_build_dataset_writes_the_jax_tools_files(tmp_path, compositional, seed):
    demo.build_dataset(str(tmp_path / "port"), 12, seed=seed, compositional=compositional)
    jax_demo.build_dataset(str(tmp_path / "jax"), 12, seed=seed, compositional=compositional)
    port, jax = _files(str(tmp_path / "port")), _files(str(tmp_path / "jax"))
    assert sorted(port) == sorted(jax) and len(port) == 13
    for name in jax:
        assert port[name] == jax[name], name
    anns = json.loads(port[os.path.join("annotations", "captions_train2014.json")])
    assert len(anns["images"]) == 12 and len(anns["annotations"]) == 24


def test_probe_images_are_the_jax_tools_unseen_images():
    imgs, truths = demo.probe_images(16)
    rng = random.Random(999)
    for i in range(16):
        img, color, shape, _ = jax_demo.draw_sample(rng)
        assert np.array_equal(imgs[i], np.asarray(img, dtype=np.uint8)) and truths[i] == (color, shape)
    assert demo.attribute_hits(truths[:2], ["a %s %s here" % truths[0], "a dog"]) == (1, 1)


@pytest.mark.parametrize("variant_args", [[], ["--variant", "attn", "--next_token"]], ids=["gru", "attn_next_token"])
def test_demo_trains_tests_and_probes_without_nltk(tmp_path, variant_args):
    """The tool end to end on the CPU with nltk hidden: the CLI builds the vocabulary (the copied Treebank
    tokenizer), trains an epoch, tests, and the probe captions 16 unseen images."""
    out = str(tmp_path / "result.json")
    argv = ["--images", "48", "--epochs", "1", "--device", "cpu", "--root", str(tmp_path / "demo"),
            "--out", out] + variant_args
    code = NO_NLTK % (os.path.join(REPO, "tools", "demo_synthetic_torch.py"), argv)
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                            capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr[-3000:]
    assert "tokenizer: the port's copy of nltk's Treebank words over a rule-based sentence split (nltk is not " \
           "installed)" in result.stdout
    assert "Vocabulary does not exist. Creating vocab..." in result.stdout
    for key in ("Bleu_4", "ROUGE_L", "test_loss"):
        assert any(line.startswith(key) for line in result.stdout.splitlines()), key
    assert "unseen-image color accuracy: " in result.stdout and "unseen-image shape accuracy: " in result.stdout
    with open(out) as f:
        res = json.load(f)
    assert len(res["probe"]["captions"]) == 16 and 0 <= res["probe"]["color"] <= 16
    assert all(np.isfinite(v) for v in res["scores"].values())
    from show_tell_tpu_torch.vocab import load_vocab

    words = set(load_vocab(str(tmp_path / "demo" / "out" / "vocab.pkl")).word_to_index)
    assert "." in words and "background" in words  # the final period split off as nltk splits it


def test_bf16_convergence_runs_both_dtypes(tmp_path):
    out = str(tmp_path / "table.json")
    argv = ["--images", "32", "--epochs", "1", "--device", "cpu", "--root", str(tmp_path / "conv"), "--out", out]
    code = NO_NLTK % (os.path.join(REPO, "tools", "bf16_convergence_torch.py"), argv)
    hidden = tmp_path / "no_nltk" / "nltk"  # the tool's own subprocesses find this nltk first, and it will not import
    hidden.mkdir(parents=True)
    (hidden / "__init__.py").write_text("raise ImportError('nltk is hidden from this test')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(hidden.parent), REPO]), OMP_NUM_THREADS="2")
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                            timeout=300)
    assert result.returncode == 0, result.stderr[-3000:]
    assert "=== bf16-compute training convergence, PyTorch port" in result.stdout
    assert result.stdout.count("(nltk is not installed)") == 2  # each dtype's run tokenized without nltk
    with open(out) as f:
        table = json.load(f)["table"]
    assert sorted(table) == sorted(["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L", "test_loss"])
    for row in table.values():
        assert np.isfinite(row["f32"]) and np.isfinite(row["bf16"]) and row["delta"] == row["bf16"] - row["f32"]
