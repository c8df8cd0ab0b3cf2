"""The port's COCO-workflow tools on the CPU against the JAX package's:
tools/prefill_cache_torch.py (its cache files byte for byte the JAX tool's
on the mini-COCO fixture, in both decode modes; a port CLI run on the
prefilled cache decodes no JPEG), tools/sweep_torch.py (the same run names,
output directories and argv of every run, with ``run`` recorded on both
sides and nothing trained) and tools/reproduce_reference_torch.py (the same
ROWS, argv of every row and dry-run command, but for the package's name)."""

import argparse
import contextlib
import io
import json
import os
import sys

import pytest

from fixtures import build_mini_coco
from torch_eval_helpers import cli_argv
from torch_train_helpers import few_torch_threads  # noqa: F401 (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import prefill_cache as jax_prefill  # noqa: E402
import prefill_cache_torch as prefill  # noqa: E402
import reproduce_reference as jax_reproduce  # noqa: E402
import reproduce_reference_torch as reproduce  # noqa: E402
import sweep as jax_sweep  # noqa: E402
import sweep_torch as sweep  # noqa: E402

ANN = "annotations/captions_train2014.json"
CACHE_FILES = ("index.json", "images_u8.dat", "valid.dat")


@pytest.fixture(scope="module")
def mini_coco(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tools_coco"))
    build_mini_coco(root)
    return root


def _bytes(cache_dir):
    out = {}
    for name in CACHE_FILES:
        with open(os.path.join(cache_dir, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("fast_jpeg", [False, True], ids=["full", "fast_jpeg"])
def test_prefilled_cache_is_byte_equal_to_the_jax_tools(mini_coco, tmp_path, fast_jpeg):
    from show_tell_tpu_torch.data.image_cache import ImageCache
    from show_tell_tpu_torch.data.images import IMAGE_SIZE

    ann, img_dir = os.path.join(mini_coco, ANN), os.path.join(mini_coco, "train2014")
    with contextlib.redirect_stdout(io.StringIO()):
        want = jax_prefill.prefill(ann, img_dir, str(tmp_path / "jax"), batch=3, fast_jpeg=fast_jpeg)
        got = prefill.prefill(ann, img_dir, str(tmp_path / "port"), batch=3, fast_jpeg=fast_jpeg)
        again = prefill.prefill(ann, img_dir, str(tmp_path / "port"), batch=3, fast_jpeg=fast_jpeg)
    assert (got, again) == (want, 0) and got == 8
    assert _bytes(str(tmp_path / "port")) == _bytes(str(tmp_path / "jax"))
    names = json.load(open(str(tmp_path / "port" / "index.json")))["files"]
    assert ImageCache(str(tmp_path / "port"), names, IMAGE_SIZE, fast_jpeg=fast_jpeg).hit_fraction() == 1.0


def test_port_cli_reads_every_image_from_the_prefilled_cache(mini_coco, tmp_path, monkeypatch):
    """The CLI's --image_cache DIR reads DIR/train and DIR/test; with both
    prefilled and every JPEG decoder made to raise, a port CLI run trains an
    epoch and tests: every image it read was a cache hit."""
    from show_tell_tpu_torch.cli.run import run
    from show_tell_tpu_torch.data import dataset
    from show_tell_tpu_torch.native import fastimage

    cache = str(tmp_path / "cache")
    ann, img_dir = os.path.join(mini_coco, ANN), os.path.join(mini_coco, "train2014")
    with contextlib.redirect_stdout(io.StringIO()):
        for split in ("train", "test"):
            prefill.prefill(ann, img_dir, os.path.join(cache, split))

    def no_decode(*a, **k):
        raise AssertionError("a JPEG was decoded: the image cache missed")

    monkeypatch.setattr(dataset, "_pil_decode", no_decode)
    monkeypatch.setattr(fastimage, "decode_resize_batch", no_decode)
    argv = cli_argv(mini_coco, str(tmp_path / "out"), ["--is_training", "1", "--is_testing", "1",
                                                        "--load_model_test", "model_1", "--image_cache", cache])
    with contextlib.redirect_stdout(io.StringIO()):
        scores = run("gru", argv, device="cpu")["scores"]
    assert set(scores) >= {"Bleu_1", "test_loss"}


def test_sweep_runs_and_argv_equal_the_jax_tools(tmp_path, monkeypatch):
    import show_tell_tpu.cli.run as jax_run
    import show_tell_tpu_torch.cli.run as port_run

    calls = {"jax": [], "port": []}

    def recorder(side):
        def run(variant, argv):
            calls[side].append((variant, list(argv)))
            return {"scores": {"Bleu_4": 0.25, "test_loss": 2.5}}

        return run

    monkeypatch.setattr(jax_run, "run", recorder("jax"))
    monkeypatch.setattr(port_run, "run", recorder("port"))
    out = str(tmp_path / "sweep")
    argv = ["--variant", "lstm", "--sweep_output", out, "--lrs", "0.01,0.0001", "--embeds", "256,512",
            "--optimizers", "SGD,Adam", "--data_dir", "/data/COCO", "--num_epochs", "5", "--image_cache", "/c"]
    summaries = {}
    for side, main in (("jax", None), ("port", sweep.main)):
        with contextlib.redirect_stdout(io.StringIO()):
            if main is None:
                monkeypatch.setattr(sys, "argv", ["sweep.py"] + argv)
                jax_sweep.main()
            else:
                assert main(argv) == 0
        with open(os.path.join(out, "sweep_summary.json")) as f:
            summaries[side] = json.load(f)
    assert len(calls["port"]) == 8 and calls["port"] == calls["jax"]
    assert summaries["port"] == summaries["jax"]
    assert sorted(os.listdir(out)) == sorted([r["run"] for r in summaries["jax"]] + ["sweep_summary.json"])
    assert [sweep.run_name("attn", lr, 512, "Adam") for lr in (0.01, 0.001, 1e-4)] == [
        jax_sweep.run_name("attn", lr, 512, "Adam") for lr in (0.01, 0.001, 1e-4)]


@pytest.mark.parametrize("extra", [{}, dict(backbone_weights="r101.pth", deterministic_eval=True, dp=4)],
                         ids=["defaults", "options"])
def test_reproduce_rows_and_argv_equal_the_jax_tools(extra):
    assert reproduce.ROWS == jax_reproduce.ROWS
    args = argparse.Namespace(**dict(dict(data_dir="/data/COCO", output_dir="/out", backbone_weights="",
                                          num_epochs=100, dp=0, deterministic_eval=False), **extra))
    for name, row in jax_reproduce.ROWS.items():
        assert reproduce.build_argv(reproduce.ROWS[name], args) == jax_reproduce.build_argv(row, args), name


def test_reproduce_dry_run_prints_the_ports_command(monkeypatch):
    printed = {}
    for side, main in (("jax", jax_reproduce.main), ("port", reproduce.main)):
        for row in ("gru_512_lr001_sgd", "lstm_512_lr0001_adam"):
            argv = ["--row", row, "--data_dir", "/data/COCO", "--deterministic_eval"]
            with contextlib.redirect_stdout(io.StringIO()) as out:
                if side == "jax":
                    monkeypatch.setattr(sys, "argv", ["reproduce_reference.py"] + argv)
                    assert main() == 0
                else:
                    assert main(argv) == 0
            printed[side, row] = out.getvalue()
    for row, entry in (("gru_512_lr001_sgd", "main"), ("lstm_512_lr0001_adam", "main_lstm")):
        assert "python -m show_tell_tpu_torch.cli.%s " % entry in printed["port", row]
        assert printed["port", row].replace("show_tell_tpu_torch.", "show_tell_tpu.") == printed["jax", row]
