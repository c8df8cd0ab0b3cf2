"""Reference-format torch checkpoints (``torch.save`` of the reference's
utils.py:131-138) read by the port against the JAX package's importer.

Each test writes its own .ckpt from seeded torch modules, as
tests/test_serve.py does for the JAX package: the reference's ResNet-18
wrapped in nn.Sequential (``model.N.*``), the Linear + BatchNorm1d head,
and the decoder's ``embeddings``, ``unit.*`` and ``linear`` (the attention
families add ``init_h``, ``init_c``, ``embed`` and ``attn.*``), with the
BatchNorms off their identity.  The port's trees must equal the JAX
importer's array for array, and its f32 Captioner's greedy and beam ids
the JAX Captioner's bit for bit.
"""

import os

import jax
import numpy as np
import pytest
import torch

from torch_resnet_oracle import TorchResNet
from torch_train_helpers import few_torch_threads  # noqa: F401  (autouse: 2 torch threads)
from show_tell_tpu.models import captioner as jax_captioner
from show_tell_tpu.serve import Captioner as JaxCaptioner
from show_tell_tpu.models import convert as jax_convert
from show_tell_tpu.train.checkpoint import import_torch_checkpoint as jax_import
from show_tell_tpu.vocab.vocabulary import DatasetVocabulary, save_vocab
from show_tell_tpu_torch import serve as port_serve
from show_tell_tpu_torch.models import convert
from show_tell_tpu_torch.serve import Captioner
from show_tell_tpu_torch.train.checkpoint import import_torch_checkpoint

VARIANTS = ("gru", "lstm", "attn", "attn_lstm")
V, E, H, L, A, C = 30, 20, 24, 2, 16, 512
SEQ = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5", "layer3": "6", "layer4": "7"}


def _cfg_kw(variant):
    return dict(nos_filters=C, attn_dim=A) if variant.startswith("attn") else {}


def _write_reference_ckpt(path, variant, seed):
    torch.manual_seed(seed)
    backbone = TorchResNet(18)
    head = torch.nn.Linear(C, E)
    bn1d = torch.nn.BatchNorm1d(E, momentum=0.01)
    for m in list(backbone.modules()) + [bn1d]:  # BN statistics and affine off the identity
        if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.BatchNorm1d)):
            with torch.no_grad():
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.2, 0.2)
                m.running_mean.uniform_(-0.3, 0.3)
                m.running_var.uniform_(0.5, 2.0)
    enc_sd = {}
    for k, v in backbone.state_dict().items():
        if k.startswith("fc."):
            continue
        root = k.split(".")[0]
        enc_sd["model." + SEQ[root] + k[len(root):]] = v
    for k, v in head.state_dict().items():
        enc_sd["linear_secondlast_layer." + k] = v
    for k, v in bn1d.state_dict().items():  # num_batches_tracked included, as torch saves it
        enc_sd["last_layer." + k] = v
    attn = variant.startswith("attn")
    rnn = torch.nn.GRU if variant in ("gru", "attn") else torch.nn.LSTM
    unit = rnn(2 * E if attn else E, H, L, batch_first=True)
    dec_sd = {"embeddings.weight": torch.nn.Embedding(V, E).weight}
    for k, v in unit.state_dict().items():
        dec_sd["unit." + k] = v
    out = torch.nn.Linear(H, V)
    dec_sd["linear.weight"], dec_sd["linear.bias"] = out.weight, out.bias
    if attn:
        linears = {"init_h": (C, H), "embed": (C, E), "attn.encoder_att": (C, A), "attn.decoder_att": (H, A),
                   "attn.full_att": (A, 1)}
        if variant == "attn_lstm":
            linears["init_c"] = (C, H)
        for name, (i, o) in linears.items():
            lin = torch.nn.Linear(i, o)
            dec_sd[name + ".weight"], dec_sd[name + ".bias"] = lin.weight, lin.bias
    torch.save({"encoder_state_dict": enc_sd, "decoder_state_dict": dec_sd,
                "optimizer_state_dict": {"state": {}, "param_groups": []}, "epoch": 9, "step": 1}, path)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("ref_ckpt")
    vocab = DatasetVocabulary()
    for w in ["<pad>", "<start>", "<end>", "<unk>"] + ["w%d" % i for i in range(V - 4)]:
        vocab.add_new_word(w)
    vocab_path = str(root / "vocab.pkl")
    save_vocab(vocab, vocab_path)
    paths = {}
    for i, variant in enumerate(VARIANTS):
        paths[variant] = str(root / ("model_9_%s.ckpt" % variant))
        _write_reference_ckpt(paths[variant], variant, seed=20 + i)
    return paths, vocab_path


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(5).randint(0, 256, (3, 64, 64, 3), dtype=np.uint8)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, "%s%s/" % (prefix, k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, "%s%d/" % (prefix, i)))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("variant", VARIANTS)
def test_trees_equal_the_jax_importer(ckpts, variant):
    paths, _ = ckpts
    jcfg = jax_captioner.CaptionerConfig(variant, 18, E, H, V, L, **_cfg_kw(variant))
    want = _flat(jax.tree.map(np.asarray, jax_import(paths[variant], jcfg)))
    got = _flat(import_torch_checkpoint(paths[variant], jcfg))
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert not any("num_batches_tracked" in k for k in got)


@pytest.mark.parametrize("variant", VARIANTS)
def test_decoder_converters_equal_the_jax_converters(ckpts, variant):
    """decoder_params_from_torch / attn_decoder_params_from_torch of the
    file's decoder state_dict, and decoder_params_to_torch back, against
    the JAX package's converters."""
    sd = torch.load(ckpts[0][variant], map_location="cpu", weights_only=True)["decoder_state_dict"]
    attn = variant.startswith("attn")
    ours = (convert.attn_decoder_params_from_torch if attn else convert.decoder_params_from_torch)(sd, L)
    theirs = (jax_convert.attn_decoder_params_from_torch if attn else jax_convert.decoder_params_from_torch)(sd, L)
    want = _flat(jax.tree.map(np.asarray, theirs))
    got = _flat(ours)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = convert.decoder_params_to_torch(ours)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v.detach().numpy(), err_msg=k)
    if not attn:
        jback = jax_convert.decoder_params_to_torch(theirs)
        assert sorted(jback) == sorted(back)
    lin = convert.linear_from_torch(sd, "linear")
    np.testing.assert_array_equal(lin["w"], np.asarray(jax_convert.linear_from_torch(sd, "linear")["w"]))


@pytest.mark.parametrize("variant", VARIANTS)
def test_captioner_ids_bit_equal_to_jax(ckpts, images, variant):
    """Captioner.from_checkpoint of a reference .ckpt: f32 greedy and beam
    (K=3) ids equal the JAX Captioner's on the same file."""
    paths, vocab_path = ckpts
    kw = dict(variant=variant, resnet_version=18, embed_dim=E, hidden_dim=H, num_layers=L, compute_dtype="float32",
              **_cfg_kw(variant))
    ref = JaxCaptioner.from_checkpoint(paths[variant], vocab_path, **kw)
    port = Captioner.from_checkpoint(paths[variant], vocab_path, device="cpu", fold_bn=False, **kw)
    for beam in (0, 3):
        ids = port.caption_ids(images, beam_size=beam)
        assert ids.shape == (len(images), 25)
        np.testing.assert_array_equal(ids, ref.caption_ids(images, beam_size=beam), err_msg="beam %d" % beam)


def test_serve_cli_reads_a_reference_ckpt(ckpts, tmp_path, capsys):
    paths, vocab_path = ckpts
    from PIL import Image

    img = str(tmp_path / "x.jpg")
    Image.fromarray(np.random.RandomState(1).randint(0, 256, (80, 96, 3), dtype=np.uint8)).save(img)
    rc = port_serve.main(["--ckpt", paths["attn"], "--vocab", vocab_path, "--variant", "attn", "--resnet_version",
                          "18", "--embedding_length", str(E), "--num_hidden_units", str(H), "--num_layers", str(L),
                          "--attn_dim", str(A), "--compute_dtype", "float32", "--device", "cpu", img])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith(img + "\t")


def test_torn_file_names_both_errors(ckpts, tmp_path):
    paths, vocab_path = ckpts
    torn = str(tmp_path / "torn.ckpt")
    with open(paths["gru"], "rb") as f:
        data = f.read()
    with open(torn, "wb") as f:
        f.write(data[: len(data) // 2])
    with pytest.raises(ValueError) as err:
        Captioner.from_checkpoint(torn, vocab_path, variant="gru", resnet_version=18, embed_dim=E, hidden_dim=H,
                                  num_layers=L, compute_dtype="float32", device="cpu")
    msg = str(err.value)
    assert "neither as a show_tell_tpu checkpoint" in msg and "nor as a torch checkpoint" in msg, msg
    assert os.path.basename(torn) in msg
