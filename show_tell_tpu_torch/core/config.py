"""Config system: config.json + argparse parity with the reference CLI
(the port's own copy of show_tell_tpu/core/config.py: the same flags,
types and defaults, with help strings that describe the port).

The reference merges a per-dataset block of ``config.json`` with argparse
flags whose *defaults* are the JSON values (reference main.py:31-76), and
passes the resulting flat ``params`` dict everywhere.  We reproduce that
contract exactly — every flag from reference main.py:37-64 /
Attention/main_attn.py:41-70 is accepted with identical names, types and
defaults — and add the framework's extensions under clearly-separated names.

Two JSON default blocks exist in the reference: the GRU baseline
(config.json) and the LSTM/Attention variants (LSTM/config.json =
Attention/config.json) which bump ``embedding_length`` to 512 and add
``nos_cnn_filters`` / ``attn_dim``.  Both are embedded here verbatim in
semantics (same keys, same values) so the framework is usable without any
external file; an on-disk config.json (``--config`` or ``./config.json``)
overrides the embedded defaults, preserving the reference workflow.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
from typing import Any, Dict, Optional

# Reference config.json:2-27 (MSCOCO block) and :28-53 (Flickr block).
DEFAULT_CONFIG: Dict[str, Dict[str, Any]] = {
    "MSCOCO": {
        "data_dir": "./data/COCO",
        "output_dir": "./output/COCO",
        "train_ann_path": "annotations/captions_train2014.json",
        "test_ann_path": "annotations/captions_val2014.json",
        "vocabulary_path": "vocab.pkl",
        "train_img_dir": "train2014",
        "test_img_dir": "val2014",
        "vocab_threshold": 5,
        "embedding_length": 256,
        "num_hidden_units": 512,
        "lr": 0.01,
        "momentum": 0.9,
        "num_epochs": 100,
        "num_layers": 5,
        "batch_size": 32,
        "shuffle": 1,
        "num_workers": 0,
        "resume_training": 0,
        "resume_model_train": "model_1",
        "is_training": 1,
        "is_testing": 0,
        "load_model_test": "model_50",
        "device": "gpu",
        "sub_batch_test": 10,
    },
    "Flickr": {
        "data_dir": "./data/Flickr",
        "output_dir": "./output/Flickr",
        "train_ann_path": "annotations/captions.tsv",
        "test_ann_path": "",
        "vocabulary_path": "vocab.pkl",
        "train_img_dir": "train",
        "test_img_dir": "train",
        "vocab_threshold": 5,
        "embedding_length": 256,
        "num_hidden_units": 512,
        "lr": 0.01,
        "momentum": 0.9,
        "num_epochs": 100,
        "num_layers": 5,
        "batch_size": 32,
        "shuffle": 1,
        "num_workers": 0,
        "resume_training": 0,
        "resume_model_train": "1",
        "is_training": 1,
        "is_testing": 0,
        "load_model_test": "1",
        "device": "gpu",
        "sub_batch_test": 10,
    },
}

# Reference LSTM/config.json = Attention/config.json: embedding 512, CNN
# filter count and attention dim added, device/sub_batch_test absent.
ATTN_LSTM_CONFIG: Dict[str, Dict[str, Any]] = copy.deepcopy(DEFAULT_CONFIG)
for _block in ATTN_LSTM_CONFIG.values():
    _block["embedding_length"] = 512
    _block["nos_cnn_filters"] = 2048
    _block["attn_dim"] = 512
    _block.pop("device", None)
    _block.pop("sub_batch_test", None)


def _load_config_block(
    data_source: str,
    variant: str,
    config_path: Optional[str],
) -> Dict[str, Any]:
    """Resolve the per-dataset config block, preferring an on-disk file."""
    if config_path and os.path.isfile(config_path):
        with open(config_path) as f:
            return json.load(f)[data_source]
    base = ATTN_LSTM_CONFIG if variant in ("lstm", "attn", "attn_lstm") else DEFAULT_CONFIG
    return copy.deepcopy(base[data_source])


def build_arg_parser(
    variant: str = "gru",
    data_source: str = "MSCOCO",
    config_path: Optional[str] = None,
) -> argparse.ArgumentParser:
    """Argparse surface identical to the reference entry points.

    variant: 'gru' (main.py), 'lstm' (LSTM/main_lstm.py), 'attn'
    (Attention/main_attn.py), 'attn_lstm' (Attention/main_attn_LSTM.py).
    Flags and defaults follow reference main.py:37-64 and
    Attention/main_attn.py:41-70.
    """
    config = _load_config_block(data_source, variant, config_path)
    p = argparse.ArgumentParser()
    add = p.add_argument

    add("--data_dir", type=str, default=config["data_dir"], help="path to the data directory")
    add("--output_dir", type=str, default=config["output_dir"], help="path to the output directory")
    add("--train_ann_path", type=str, default=config["train_ann_path"], help="path to training annotations")
    add("--test_ann_path", type=str, default=config["test_ann_path"], help="path to validation annotations")
    add("--vocabulary_path", type=str, default=config["vocabulary_path"], help="path to the vocabulary file")
    add("--train_img_dir", type=str, default=config["train_img_dir"], help="path to the images for training")
    add("--test_img_dir", type=str, default=config["test_img_dir"], help="path to the images for validation")
    add("--vocab_threshold", type=int, default=config["vocab_threshold"], help="threshold for including words in the data vocabulary")
    add("--embedding_length", type=int, default=config["embedding_length"], help="length of the embedding to be used by CNN and RNN")
    if variant in ("attn", "attn_lstm"):
        add("--nos_cnn_filters", type=int, default=config.get("nos_cnn_filters", 2048), help="number of channels in the final features of the CNN")
        add("--attn_dim", type=int, default=config.get("attn_dim", 512), help="dimensions of the attention feature of the CNN")
    add("--num_hidden_units", type=int, default=config["num_hidden_units"], help="hidden units to be used by the RNN")
    add("--optimizer_type", type=str, default="SGD", help="optimizer to be used at the time of training")
    add("--resnet_version", type=int, default=101, help="ResNet version to be used for the encoding job")
    if variant in ("attn", "attn_lstm"):
        add("--alpha_c", type=float, default=1.0, help="Weighting term for Doubly Stochastic Attention")
    add("--lr", type=float, default=config["lr"], help="learning rate")
    add("--momentum", type=float, default=config["momentum"], help="momentum for the optimizer")
    add("--num_epochs", type=int, default=config["num_epochs"], help="number of epochs for training")
    add("--num_layers", type=int, default=config["num_layers"], help="layers to be used by the RNN")
    add("--batch_size", type=int, default=config["batch_size"], help="batch size to be used for training data loader")
    add("--shuffle", type=bool, default=config["shuffle"], help="indicator for shuffling the training data while loading")
    add("--num_workers", type=int, default=config["num_workers"], help="num of workers")
    add("--resume_training", type=bool, default=config["resume_training"], help="indicator for resuming the training")
    add("--resume_model_train", type=str, default=config["resume_model_train"], help="model for resuming the training")
    add("--is_training", type=int, default=config["is_training"], help="indicates whether the model needs to be trained")
    add("--is_testing", type=int, default=config["is_testing"], help="indicates whether the model needs to be tested")
    add("--load_model_test", type=str, default=config["load_model_test"], help="model number for inference")
    if variant == "gru":
        add("--device", type=str, default=config.get("device", "gpu"), help="device to be used - gpu/cpu/tpu (gpu and tpu both mean the CUDA card)")
        add("--sub_batch_test", type=int, default=config.get("sub_batch_test", 10), help="Number of mini-batches to be used from test while training")
        add("--beam_size", type=int, default=0, help="Beam size in testing")
    else:
        # Framework extension: the reference LSTM/attention CLIs have no beam
        # flag; the batched beam here serves all variants (and needs no
        # batch_size=1 restriction).
        add("--beam_size", type=int, default=0, help="Beam size in testing (framework extension; 0 = greedy like the reference)")

    # --- framework extensions (not present in the reference CLI) ---
    add("--compute_dtype", type=str, default="float32", choices=["float32", "bfloat16"], help="eval/serving dtype (float32 for parity, bfloat16 for speed: the kernels' tensor-core instances; metric deltas pinned <=0.05 by test)")
    add("--train_dtype", type=str, default="float32", choices=["float32", "bfloat16"], help="training compute dtype (train/train_step.py): bfloat16 casts the forward/backward inside the loss while master weights, grads, optimizer state, BN running stats, and the CE reduction stay f32 — no loss scaling needed (bf16 keeps f32's exponent range). f32 is the default and the parity dtype (TF32 off on the GPU)")
    add("--dp", type=int, default=0, help="data-parallel size: N > 1 spawns N processes, one a device (the CUDA cards of this host, or the CPU), joined by torch.distributed; 0 = every process of a --multihost group, or one device")
    add("--mp", type=int, default=1, help="eval-phase tensor parallelism: shard the decoder's vocab-sized params (output projection, embedding) over this many devices per dp shard (mesh = dp x mp, one process each; vocab_size must divide mp); training stays data parallel over all dp x mp processes")
    add("--multihost", type=str, default="", help="join a multi-host run: 'coordinator_host:port,num_processes,process_id' (same on every host except the id), or 'auto' under torchrun; dp then spans every process's device (parallel/multihost.py)")
    add("--use_pallas", type=int, default=-1, help="eval decode route: -1 (auto) and 1 both run the port's CUDA kernels (their plain twins on the CPU); 0 the library route, the JAX package's XLA decode: the plain decodes in PyTorch's own operators, no kernel of the port")
    add("--faithful_beam", type=int, default=0, help="replicate the reference rnn.py beam-search quirks exactly (batch=1) instead of standard cumulative-logprob beam")
    add("--seed", type=int, default=1, help="global RNG seed (reference seeds torch/random with 1)")
    add("--max_caption_length", type=int, default=25, help="decode length cap (reference rnn.py:39)")
    add("--keep_checkpoints", type=int, default=0, help="retention: keep only the newest N epoch checkpoints (0 = keep all, like the reference); --resume_model_train auto resumes from the newest")
    add("--ckpt_format", type=str, default="pickle", choices=["pickle", "orbax"], help="checkpoint backend: pickle (reference-compatible single file); orbax (TensorStore directories) is not ported and raises")
    add("--backbone_weights", type=str, default="", help="path to a torchvision ResNet state_dict .pth to initialize the frozen backbone — replaces the reference's pretrained=True download (cnn.py:23-31) in zero-egress environments; head/decoder keep the reference init")
    add("--eval_augment", type=int, default=1, help="apply random flips at eval time like the reference (utils.py:96); 0 disables for deterministic metric runs")
    add("--fast_jpeg", type=int, default=0, help="DCT-domain scaled JPEG decode in the input pipeline (~2x faster per image, pixels within a few LSB of the full-resolution decode); 0 = full-resolution parity decode")
    add("--profile_dir", type=str, default="", help="write a torch.profiler trace of train steps 2-6 of the first epoch to this directory (chrome trace JSON)")
    add("--image_cache", type=str, default="", help="memmap cache of decoded 224x224 uint8 images (~150KB/image): each JPEG is decoded once per dataset instead of ~5x per epoch x num_epochs (annotation-keyed sampling shares images; augmentation runs on device so cached pixels are epoch-invariant). Caches by file NAME, not contents: delete the cache dir if image files are replaced")
    add("--attn_next_token", type=int, default=0, help="train attention variants with proper next-token targets instead of the reference's w_t->w_t copy alignment (SURVEY.md 3.2; see docs/ARCHITECTURE.md for why the faithful mode cannot caption)")
    add("--early_exit", type=int, default=0, help="stop eval decode (greedy or beam) as soon as every sequence/beam emitted <end> (one host sync a step) — identical captions and metrics, decode wall-time follows the longest caption instead of the fixed 25 steps (reference rnn.py:39 decodes all 25 unconditionally)")
    add("--score_threads", type=int, default=0, help="eval host-scoring thread pool size: the native per-batch scorer releases the GIL, so scoring parallelizes across host cores while the GPU decodes ahead; results drain in batch order so all scores/prints are bit-identical to serial. 0 = auto (spare cores, capped at 8), 1 = serial")
    return p


def derive_paths(params: Dict[str, Any]) -> Dict[str, Any]:
    """Derived paths exactly as reference main.py:72-76."""
    params["vocab_path"] = os.path.join(params["output_dir"], params["vocabulary_path"])
    params["ann_path_train"] = os.path.join(params["data_dir"], params["train_ann_path"])
    params["data_path_train"] = os.path.join(params["data_dir"], params["train_img_dir"])
    params["ann_path_test"] = os.path.join(params["data_dir"], params["test_ann_path"])
    params["data_path_test"] = os.path.join(params["data_dir"], params["test_img_dir"])
    return params


def load_params(
    argv=None,
    variant: str = "gru",
    data_source: str = "MSCOCO",
    config_path: Optional[str] = None,
) -> Dict[str, Any]:
    """Parse argv into the flat ``params`` dict the whole framework consumes."""
    import sys as _sys

    # --data_source (extension): the reference hardcodes 'MSCOCO'
    # (main.py:29; Flickr reachable only by editing that line). The flag
    # must be parsed BEFORE the main parser is built because it selects
    # which config block supplies every other flag's default — a real
    # preliminary argparse handles --data_source=X, abbreviations,
    # repeats (last wins), and bad values with proper usage errors.
    _ds_help = "dataset family (framework extension; the reference hardcodes MSCOCO at main.py:29 — Flickr uses the config's Flickr block and a TSV annotation index)"
    scan = list(_sys.argv[1:] if argv is None else argv)
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--data_source", type=str, default=data_source, choices=["MSCOCO", "Flickr"], help=_ds_help)
    data_source = pre.parse_known_args(scan)[0].data_source
    parser = build_arg_parser(variant, data_source, config_path)
    parser.add_argument("--data_source", type=str, default=data_source, choices=["MSCOCO", "Flickr"], help=_ds_help)
    params = vars(parser.parse_args(argv))
    params["variant"] = variant
    params["data_source"] = data_source
    derive_paths(params)
    # Reference main.py:81-82: beam search forces batch_size=1 — a
    # main.py (GRU CLI) behavior kept for parity; the extension beam on
    # the other variants is batched and needs no such restriction.
    if variant == "gru" and params.get("beam_size", 0) and params["beam_size"] > 0:
        params["batch_size"] = 1
    return params
