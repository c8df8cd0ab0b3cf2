"""The test_model flow — reference utils.py:105-247 rebuilt (counterpart of
show_tell_tpu/evaluation/tester.py).

Per batch: teacher-forced loss, free-running decode (batched greedy, or
beam search), ids -> words with <end> truncation and <start> skipping,
per-batch evaluate() scores accumulated and averaged, progress prints
each 100 steps.  Afterwards: per-image target/candidate dicts pickled to
``Target_Words_Dict.pickle`` / ``Candidate_Words_Dict.pickle``
(utils.py:226-230) and a second per-image nltk corpus_bleu pass with
method4 smoothing (utils.py:232-246).

The loop is software-pipelined, as the JAX package's is, output-identical
by test: each batch is staged on the device one step ahead
(data/device_prefetch.py), and its step (loss and decode, through the
decode kernels on a GPU, or with ``--use_pallas 0`` by the library route:
the plain decodes in PyTorch's operators, as the JAX package's XLA route
decodes) is queued before the previous batch is scored on
the host, so the card works under the pure-host scoring.  Nothing of a
batch is read on the host before ``consume``: the captions and lengths the
host needs travel beside their device copies.  The scoring itself runs on
a thread pool (the native scorer releases the GIL) whose results are
drained in batch order.

In a group of processes (``--dp``, ``--multihost``; parallel/) every
process runs test_model together over the same batches: each step is split
over the ranks (train_step.make_eval_step with the mesh: each decodes its
rows, the ids are gathered, the loss summed), so every process holds the
same captions; the host scoring is sharded, batch i on the processes of
dp group i % dp (and image i of the corpus pass likewise), and the float64
score tables are summed over the dp axis, bit for bit; only rank 0 writes
the pickles.  ``--mp`` M > 1 shards the vocabulary as well, over a dp x M
mesh (the JAX package's ``shard_train_state(tensor_parallel=True)``,
train_step.shard_train_state): the teacher-forced CE takes its logsumexp
and target logits over the mp group, and every decode its sharded route;
M must divide the vocabulary, as in the JAX package.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from show_tell_tpu_torch.data.device_prefetch import device_prefetch
from show_tell_tpu_torch.decode.faithful_beam import faithful_beam_decode
from show_tell_tpu_torch.evaluation import metrics
from show_tell_tpu_torch.evaluation.metrics import evaluate
from show_tell_tpu_torch.models.captioner import CaptionerConfig, prepare_decode
from show_tell_tpu_torch.parallel.mesh import Mesh, make_mesh, sum_tables
from show_tell_tpu_torch.parallel.multihost import is_primary, process_count
from show_tell_tpu_torch.train.train_step import COMPUTE_DTYPES, TrainState, make_eval_step, shard_train_state
from show_tell_tpu_torch.utils import StepTimer

# When False, each batch is scored before the next step is queued (the
# reference's fully serial order).  Output-identical either way — exists
# so the eval rate can be A/B'd with the overlap on and off.
PIPELINE_SCORING = True

# When False, the eval loop's H2D staging (device_prefetch's one-batch-ahead
# copy) is disabled and each batch is copied when taken — the reference's
# serial order.  Output-identical either way; exists for the same A/B.
STAGE_H2D = True

SCORE_KEYS = ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "CIDEr", "ROUGE_L"]


def create_caption_word_format(tokenized, vocab, flag_blue: bool = False) -> List:
    """ids -> words; truncate at <end>, drop <start> (utils.py:105-123)."""
    caption_words = []
    start_idx = vocab.word_to_index[vocab.start_token()]
    for token in tokenized:
        curr_word = []
        for idx in token:
            idx = int(idx)
            if vocab.index_to_word[idx] == vocab.end_token():
                break
            if idx != start_idx:
                curr_word.append(vocab.index_to_word[idx])
        caption_words.append([curr_word] if flag_blue else curr_word)
    return caption_words


def make_test_step(
    cfg: CaptionerConfig,
    beam_size: int = 0,
    augment: bool = True,
    use_pallas: Optional[bool] = None,
    compute_dtype: str = "float32",
    loss_only: bool = False,
    early_exit: bool = False,
    end_token: int = 2,
    mesh: Optional[Mesh] = None,
):
    """(loss, decoded ids) for one batch: ``train_step.make_eval_step``
    (evaluate(ts, images_u8, captions, lengths, generator, prepared, t_max)).
    beam_size > 0 takes the batched beam (every family; the reference's
    attention CLIs are greedy only); loss_only returns the encoder features
    in the ids slot instead (the faithful beam decodes them on the host, so
    the batch pays for one encoder forward).

    early_exit (``--early_exit 1``, off by default): stop the decode loop,
    greedy and beam, as soon as every sequence or beam has emitted <end>.
    Caption output (and so every metric) is identical: positions after
    <end> become <pad> instead of the reference's don't-care argmax
    continuations, and ``create_caption_word_format`` truncates at <end>
    either way.  It reads one flag on the host a step.

    use_pallas (``--use_pallas``): None (-1, auto) and True (1) decode
    through the port's kernels (their plain twins on the CPU); False (0) by
    the library route, the JAX package's XLA decode: the plain decodes of
    the model's weights in PyTorch's operators, no kernel of this package
    (``make_eval_step(kernels=False)``)."""
    return make_eval_step(cfg, augment=augment, compute_dtype=compute_dtype, beam_size=beam_size,
                          loss_only=loss_only, early_exit=early_exit, end_token=end_token, mesh=mesh,
                          kernels=use_pallas is not False)


def check_eval_params(params: Dict[str, Any]) -> None:
    """Raise for a ``--use_pallas`` outside -1 (auto), 0 (the library
    route) and 1 (the kernels)."""
    use_pallas = int(params.get("use_pallas", -1))
    if use_pallas not in (-1, 0, 1):
        raise ValueError("--use_pallas takes -1 (auto: the kernels), 0 (the library route, the JAX package's XLA "
                         "decode) or 1 (the kernels), not %d" % use_pallas)


def _with_host_copies(data_loader):
    """Each loader batch (paths, images, captions, lengths) with the host's
    captions and lengths appended, so the staged batch's device copies are
    never read back."""
    for paths, images, captions, lengths in data_loader:
        yield paths, images, captions, lengths, np.asarray(captions), np.asarray(lengths)


def eval_mesh(params: Dict[str, Any], data_loader, device, vocab_size: int) -> Optional[Mesh]:
    """The sharded eval's dp x mp mesh over every process of a group, or
    None in one process.  An explicit ``--dp`` that cannot split the eval's
    batches raises rather than falling back to one device, and so does an
    ``--mp`` that does not divide the vocabulary (the JAX package's rule,
    show_tell_tpu/evaluation/tester.py:265-270)."""
    dp = int(params.get("dp", 0) or 0)
    mp = int(params.get("mp", 1) or 1)
    if process_count() == 1 and dp <= 1 and mp <= 1:
        return None
    if mp > 1 and vocab_size % mp:
        raise ValueError(
            "--mp %d does not divide vocab_size %d; the eval loss path "
            "cannot pad the vocab (serve.Captioner can — decode-only)" % (mp, vocab_size)
        )
    mesh = make_mesh(dp, mp, device=device)
    eval_batch = getattr(data_loader, "batch_size", params.get("batch_size", 0))
    if dp > 1 and eval_batch and eval_batch % dp:
        raise ValueError("eval mesh dp=%d x mp=%d cannot form: %d devices visible and the eval batch size %s must "
                         "divide dp" % (dp, mp, process_count(), eval_batch))
    return mesh


def test_model(
    train_state: TrainState,
    cfg: CaptionerConfig,
    data_loader,
    vocab,
    params: Dict[str, Any],
    sub_batch_size: int = -1,
    beam_size: int = 0,
    faithful_beam: bool = False,
    seed: int = 1,
    timer: Optional[StepTimer] = None,
) -> Dict[str, float]:
    """Run evaluation on ``train_state``'s device; returns the final averaged
    score dict.  ``timer``: a StepTimer that gets each batch's host-clock
    time to queue its step ("step") and to consume it ("score": the wait
    for its loss and ids, the caption dicts, the scoring or its hand-off to
    the pool)."""
    test_loss: List[float] = []
    accum: Dict[str, List[float]] = {k: [] for k in SCORE_KEYS}
    scored_rows: Dict[int, List[float]] = {}  # batch idx -> per-batch scores
    target_caption_full: Dict[str, list] = {}
    candidate_caption_full: Dict[str, list] = {}
    timer = timer if timer is not None else StepTimer()

    check_eval_params(params)
    mesh = eval_mesh(params, data_loader, train_state.device, cfg.vocab_size)
    nproc, proc_id = (mesh.dp, mesh.dp_rank) if mesh is not None else (1, 0)
    if sub_batch_size == -1:
        sub_batch_size = len(data_loader)

    compute_dtype = str(params.get("compute_dtype", "float32") or "float32")
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError("compute_dtype must be one of %s, not %r" % (sorted(COMPUTE_DTYPES), compute_dtype))
    # bf16: every float weight and BN statistic cast, as the JAX package casts its trainable, frozen and bn_state
    # trees; mp: this rank's vocabulary shard.  The caller's model stays as it is.
    full_state = train_state
    train_state = shard_train_state(train_state, mesh, COMPUTE_DTYPES[compute_dtype])
    model = train_state.model
    device = train_state.device

    eval_augment = bool(params.get("eval_augment", 1))
    use_faithful = faithful_beam and beam_size > 0
    up_flag = int(params.get("use_pallas", -1))  # -1 auto / 0 the library route / 1 the kernels
    step_fn = make_test_step(
        cfg,
        0 if faithful_beam else beam_size,
        # The reference augments (random flips) at test time (utils.py:96);
        # --eval_augment 0 pins eval deterministic (SURVEY.md §7).
        augment=eval_augment,
        use_pallas=None if up_flag == -1 else bool(up_flag),
        compute_dtype=compute_dtype,
        loss_only=use_faithful,
        # --faithful_beam decodes host-side step by step; early_exit only
        # shapes the batched decode loops.
        early_exit=bool(params.get("early_exit", 0)) and not use_faithful,
        end_token=vocab.word_to_index[vocab.end_token()],
        mesh=mesh,
    )
    # The weights do not change inside an eval: the kernels' layout is built once (the library route reads none).
    prepared = None
    if up_flag != 0 or use_faithful:
        prepared = prepare_decode(model, COMPUTE_DTYPES[compute_dtype] or torch.float32)
    faithful_prepared = prepared
    if use_faithful and mesh is not None and mesh.mp > 1:  # the faithful beam decodes on the host, unsharded
        faithful_prepared = prepare_decode(shard_train_state(full_state, None, COMPUTE_DTYPES[compute_dtype]).model,
                                           COMPUTE_DTYPES[compute_dtype] or torch.float32)
    # One CPU generator: each batch draws its flips from it, one draw a batch.
    generator = torch.Generator().manual_seed(seed)

    start_time = time.time()
    print("Testing started.")
    print("Sub-batch size - ", sub_batch_size)

    # Scoring thread pool: evaluate()'s hot path is the NATIVE scorer
    # (fastmetrics.cpp) whose ctypes call releases the GIL, so on a
    # multi-core host the per-batch scoring parallelizes.  Results are
    # DRAINED IN BATCH ORDER (futures resolved idx-ascending at every print
    # boundary and at the end), so every accumulation, print, and final
    # score is bit-identical to the serial loop (pinned by
    # tests/test_torch_eval_invariants.py).  0 = auto: one worker per spare
    # host core, capped at 8; serial below 2.
    score_threads = int(params.get("score_threads", 0) or 0)
    if score_threads <= 0:
        score_threads = min(8, (os.cpu_count() or 1) - 1)
    executor = None
    if score_threads > 1 and not use_faithful:
        from concurrent.futures import ThreadPoolExecutor

        executor = ThreadPoolExecutor(max_workers=score_threads)
    score_futures: Dict[int, Any] = {}

    def _resolve_scores(upto: Optional[int] = None) -> None:
        """Fold finished scoring futures into scored_rows/accum in idx
        order (deterministic float accumulation)."""
        for i in sorted(score_futures):
            if upto is not None and i > upto:
                break
            row = score_futures.pop(i).result()
            scored_rows[i] = row
            for k, v in zip(SCORE_KEYS, row):
                accum[k].append(v)

    def _score_one(target_words, predicted_words):
        eval_scores = evaluate(target_words, predicted_words)
        return [eval_scores[k] for k in SCORE_KEYS]

    def consume(idx, img_paths, captions, loss, ids):
        """Host-side scoring of one decoded batch (blocks on its device
        results).  Runs one batch BEHIND the step loop so the card decodes
        batch i+1 while the host scores batch i.  Accumulation order and
        every printed line are identical to the unpipelined loop
        (reference utils.py:168-224)."""
        with timer.stage("score"):
            loss = float(loss)
            test_loss.append(loss)

            ids = ids.cpu().numpy() if torch.is_tensor(ids) else np.asarray(ids)
            predicted_words = create_caption_word_format(ids, vocab, False)
            target_words = create_caption_word_format(captions, vocab, True)

            for imgs, tgt, pdt in zip(img_paths, target_words, predicted_words):
                if imgs in target_caption_full:
                    target_caption_full[imgs].extend(tgt)
                    candidate_caption_full[imgs].append(pdt)
                else:
                    target_caption_full[imgs] = list(tgt)
                    candidate_caption_full[imgs] = [pdt]

            if idx % nproc == proc_id:  # one process: every batch
                if executor is not None:
                    score_futures[idx] = executor.submit(_score_one, target_words, predicted_words)
                else:
                    scored_rows[idx] = _score_one(target_words, predicted_words)
                    for k, v in zip(SCORE_KEYS, scored_rows[idx]):
                        accum[k].append(v)

        # Running means over every batch so far, exactly the reference print (a group of processes: over this
        # process's share of the batches).
        if (idx + 1) % 100 == 0:
            _resolve_scores(upto=idx)
            _m = lambda k: float(np.mean(accum[k])) if accum[k] else 0.0
            print(
                "Step %d - %0.4f test loss, %0.2f time, %.3f BLEU1, %.3f BLEU2, %.3f BLEU3, %.3f BLEU4, %.3f CIDEr, %.3f ROUGE_L."
                % (
                    idx + 1,
                    loss,
                    time.time() - start_time,
                    _m("Bleu_1") * 100.0,
                    _m("Bleu_2") * 100.0,
                    _m("Bleu_3") * 100.0,
                    _m("Bleu_4") * 100.0,
                    _m("CIDEr") * 100.0,
                    _m("ROUGE_L") * 100.0,
                )
            )

    pending = None  # one in-flight batch: (idx, img_paths, captions, loss, ids)
    batches = device_prefetch(_with_host_copies(data_loader), device, stage_ahead=STAGE_H2D)
    try:
        for idx, (img_paths, images, captions, lengths, host_captions, host_lengths) in enumerate(batches):
            if idx == sub_batch_size:
                break
            with timer.stage("step"):
                t_max = int(host_lengths.max())
                loss, ids = step_fn(train_state, images, captions, lengths,
                                    generator if eval_augment else None, prepared, t_max)
            if use_faithful:
                # The loss_only step returned the encoder features in the ids slot
                # (the same flips as the loss; one encoder forward per batch).  The
                # beam decode runs on the host step by step, so there is no device
                # work to pipeline: consume in place.
                ids = faithful_beam_decode(faithful_prepared, cfg.decoder_config(), ids, beam_size)[None, :]
                consume(idx, img_paths, host_captions, loss, ids)
                continue
            if pending is not None:
                consume(*pending)
            pending = (idx, img_paths, host_captions, loss, ids)
            if not PIPELINE_SCORING:  # A/B: score in place (reference order)
                consume(*pending)
                pending = None
        if pending is not None:
            consume(*pending)
        _resolve_scores()
    finally:
        batches.close()
        if executor is not None:
            executor.shutdown(wait=True)

    # The per-batch score table (in a group of processes each row scored by one of them), averaged in batch order.
    table = np.zeros((len(test_loss), len(SCORE_KEYS)), np.float64)
    for i, row in scored_rows.items():
        table[i] = row
    table = sum_tables(table, mesh)
    final = {k: float(np.mean(table[:, j])) for j, k in enumerate(SCORE_KEYS)}
    final["test_loss"] = float(np.mean(test_loss))
    print(
        "%0.4f test loss, %0.2f time, %.3f BLEU1, %.3f BLEU2, %.3f BLEU3, %.3f BLEU4, %.3f CIDEr, %.3f ROUGE_L."
        % (
            final["test_loss"],
            time.time() - start_time,
            final["Bleu_1"] * 100.0,
            final["Bleu_2"] * 100.0,
            final["Bleu_3"] * 100.0,
            final["Bleu_4"] * 100.0,
            final["CIDEr"] * 100.0,
            final["ROUGE_L"] * 100.0,
        )
    )

    # Every process holds the same captions; the primary alone writes them (two writers would tear the files).
    if is_primary():
        with open(os.path.join(params["output_dir"], "Target_Words_Dict.pickle"), "wb") as f:
            pickle.dump(target_caption_full, f)
        with open(os.path.join(params["output_dir"], "Candidate_Words_Dict.pickle"), "wb") as f:
            pickle.dump(candidate_caption_full, f)

    # ------ per-image nltk corpus BLEU pass (utils.py:232-246) -------- #
    # The native scorer (fastmetrics.corpus_bleu4_sums) and
    # nltk_bleu4_method4 (one-pass Python) are both bit-equal to the
    # reference's 4 corpus_bleu(method4) calls per candidate (pinned in
    # tests/test_torch_metrics.py against the JAX package's).
    from show_tell_tpu_torch.native import fastmetrics

    weights = [(1.0, 0, 0, 0), (0.5, 0.5, 0, 0), (0.34, 0.33, 0.33, 0), (0.25, 0.25, 0.25, 0.25)]
    img_names = list(target_caption_full)
    corpus_rows = np.zeros((len(img_names), 4), np.float64)
    for i, img_nm in enumerate(img_names):
        if i % nproc != proc_id:  # the same insertion order on every process
            continue
        cands = candidate_caption_full[img_nm]
        refs = target_caption_full[img_nm]
        sums = fastmetrics.corpus_bleu4_sums(refs, cands, weights)
        if sums is None:  # Python path: unavailable lib or exotic tokens
            sums = [0.0] * 4
            for cand in cands:
                vals = metrics.nltk_bleu4_method4(refs, cand, weights)
                for w in range(4):
                    sums[w] += vals[w]
        for w in range(4):
            corpus_rows[i, w] = sums[w] / len(cands)
    corpus_rows = sum_tables(corpus_rows, mesh)
    for w in range(4):
        final["Final_Bleu_%d" % (w + 1)] = float(np.mean(corpus_rows[:, w])) if len(img_names) else 0.0
    print(
        "%0.4f test loss, %0.2f time, %.3f Final BLEU1, %.3f Final BLEU2, %.3f Final BLEU3, %.3f Final BLEU4"
        % (
            final["test_loss"],
            time.time() - start_time,
            final["Final_Bleu_1"] * 100.0,
            final["Final_Bleu_2"] * 100.0,
            final["Final_Bleu_3"] * 100.0,
            final["Final_Bleu_4"] * 100.0,
        )
    )
    print("Testing completed.")
    return final
