"""Bit-faithful reproduction of the reference's in-class beam search
(rnn.py:60-108) for parity runs (--faithful_beam, batch=1, GRU only);
the counterpart of show_tell_tpu/decode/faithful_beam.py.

The reference beam has three quirks (SURVEY.md §3.3) that this module
reproduces deliberately — they are *behavior*, not bugs to fix here:
  1. candidates are ranked by the LAST-STEP RAW LOGIT only, not the
     cumulative log-probability (rnn.py:102-103);
  2. a single shared hidden state is overwritten inside the beam loop —
     beam k consumes the state left by beam k-1 (rnn.py:87);
  3. <end> never retires a hypothesis.

A step is the plain stack step (``ops.rnn.gru_stack_plain``) and the f32
projection (``ops.vocab.project_logits``) on the features' device: the JAX
package's step is XLA with no Pallas kernel.  On a GPU it runs with TF32
off (``exact_f32_math``).  The loop itself is on the host, as the
reference's is (it reads every step's logits back), with the same numpy
``argsort`` and stable ``sorted`` as the JAX package.  The batched beam
lives in ``decode/beam.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from show_tell_tpu_torch.models.decoder import DecoderConfig


def faithful_beam_decode(
    prepared: Dict[str, object],  # ops.rnn.prepare_greedy output (models.captioner.prepare_decode)
    cfg: DecoderConfig,
    cnn_feature: torch.Tensor,  # [1, E]
    beam_size: int,
    gaps: Optional[List[float]] = None,
) -> np.ndarray:
    """Returns token ids [25] (batch of one, like rnn.py:106-108).

    gaps: a list that gets, at each ranking (the first step's top-K, each
    beam's top-K, each step's K best candidates), the smallest difference
    between neighbours among the K+1 largest values (a diagnostic: the
    places where another summation order may rank differently)."""
    from show_tell_tpu_torch.models.captioner import exact_f32_math
    from show_tell_tpu_torch.models.rnn_cells import init_state
    from show_tell_tpu_torch.ops.rnn import gru_stack_plain
    from show_tell_tpu_torch.ops.vocab import project_logits

    if cfg.cell_type != "gru":
        raise ValueError("faithful beam exists only for the GRU model (reference rnn.py)")
    if cnn_feature.shape[0] != 1:
        raise ValueError("reference beam works only with batch_size=1 (main.py:81-82)")
    K = beam_size
    T = cfg.max_caption_length
    stacked, vocab, embedding = prepared["stacked"], prepared["vocab"], prepared["embedding"]
    device = cnn_feature.device

    def step(x, hs):
        top, hs2 = gru_stack_plain(stacked, x, hs)
        return project_logits(vocab, top)[0].cpu().numpy(), hs2

    def note(values):
        if gaps is not None and len(values) > 1:
            best = np.sort(np.asarray(values, np.float64))[::-1][: K + 1]
            gaps.append(float(np.min(best[:-1] - best[1:])))

    with torch.no_grad(), exact_f32_math(device):
        hs = init_state("gru", cfg.num_layers, 1, cfg.hidden_dim, embedding.dtype, device)
        logits, hs = step(cnn_feature.to(embedding.dtype), hs)
        top0 = np.argsort(-logits)[:K]
        note(logits)

        beam_words = [int(w) for w in top0]
        beam_sents = [[int(w)] for w in top0]

        idx = 1
        while idx < T:
            idx += 1
            cand_sents, cand_words, cand_probs = [], [], []
            for k in range(K):
                x = embedding[beam_words[k]][None]
                lg, hs = step(x, hs)  # shared hidden state (quirk 2)
                topj = np.argsort(-lg)[:K]
                note(lg)
                for j in topj:
                    cand_sents.append(beam_sents[k] + [int(j)])
                    cand_words.append(int(j))
                    cand_probs.append(float(lg[j]))  # raw last-step logit (quirk 1)
            order = sorted(range(len(cand_probs)), key=lambda i: -cand_probs[i])[:K]
            note(cand_probs)
            beam_sents = [cand_sents[i] for i in order]
            beam_words = [cand_words[i] for i in order]

    return np.asarray(beam_sents[0], dtype=np.int32)
