"""Generic callback-driven beam search utility (the port's own copy of
show_tell_tpu/decode/generic.py, numpy only).

API parity with the reference's standalone beam_search.py:45-97 (a
textbook hypothesis-tree beam over ``initial_state_function`` /
``generate_function`` callbacks, cumulative -log p costs, end-token
hypothesis retirement, length cap) — the module the reference ships but
never imports (SURVEY.md §2.12).  Useful for decoding arbitrary models
(host-side; for the compiled batched beam see decode/beam.py).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np


class Node:
    """One hypothesis in the beam tree (reference beam_search.py:18-43)."""

    def __init__(self, parent: Optional["Node"], state, value, cost: float, extras=None):
        self.value = value
        self.parent = parent
        self.state = state
        self.cum_cost = (parent.cum_cost if parent else 0.0) + cost
        self.length = 1 if parent is None else parent.length + 1
        self.extras = extras
        self._sequence: Optional[List["Node"]] = None

    def to_sequence(self) -> List["Node"]:
        if self._sequence is None:
            self._sequence = []
            current = self
            while current:
                self._sequence.insert(0, current)
                current = current.parent
        return self._sequence

    def to_sequence_of_values(self):
        return [n.value for n in self.to_sequence()]

    def to_sequence_of_extras(self):
        return [n.extras for n in self.to_sequence()]


def beam_search(
    initial_state_function: Callable,
    generate_function: Callable,
    X,
    start_id,
    end_id,
    beam_width: int = 4,
    num_hypotheses: int = 1,
    max_length: int = 50,
) -> List[List]:
    """Beam search over callbacks.

    initial_state_function(X) -> state;
    generate_function(prev_state, prev_value) -> (next_values_probs [V],
    next_state); returns ``num_hypotheses`` id sequences, best first,
    ranked by raw cumulative -log p (reference beam_search.py:96 — no
    length normalization); hypotheses emitting ``end_id`` retire.

    Matches reference beam_search.py:45-97 semantics exactly: per-node
    top-``beam_width`` expansion, global keep-``beam_width`` by cum_cost
    each step, and final ranking over *retired* hypotheses only.  One
    documented extension: if ``max_length`` is hit before any hypothesis
    retires, the reference returns an empty list; we fall back to the
    surviving fringe (still cum_cost-ranked) so callers always get output.
    """
    next_fringe = [Node(parent=None, state=initial_state_function(X), value=start_id, cost=0.0)]
    hypotheses: List[Node] = []

    for _ in range(max_length):
        fringe = [n for n in next_fringe if n.value != end_id]
        for n in next_fringe:
            if n.value == end_id:
                hypotheses.append(n)
        if not fringe:
            break

        next_fringe = []
        candidates: List[Node] = []
        for n in fringe:
            probs, new_state = generate_function(n.state, n.value)
            probs = np.asarray(probs, dtype=np.float64)
            costs = -np.log(np.maximum(probs, 1e-300))
            for idx in np.argsort(costs)[:beam_width]:
                candidates.append(Node(parent=n, state=new_state, value=int(idx), cost=float(costs[idx])))
        candidates.sort(key=lambda n: n.cum_cost)
        next_fringe = candidates[:beam_width]

    if not hypotheses:  # extension: ref returns [] when nothing retired
        hypotheses = list(next_fringe)
    hypotheses.sort(key=lambda n: n.cum_cost)
    return [h.to_sequence_of_values() for h in hypotheses[:num_hypotheses]]
