"""Self-drafting speculative proposer: prompt-lookup n-gram matching
(the port's copy of paddle_tpu/inference/speculative.py).

Drafts come from the request's own token history (prompt + generated),
so there is no draft model. The engine verifies up to k drafts per
decode row as one (k+1)-token chunk of the unified step and keeps a
draft only if it equals the model's pick at its position, so the
accepted stream equals the non-speculative stream whatever the hit rate.
"""

from __future__ import annotations

from typing import List, Sequence

__all__ = ["NgramProposer"]


class NgramProposer:
    """Longest-suffix n-gram lookup over a token history.

    ``propose`` finds the most recent earlier occurrence of the
    history's trailing n-gram, n = max_ngram down to 1, and returns up to
    k tokens that followed it. Deterministic."""

    def __init__(self, max_ngram: int = 3):
        if max_ngram < 1:
            raise ValueError("max_ngram must be >= 1")
        self.max_ngram = max_ngram

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        h = list(history)
        if k <= 0 or len(h) < 2:
            return []
        for n in range(min(self.max_ngram, len(h) - 1), 0, -1):
            tail = h[-n:]
            # the match must end before the last position, so that at
            # least one token follows it
            for start in range(len(h) - n - 1, -1, -1):
                if h[start:start + n] == tail:
                    follow = h[start + n:start + n + k]
                    if follow:
                        return follow
        return []
