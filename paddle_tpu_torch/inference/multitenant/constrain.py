"""Constrained decoding: per-request token masks (the port's copy of
paddle_tpu/inference/multitenant/constrain.py, pure numpy).

A request may carry a ``ConstraintState`` whose boolean vocabulary mask
rides the engine's step as one ``[n_rows, vocab]`` operand; the logits of
masked-out tokens drop to -1e30 before the sampler, so greedy and
sampled rows alike emit only legal tokens. Unconstrained rows carry an
all-True mask, which leaves their logits unchanged bit for bit.

Constraints are token-level DFAs (``TokenDfa``): a dense transition
table ``[n_states, vocab]`` with -1 for an illegal token.
``json_schema_dfa`` builds one from a small JSON-schema subset (``enum``,
``const``, ``type: boolean``/``null``, small bounded ``type: integer``
ranges) and the tokenizer's id -> string-piece map, by the token-trie
construction: token t is legal at trie node u iff walking t's piece from
u stays in the trie. A completed value parks in a PAD state that accepts
only ``pad_token``.
"""

from __future__ import annotations

import json

import numpy as np

__all__ = ["ConstraintState", "TokenDfa", "json_schema_dfa"]


class TokenDfa:
    """Dense token-level DFA: ``trans[state, token]`` is the successor
    state or -1 (illegal). Shared, immutable — per-request live state is
    a ``ConstraintState``."""

    def __init__(self, trans: np.ndarray, start: int = 0):
        self.trans = np.asarray(trans, np.int32)
        if self.trans.ndim != 2:
            raise ValueError("trans must be [n_states, vocab]")
        self.start = int(start)
        if not (self.trans[self.start] >= 0).any():
            raise ValueError("start state admits no token")

    @property
    def vocab_size(self) -> int:
        return self.trans.shape[1]

    def fresh(self) -> "ConstraintState":
        return ConstraintState(self)


class ConstraintState:
    """One request's live position in its DFA. ``mask()`` feeds the
    dispatch operand; the engine calls ``advance(tok)`` at harvest for
    every emitted token."""

    def __init__(self, dfa: TokenDfa):
        self.dfa = dfa
        self.state = dfa.start

    def mask(self) -> np.ndarray:
        """Boolean [vocab] legality vector at the current state."""
        return self.dfa.trans[self.state] >= 0

    def advance(self, tok: int) -> None:
        nxt = int(self.dfa.trans[self.state, tok])
        if nxt < 0:
            raise ValueError(
                f"constrained stream emitted illegal token {tok} at "
                f"state {self.state} — the mask was not applied")
        self.state = nxt

    def legal(self, tok: int) -> bool:
        return bool(self.dfa.trans[self.state, tok] >= 0)


def _schema_strings(schema: dict) -> list[str]:
    """The schema's legal surface strings (its rendered JSON values)."""
    if "enum" in schema:
        vals = schema["enum"]
    elif "const" in schema:
        vals = [schema["const"]]
    else:
        ty = schema.get("type")
        if ty == "boolean":
            vals = [True, False]
        elif ty == "null":
            vals = [None]
        elif ty == "integer":
            lo = schema.get("minimum", 0)
            hi = schema.get("maximum", lo + 9)
            if hi - lo > 4096:
                raise ValueError(
                    f"integer range [{lo}, {hi}] too wide to enumerate")
            vals = list(range(int(lo), int(hi) + 1))
        else:
            raise ValueError(
                f"unsupported schema {schema!r} — supply a TokenDfa for "
                "grammars beyond the enum subset")
    out = [v if isinstance(v, str) else json.dumps(v) for v in vals]
    if not out or any(not s for s in out):
        raise ValueError("schema admits an empty value set or string")
    return out


def json_schema_dfa(schema: dict, vocab: list, pad_token: int = 0
                    ) -> TokenDfa:
    """Compile a schema (subset above) to a TokenDfa over a tokenizer's
    ``vocab`` (id -> string piece; ``vocab[pad_token]`` is ignored —
    that id always means padding). Token-trie construction: states are
    character-trie nodes of the legal strings, plus a PAD sink reached
    from every completed value."""
    strings = _schema_strings(schema)
    # character trie: node 0 = root; edges[(node, ch)] -> node
    edges: dict[tuple[int, str], int] = {}
    terminal: set[int] = set()
    n_nodes = 1
    for s in strings:
        u = 0
        for ch in s:
            v = edges.get((u, ch))
            if v is None:
                v = n_nodes
                n_nodes += 1
                edges[(u, ch)] = v
            u = v
        terminal.add(u)
    V = len(vocab)
    pad_state = n_nodes
    trans = np.full((n_nodes + 1, V), -1, np.int32)
    for u in range(n_nodes):
        for t in range(V):
            if t == pad_token:
                continue
            v, ok = u, True
            for ch in vocab[t]:
                v = edges.get((v, ch), -1)
                if v < 0:
                    ok = False
                    break
            if ok and v != u:           # empty pieces cannot stall
                trans[u, t] = v
    for u in terminal:
        trans[u, pad_token] = pad_state
    trans[pad_state, pad_token] = pad_state
    return TokenDfa(trans, start=0)
