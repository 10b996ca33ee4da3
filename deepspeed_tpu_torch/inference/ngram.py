"""N-gram (self-drafting) proposals for speculative decoding (counterpart of
``deepspeed_tpu/inference/ngram.py``, this package's own copy).

The draft-free mode of the speculative pooled tick
(``decoding.compile_spec_pool_tick_fn``, ngram variant): proposals come from
the request's OWN token history. The longest recent n-gram whose suffix
matches the context tail is found, and the tokens that followed it are
proposed. Pure numpy on host state the scheduler already holds, so drafting
costs no device work and no second model.

Losslessness does not depend on proposal quality: an n-gram proposal is a
point mass q = δ(d), for which the accept rule becomes ``u < p(d)`` and the
residual p with d's mass removed, so any proposal stream yields exactly the
target distribution (greedy: exactly the argmax chain). Under dispatch-ahead
pipelining the host context lags the device by up to ``pipeline_depth``
rounds; that only lowers the acceptance rate.
"""

from typing import Optional

import numpy as np


def propose(context, gamma: int, max_order: int = 3) -> np.ndarray:
    """``gamma`` proposed next tokens for one row given its token
    ``context`` (prompt + emitted so far, 1-D int array-like).

    Longest-suffix match: for order n = ``max_order``..1, find the most
    recent earlier occurrence of the context's last n tokens; the tokens
    that followed it are the proposal, extended greedily (the matched
    continuation may itself recur). Falls back to repeating the last
    token."""
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    ctx = np.asarray(context, np.int32).reshape(-1)
    out = np.empty(gamma, np.int32)
    fill = ctx[-1] if ctx.size else 0
    start = _match_start(ctx, max_order)
    for i in range(gamma):
        if start is not None and start < ctx.size:
            out[i] = fill = ctx[start]
            start += 1
        else:
            out[i] = fill
    return out


def _match_start(ctx: np.ndarray, max_order: int) -> Optional[int]:
    """Index right after the most recent earlier occurrence of the longest
    matching context suffix (highest order wins; ties to recency), or None
    when nothing matches. Vectorized over the candidate windows: it runs for
    every active row on every serving tick."""
    m = ctx.size
    for n in range(min(max_order, m - 1), 0, -1):
        tail = ctx[m - n:]
        # windows ctx[j:j+n] for j <= m-n-1 (ending before the tail itself);
        # one vectorized compare, the most recent hit wins
        wins = np.lib.stride_tricks.sliding_window_view(ctx[:m - 1], n)
        hits = np.flatnonzero((wins == tail).all(axis=1))
        if hits.size:
            return int(hits[-1]) + n
    return None


def propose_rows(contexts, gamma: int, max_order: int = 3) -> np.ndarray:
    """(B, gamma) int32 proposals for a batch of per-row contexts (a list of
    1-D arrays; rows may differ in length). Rows with an empty context
    propose zeros."""
    return np.stack([propose(c, gamma, max_order) for c in contexts])
