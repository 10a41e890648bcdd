"""Self-speculative decode streams: draft proposal + greedy verification.

Each decode tick carries ``k`` tokens per stream through the pipeline: the
last accepted token plus ``k - 1`` *draft* tokens. The engine step returns
the model's greedy id after every fed position, and :func:`verify_greedy`
accepts the longest draft prefix the model agrees with. For greedy
decoding this is **exact**: the emitted stream is bitwise the k=1 greedy
stream no matter how bad the draft is — draft quality only changes how
many tokens each tick advances (``SpecStats.acceptance_rate``), never
which tokens come out (tests/test_serve_engine.py asserts k=2 == k=1).

The draft itself is prompt-lookup style self-drafting (no draft model): the
longest recent n-gram suffix of the request's history is searched for an
earlier occurrence and its continuation proposed, falling back to repeating
the last token. Rows written for rejected drafts sit at positions beyond
the stream's committed length, so they are masked out of attention and
overwritten by the next tick — no cache cleanup step exists or is needed.
Under the paged pool the engine additionally caps the draft length to the
tokens the request can still emit (``min(k-1, max_new - emitted - 1)``):
a doomed draft would both skew ``acceptance_rate`` downward and write KV
rows past the request's own page table (the device trash-guards such
writes, but the host never plans them). Rejected-draft rows are never
*published*: the prefix cache only indexes pages whose every row is
committed, so sharing cannot observe draft garbage.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

__all__ = ["SpecStats", "propose_draft", "verify_greedy"]


@dataclass
class SpecStats:
    decode_ticks: int = 0
    drafted: int = 0         # draft tokens proposed (k - 1 per tick)
    accepted: int = 0        # draft tokens the model agreed with
    emitted: int = 0         # tokens emitted by decode ticks (>= ticks)

    @property
    def acceptance_rate(self) -> float:
        if not self.drafted:
            return 0.0
        return self.accepted / self.drafted

    @property
    def tokens_per_tick(self) -> float:
        if not self.decode_ticks:
            return 0.0
        return self.emitted / self.decode_ticks

    def as_dict(self) -> Dict[str, float]:
        return {
            "decode_ticks": self.decode_ticks,
            "drafted": self.drafted,
            "accepted": self.accepted,
            "emitted": self.emitted,
            "acceptance_rate": round(self.acceptance_rate, 4),
            "tokens_per_tick": round(self.tokens_per_tick, 4),
        }


def propose_draft(history: Sequence[int], n: int, *,
                  ngram: int = 3) -> List[int]:
    """Propose ``n`` draft tokens from ``history`` (prompt + emitted so
    far). Tries the longest suffix n-gram (length ``ngram`` down to 1),
    takes the continuation of its most recent earlier occurrence, and pads
    by repeating the last proposed (or last history) token. Pure host-side
    — the device never sees whether a token was drafted or real."""
    if n <= 0:
        return []
    h = [int(t) for t in history]
    draft: List[int] = []
    for g in range(min(ngram, len(h)), 0, -1):
        key = h[-g:]
        # most recent earlier occurrence whose continuation exists
        for i in range(len(h) - g - 1, -1, -1):
            if h[i:i + g] == key:
                draft = h[i + g:i + g + n]
                break
        if draft:
            break
    last = draft[-1] if draft else (h[-1] if h else 0)
    while len(draft) < n:
        draft.append(last)
    return draft[:n]


def verify_greedy(fed_tokens: Sequence[int], out_ids: Sequence[int]
                  ) -> List[int]:
    """Greedy acceptance rule. ``fed_tokens = [t0, d1, .., d_{k-1}]`` were
    fed this tick (t0 = last accepted token, d_i = drafts); ``out_ids[i]``
    is the model's greedy id after consuming ``fed_tokens[:i + 1]``. Draft
    ``d_i`` is accepted iff it equals ``out_ids[i - 1]`` — i.e. iff greedy
    decode would have produced it — scanning left to right and stopping at
    the first disagreement. Returns the emitted tokens
    ``out_ids[0 .. n_accepted]`` (always at least one: the k=1 behavior)."""
    k = len(fed_tokens)
    if k == 0 or len(out_ids) < k:
        raise ValueError(f"need >= {k} output ids, got {len(out_ids)}")
    a = 0
    while a < k - 1 and int(fed_tokens[a + 1]) == int(out_ids[a]):
        a += 1
    return [int(x) for x in out_ids[:a + 1]]
