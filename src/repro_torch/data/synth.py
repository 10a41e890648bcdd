"""Synthetic variable-length corpora with the skewed length distributions of
Fig. 1(b).

Presets mimic the paper's two datasets: most sequences short, a heavy
lognormal tail ("github" is more skewed than "commoncrawl"); a configurable
fraction of max-length sequences models LLaMA-3-style long-context mixing
(0.1% long documents).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

__all__ = ["LengthDistribution", "PRESETS", "sample_lengths",
           "sample_corpus_batch", "sample_request_trace"]


@dataclass(frozen=True)
class LengthDistribution:
    name: str
    log_mu: float
    log_sigma: float
    min_len: int = 64
    long_frac: float = 0.002      # fraction pinned to the context limit


PRESETS: Dict[str, LengthDistribution] = {
    # GitHub: median ~2K, <0.6% above 64K (paper Fig. 1b)
    "github": LengthDistribution("github", log_mu=7.6, log_sigma=1.35,
                                 long_frac=0.004),
    # CommonCrawl: shorter documents, lighter tail
    "commoncrawl": LengthDistribution("commoncrawl", log_mu=6.9,
                                      log_sigma=1.1, long_frac=0.002),
    "uniform": LengthDistribution("uniform", log_mu=0.0, log_sigma=0.0),
}


def sample_lengths(preset: str, n: int, context_limit: int,
                   seed: int = 0) -> List[int]:
    dist = PRESETS[preset]
    rng = np.random.default_rng(seed)
    if dist.log_sigma == 0.0:      # uniform: everything at the limit
        return [context_limit] * n
    lens = rng.lognormal(dist.log_mu, dist.log_sigma, n)
    lens = np.clip(lens.astype(np.int64), dist.min_len, context_limit)
    n_long = max(1, int(round(dist.long_frac * n)))
    idx = rng.choice(n, n_long, replace=False)
    lens[idx] = context_limit
    return [int(x) for x in lens]


def sample_request_trace(preset: str, n: int, context_limit: int,
                         vocab: int, *, seed: int = 0,
                         arrival_rate: float = 1.0,
                         max_new_tokens: int = 16,
                         system_prompt_len: int = 0
                         ) -> List[Dict[str, object]]:
    """Synthetic serving trace: Poisson arrivals (exponential inter-arrival
    gaps at ``arrival_rate`` requests per simulated second) over the same
    skewed lognormal prompt-length presets the trainer uses — serving
    request lengths are even more skewed than training documents, which is
    exactly the regime chunked prefill exists for. Deterministic per seed,
    so two passes over one trace are identical (the engine's zero-recompile
    check relies on this).

    ``system_prompt_len`` > 0 prepends the SAME ``system_prompt_len``-token
    prefix (drawn once) to every prompt — the shared-system-prompt regime
    the engine's content-addressed prefix cache exists for. Per-request
    lengths (prefix + unique tail) still follow the preset, floored at
    ``system_prompt_len + 1`` so every request keeps a unique tail.

    Returns ``[{"arrival", "prompt", "max_new_tokens"}, ...]`` sorted by
    arrival; the driver wraps them into ``serve.engine.Request`` objects.
    """
    lengths = sample_lengths(preset, n, context_limit, seed)
    rng = np.random.default_rng(seed + 2)
    gaps = rng.exponential(1.0 / max(arrival_rate, 1e-9), n)
    arrivals = np.cumsum(gaps)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    sys_prompt = None
    if system_prompt_len > 0:
        if system_prompt_len >= context_limit:
            raise ValueError(
                f"system_prompt_len={system_prompt_len} must leave room "
                f"for a unique tail under context_limit={context_limit}")
        sys_prompt = rng.choice(vocab, size=system_prompt_len,
                                p=probs).astype(np.int32)
    out = []
    for i, ln in enumerate(lengths):
        if sys_prompt is None:
            prompt = rng.choice(vocab, size=ln, p=probs).astype(np.int32)
        else:
            tail = max(1, ln - system_prompt_len)
            prompt = np.concatenate([
                sys_prompt,
                rng.choice(vocab, size=tail, p=probs).astype(np.int32)])
        out.append({
            "arrival": float(arrivals[i]),
            "prompt": prompt,
            "max_new_tokens": int(max_new_tokens),
        })
    return out


def sample_corpus_batch(preset: str, n: int, context_limit: int, vocab: int,
                        seed: int = 0) -> Dict[int, np.ndarray]:
    """{seq_id: token array} for a global batch. Tokens are drawn from a
    Zipf-ish distribution so the CE loss has learnable structure."""
    lengths = sample_lengths(preset, n, context_limit, seed)
    rng = np.random.default_rng(seed + 1)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    return {
        i: rng.choice(vocab, size=ln, p=probs).astype(np.int32)
        for i, ln in enumerate(lengths)
    }
