"""Sequence-parallel (context-parallel) policy: the single source of truth.

A copy of the JAX package's ``core/sp.py`` (pure Python and NumPy;
same outputs, which ``tests/test_torch_planner.py`` holds equal).

The SP axis is a *plan* axis, not a cluster constant: every
``ExecutionPlan`` carries an :class:`SPConfig` — a policy name plus an
effective degree ``d_s_eff <= d_s`` realized as sub-groups of the "model"
mesh axis — chosen by the planner jointly with chunking and
checkpointing. This module is the one definition of legality and the
default heuristic; both the cost model (``core/costs.py``) and the
runtime (``runtime/sp.py``) delegate here so they can never diverge
(tests/test_sp_policy.py pins it).

Pure Python — no torch — like the rest of ``repro_torch.core``, so planning runs
on CPU hosts that never initialize a device runtime.

Policy semantics (the runtime collectives live in ``runtime/sp.py``):

``none``
    No sequence sharding inside a chunk: every model-axis device in an
    SP sub-group of size 1 computes the full chunk. Legal for any model
    at ``d_s_eff == 1``, and for attention-free (pure-SSM) models at any
    degree (the SSM scan shards tokens without attention collectives).
``ulysses``
    Head-wise all-to-all: q/k/v redistribute from token-sharded to
    head-sharded (4 a2a per layer), context is HEAD-sharded. Requires
    ``n_heads % d == 0 and n_kv_heads % d == 0``; illegal for MLA
    (the latent cache has one logical head) and attention-free models.
``allgather_kv``
    Keys/values of the current chunk are all-gathered per layer;
    context is REPLICATED across the sub-group. Legal for any head
    count; the MLA latent cache prefers it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["SP_POLICIES", "SPConfig", "choose_sp_policy", "sp_legal",
           "legal_degrees", "sp_candidates"]

SP_POLICIES: Tuple[str, ...] = ("none", "ulysses", "allgather_kv")


@dataclass(frozen=True)
class SPConfig:
    """One plan's sequence-parallel configuration.

    ``d_s_eff`` is the token-sharding degree of a chunk's sequence axis.
    It must divide the mesh's model-axis size ``d_s``; for
    ``d_s_eff < d_s`` the runtime forms ``d_s_eff`` sub-groups of the
    model axis (stride ``r = d_s // d_s_eff``) and replicates chunk
    compute ``r`` times — parameters and the vocab axis stay sharded
    over the FULL model axis regardless.
    """

    policy: str
    d_s_eff: int

    def __post_init__(self) -> None:
        if self.policy not in SP_POLICIES:
            raise ValueError(f"unknown SP policy {self.policy!r}; "
                             f"expected one of {SP_POLICIES}")
        if self.d_s_eff < 1:
            raise ValueError(f"d_s_eff must be >= 1, got {self.d_s_eff}")

    def to_json(self) -> Dict[str, Any]:
        return {"policy": self.policy, "d_s_eff": self.d_s_eff}

    @staticmethod
    def from_json(d: Optional[Dict[str, Any]]) -> Optional["SPConfig"]:
        if d is None:
            return None
        return SPConfig(policy=d["policy"], d_s_eff=int(d["d_s_eff"]))


def choose_sp_policy(spec, d: int) -> str:
    """Default SP policy for ``spec`` at effective degree ``d``.

    This is the ONE heuristic — ``runtime/sp.choose_policy`` and the
    cost model's ``"auto"`` resolution both call it:

    * attention-free (pure SSM): ``none`` — the distributed scan shards
      tokens with no attention collective at all;
    * ``d <= 1``: ``none`` — a sub-group of one device needs no policy;
    * MLA (``kv_lora_rank > 0``): ``allgather_kv`` — the latent cache
      has one logical head, so Ulysses cannot shard it;
    * heads divisible by ``d``: ``ulysses`` (4 small a2a beat gathering
      replicated KV, and context stays head-sharded);
    * otherwise: ``allgather_kv`` (legal for any head count).
    """
    if spec.attn_free:
        return "none"
    if d <= 1:
        return "none"
    if spec.kv_lora_rank > 0:
        return "allgather_kv"
    if spec.n_heads % d == 0 and spec.n_kv_heads % d == 0:
        return "ulysses"
    return "allgather_kv"


def sp_legal(spec, policy: str, d: int) -> bool:
    """Can ``policy`` run for ``spec`` at effective degree ``d``?"""
    if policy not in SP_POLICIES:
        return False
    if d < 1:
        return False
    if spec.attn_free:
        # pure-SSM models have no attention to shard; only "none" makes
        # sense (the SSM scan handles token sharding at any degree)
        return policy == "none"
    if policy == "none":
        # with attention present, "none" means each sub-group device
        # holds the whole chunk — only meaningful (and only correct) at
        # degree 1
        return d == 1
    if d == 1:
        return False  # a degree-1 sub-group must use "none"
    if policy == "ulysses":
        if spec.kv_lora_rank > 0:
            return False  # MLA latent cache: one logical head
        return spec.n_heads % d == 0 and spec.n_kv_heads % d == 0
    return True  # allgather_kv: any head count


def legal_degrees(spec, d_s: int) -> List[int]:
    """Divisors of ``d_s`` (descending) with at least one legal policy."""
    degs = [d for d in range(d_s, 0, -1) if d_s % d == 0]
    return [d for d in degs
            if any(sp_legal(spec, p, d) for p in SP_POLICIES)]


def sp_candidates(spec, d_s: int) -> List[SPConfig]:
    """Every legal ``(policy, d_s_eff)`` pair the planner may choose,
    default-policy-first per degree, degrees descending."""
    out: List[SPConfig] = []
    for d in legal_degrees(spec, d_s):
        default = choose_sp_policy(spec, d)
        for policy in (default,) + tuple(p for p in SP_POLICIES
                                         if p != default):
            if sp_legal(spec, policy, d):
                out.append(SPConfig(policy=policy, d_s_eff=d))
    return out
