"""Stage-Aware Chunk-Level Adaptive Checkpointing — Alg. 2 / Eq. 15-20.

A copy of the JAX package's ``core/checkpointing.py`` (pure Python and NumPy;
same outputs, which ``tests/test_torch_planner.py`` holds equal).

The key structural insight (Fig. 6b): a recompute bubble at (stage p, bwd
slot k) propagates along the schedule anti-diagonal, so checkpointing amounts
may be tied along diagonals without losing anything:

    ckpt'(p, k) = C[(d_p - p) + k']   with  k' = f2b[k]

which shrinks the variable count from ``n * d_p`` to ``n + d_p - 1`` and
makes the pipeline-time penalty exactly ``F_hat * sum(C)`` (Eq. 17): each
diagonal contributes one propagated bubble of F_hat per checkpointed layer.

The ILP (Eq. 20) minimizes ``sum(C)`` subject to every chunks window fitting
in device memory. With Eq. 19's linearization the constraint matrix is
non-negative => an integer covering program handled by ``repro_torch.core.ilp``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .costs import CostModel
from .ilp import IlpResult, solve_cover_ilp
from .plan import Chunk, ModelSpec
from .schedule import enumerate_windows

__all__ = ["CkptSolution", "solve_checkpointing", "diag_index",
           "encoder_stage_split", "stage_roles"]


def diag_index(d_p: int, stage: int, bwd_idx: int) -> int:
    """Index into the diagonal variable vector C (stage is 1-based).

    Eq. 16: ckpt(p, k) = C[f2b[k] + d_p - p]. Range [0, n + d_p - 2].
    """
    return (d_p - stage) + bwd_idx


def encoder_stage_split(n_enc_layers: int, n_dec_layers: int,
                        d_p: int) -> Tuple[int, int]:
    """(enc_stages, dec_stages): pipeline stages holding encoder vs decoder
    layers, proportional to layer counts with both sides >= 1. The single
    source of truth — ``runtime.encdec_pipeline.encdec_stage_split``
    delegates here so the solver's stage roles and the executor's stage
    split can never drift apart."""
    total = max(1, n_enc_layers + n_dec_layers)
    enc_stages = max(1, round(d_p * n_enc_layers / total))
    enc_stages = min(enc_stages, d_p - 1)
    return enc_stages, d_p - enc_stages


def stage_roles(spec: ModelSpec, d_p: int) -> Tuple[str, ...]:
    """Per-stage role vector (1-based stage p at index p-1): ``"encoder"``
    for the leading encoder stages of an enc-dec arch, ``"decoder"``
    everywhere else. This is what makes the checkpointing ILP *stage-aware*
    across heterogeneous stages: encoder stages carry no causal KV (nothing
    un-freeable under Eq. 9), so their per-layer checkpoint saving F and
    base residency I use encoder coefficients."""
    if not spec.is_encoder_decoder or d_p <= 1:
        return ("decoder",) * d_p
    enc_st, dec_st = encoder_stage_split(spec.n_encoder_layers,
                                         spec.n_layers, d_p)
    return ("encoder",) * enc_st + ("decoder",) * dec_st


@dataclass
class CkptSolution:
    status: str                      # "optimal" | "feasible" | "infeasible"
    diag: List[int]                  # C, length n + d_p - 1
    table: List[List[int]]           # ckpt[p-1][k] per (stage, fwd chunk idx)
    recompute_time: float            # Eq. 17 pipeline-time penalty
    ilp: Optional[IlpResult] = None
    roles: Optional[Tuple[str, ...]] = None  # per-stage role vector, if any

    @property
    def total_layers(self) -> int:
        return int(sum(self.diag))

    def as_matrix(self) -> np.ndarray:
        """The per-(stage, chunk) layer-count matrix, shape (d_p, n) — the
        first-class artifact the executor consumes (rows = stages, columns
        = forward chunk indices)."""
        if not self.table:
            return np.zeros((0, 0), dtype=np.int64)
        return np.asarray(self.table, dtype=np.int64)

    def per_stage_max(self) -> List[int]:
        """Max remat depth each stage ever applies (one entry per stage) —
        the single-pipeline counterpart of
        ``ExecutionPlan.ckpt_per_stage_max()``."""
        return [int(max(row)) if row else 0 for row in self.table]


def _coefficients(cm: CostModel, chunks: Sequence[Chunk],
                  role: str = "decoder", layers: Optional[int] = None
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Alg. 2 lines 1-3: per-chunk I (base bytes) and F (bytes freed per
    checkpointed layer); plus the last-stage logits add-on.

    ``role`` selects the stage-aware coefficient set (Eq. 9-11): decoder
    stages pay the un-freeable dependent-KV residency and recover less per
    checkpointed layer (the layer input AND its KV must persist); encoder
    stages are non-causal — no context carry, no dependent KV — so every
    checkpointed layer frees the full per-layer activation slab. ``layers``
    is the layer count of that role's path (the per-layer slab is
    ``m_token / layers``): encoder stacks with ``n_encoder_layers !=
    n_layers`` free a different slab per layer than decoder stacks.
    """
    m, co, cl = cm.model, cm.coeffs, cm.cluster
    n_lay = layers if layers else m.n_layers
    n = len(chunks)
    I = np.zeros(n)
    F = np.zeros(n)
    logits = np.zeros(n)
    e = m.bytes_per_act
    repl = cm.kv_replication
    for k, c in enumerate(chunks):
        toks = c.tokens
        dep = 1.0 if (c.has_dependents and role == "decoder") else 0.0
        kv_keep = 2.0 * dep * repl * m.d_kv
        I[k] = (co.m_token / cl.n_devices
                + dep * repl * 2.0 * e * m.n_layers * m.d_kv / cl.n_devices) * toks
        per_layer_saving = (co.m_token / (n_lay * cl.d_s)
                            - e * (m.d_model + kv_keep) / cl.d_s)
        F[k] = max(0.0, per_layer_saving) * toks
        logits[k] = co.m_logits / cl.d_s * toks
    return I, F, logits


def solve_checkpointing(cm: CostModel, chunks: Sequence[Chunk],
                        f2b: Sequence[int], n_split: int, *,
                        capacity: Optional[float] = None,
                        gap: float = 0.02,
                        f_hat: Optional[float] = None,
                        max_windows_per_stage: int = 64,
                        roles: Optional[Sequence[str]] = None
                        ) -> CkptSolution:
    """Solve Eq. 20 for one 1F1B pipeline.

    ``capacity`` defaults to the cluster's usable HBM (G). ``f_hat`` is the
    per-layer forward time of a balanced chunk (Eq. 17); derived from the
    pipeline's actual chunks when not supplied. ``roles`` (optional,
    one entry per stage — see :func:`stage_roles`) switches each stage's
    memory coefficients between the encoder and decoder sets, letting the
    ILP hand encoder and decoder stages *different* checkpoint depths; the
    default is all-decoder, which reproduces the role-free problem exactly.
    """
    m, cl = cm.model, cm.cluster
    n = len(chunks)
    d_p = cl.d_p
    if roles is not None and len(roles) != d_p:
        raise ValueError(f"roles must have one entry per stage "
                         f"({d_p}), got {len(roles)}")
    if n == 0:
        return CkptSolution("optimal", [], [], 0.0,
                            roles=tuple(roles) if roles else None)
    G = capacity if capacity is not None else cl.capacity_bytes
    n_vars = n + d_p - 1
    # per-stage layer capacity: without roles the classic uniform bound;
    # with roles, encoder stages hold ceil(n_enc / enc_stages) layers and
    # decoder stages ceil(n_dec / dec_stages) — the executor's actual
    # split — so the ILP never certifies a depth a stage cannot realize
    if roles is None or "encoder" not in roles:
        stage_cap = [max(1, m.n_layers // d_p)] * d_p
        n_enc_layers = m.n_layers
    else:
        enc_st = sum(1 for r in roles if r == "encoder")
        dec_st = max(1, d_p - enc_st)
        n_enc_layers = m.n_encoder_layers if m.n_encoder_layers > 0 \
            else m.n_layers
        cap_enc = max(1, -(-n_enc_layers // max(enc_st, 1)))
        cap_dec = max(1, -(-m.n_layers // dec_st))
        stage_cap = [cap_enc if r == "encoder" else cap_dec for r in roles]

    coeff = {"decoder": _coefficients(cm, chunks, "decoder")}
    if roles is not None and "encoder" in roles:
        coeff["encoder"] = _coefficients(cm, chunks, "encoder",
                                         layers=n_enc_layers)
    windows = enumerate_windows(n, d_p, n_split, f2b)

    rows: List[np.ndarray] = []
    rhs: List[float] = []
    for p in range(1, d_p + 1):
        role = roles[p - 1] if roles is not None else "decoder"
        I, F, logits = coeff[role]
        budget = G - cm.m_model_states(p)
        stage_rows: List[Tuple[float, np.ndarray]] = []
        for w in windows[p - 1]:
            base = 0.0
            row = np.zeros(n_vars)
            for k in w:
                base += I[k] + (logits[k] if p == d_p else 0.0)
                row[diag_index(d_p, p, f2b[k])] += F[k]
            need = base - budget
            if need > 0:
                stage_rows.append((need, row))
        # Large pipelines produce hundreds of near-identical steady-state
        # windows; keep the tightest (largest residual-need) ones. The chunks
        # are workload-balanced by construction, so the binding constraints
        # are among the deepest windows.
        if len(stage_rows) > max_windows_per_stage:
            stage_rows.sort(key=lambda t: -t[0])
            stage_rows = stage_rows[:max_windows_per_stage]
        for need, row in stage_rows:
            rows.append(row)
            rhs.append(need)

    rtup = tuple(roles) if roles is not None else None
    # the diagonal tying (Eq. 16) shares one variable across several
    # (stage, chunk) cells, so each variable's bound is the TIGHTEST layer
    # capacity among the stages it serves (uniform-capacity case reduces
    # to the classic single bound)
    ub = np.full(n_vars, float(max(stage_cap)))
    for p in range(1, d_p + 1):
        capv = float(stage_cap[p - 1])
        for k in range(n):
            j = diag_index(d_p, p, f2b[k])
            if capv < ub[j]:
                ub[j] = capv
    if not rows:
        diag = [0] * n_vars
        table = [[0] * n for _ in range(d_p)]
        return CkptSolution("optimal", diag, table, 0.0, roles=rtup)

    res = solve_cover_ilp(np.vstack(rows), np.asarray(rhs), ub, gap=gap)
    if res.status == "infeasible" or res.x is None:
        return CkptSolution("infeasible", [], [], math.inf, ilp=res,
                            roles=rtup)

    diag = [int(round(v)) for v in res.x]
    table = [[0] * n for _ in range(d_p)]
    for p in range(1, d_p + 1):
        for k in range(n):
            table[p - 1][k] = diag[diag_index(d_p, p, f2b[k])]

    if f_hat is None:
        avg_fwd = sum(cm.t_tot(c) for c in chunks) / n
        f_hat = avg_fwd / m.n_layers
    recompute = f_hat * sum(diag)
    return CkptSolution(res.status, diag, table, recompute, ilp=res,
                        roles=rtup)
