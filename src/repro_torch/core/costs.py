"""InfiniPipe cost model (paper §III-A, Eq. 1-11): a copy of the JAX
package's ``core/costs.py``, with the inter-card link named ``link_bw``.

The model estimates, for every chunk ``{C_k, S_k}``:

* compute time (Eq. 1)  — quadratic causal-attention term + linear term,
* SP communication time (Eq. 2-3) — Ulysses all-to-all *or* allgather-KV,
* stage-aware activation memory (Eq. 5-10) including the split-chunk dKV
  term and the chunks-window peak model,
* gradient-checkpointing recompute time (Eq. 11).

Coefficients are derived *analytically* from the architecture + hardware
specs (so the model works out of the box for any of the ten assigned
architectures), and can be *refined by regression* against measured samples
via :func:`fit_coefficients` — mirroring the paper's "built at a theoretical
standpoint, verified and refined via offline profiling and regression
fitting".

Conventions
-----------
* All times are seconds for the *whole model* pass of one chunk divided
  across the cluster exactly as Eq. 1 does: the ``1/N`` factor (``N = d_s *
  d_p``) is applied inside, the ``beta1 / d_p`` per-stage overhead added.
* ``per_stage=True`` variants return the time one pipeline stage spends on
  the chunk (the quantity a tick of the 1F1B schedule costs) — i.e. the
  whole-model time divided by ``d_p`` (stages are layer-uniform).
* Backward compute is modelled as ``bwd_mult``x forward (2.0: dgrad+wgrad).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .plan import Chunk, ClusterSpec, Coefficients, ModelSpec
from .sp import choose_sp_policy, sp_legal

__all__ = ["CostModel", "fit_coefficients", "analytic_coefficients"]

BWD_MULT = 2.0  # backward flops / forward flops


# ---------------------------------------------------------------------------
# Analytic coefficient derivation.
# ---------------------------------------------------------------------------

def _linear_flops_per_token(m: ModelSpec) -> float:
    """Forward FLOPs per token that do NOT depend on context length.

    Counts every matmul 2*MAC. Attention score/AV flops are excluded — they
    form the quadratic term. Vocabulary head included (it runs once, on the
    last stage, but Eq. 1's alpha2 is a whole-model constant).
    """
    D, Dh, Hq, Hkv = m.d_model, m.head_dim, m.n_heads, m.n_kv_heads
    per_layer = 0.0
    if not m.attn_free:
        if m.kv_lora_rank > 0:
            r, rr = m.kv_lora_rank, m.qk_rope_dim
            per_layer += 2 * D * (Hq * (Dh + rr))        # q
            per_layer += 2 * D * (r + rr)                # kv down-proj
            per_layer += 2 * r * (Hq * Dh * 2)           # k/v up-proj
            per_layer += 2 * Hq * Dh * D                 # o
        else:
            per_layer += 2 * D * Hq * Dh                 # q
            per_layer += 2 * 2 * D * Hkv * Dh            # k, v
            per_layer += 2 * Hq * Dh * D                 # o
    if m.ssm_state > 0:
        di, ds = m.inner, m.ssm_state
        per_layer += 2 * D * 2 * di                      # in-proj (x, z)
        per_layer += 2 * m.ssm_conv * di                 # depthwise conv
        per_layer += 2 * di * (2 * ds + 2)               # B, C, dt projections
        per_layer += 9 * di * ds                         # selective scan update
        per_layer += 2 * di * D                          # out-proj
    if m.n_experts > 0:
        per_layer += 2 * D * m.n_experts                 # router
        act = m.top_k + m.n_shared_experts
        per_layer += 2 * 3 * D * m.d_ff_expert * act     # routed+shared SwiGLU
    elif m.d_ff > 0:
        per_layer += 2 * 3 * D * m.d_ff                  # dense SwiGLU
    total = m.n_layers * per_layer
    total += 2 * D * m.vocab                             # LM head (last stage)
    return total


def _attn_flops_per_token_pair(m: ModelSpec) -> float:
    """Forward FLOPs per (query-token, key-position) pair, whole model.

    QK^T and AV are each 2 flops/MAC over head_dim, for every query head,
    on every *global attention* layer. Local-window layers contribute to the
    linear term instead (their context is capped at the window).
    """
    if m.attn_free:
        return 0.0
    return 4.0 * m.n_heads * m.head_dim * m.n_global_layers()


def _local_attn_flops_per_token(m: ModelSpec) -> float:
    """Sliding-window layers: attention flops per token (linear, window-capped)."""
    if m.attn_free or m.local_window <= 0:
        return 0.0
    return 4.0 * m.n_heads * m.head_dim * m.n_local_layers() * m.local_window


def _act_bytes_per_token(m: ModelSpec) -> float:
    """M_token: activation bytes per token for the whole model (no ckpt).

    Counts the tensors autodiff keeps live per layer under the flash-attn
    regime (no S^2 score materialization): layer input, normed input, q/k/v,
    attn out, o-proj out, MLP gate/up/act/down inputs. This matches the
    standard ~(18..34)*D*e per layer ballpark used by Megatron's activation
    analysis, specialised per family.
    """
    e, D = m.bytes_per_act, m.d_model
    per_layer = 0.0
    if not m.attn_free:
        qw = m.n_heads * m.head_dim
        kw = 2 * m.d_kv  # k + v as stored
        per_layer += e * (2 * D + qw + kw + qw + D)  # ln, q, k, v, attn-out, o-out
        per_layer += 4 * m.n_heads  # softmax stats (fp32 lse per token per head)
    if m.ssm_state > 0:
        di = m.inner
        per_layer += e * (2 * D + 2 * di + 3 * di)   # ln, in-proj, conv/scan/gate
    if m.n_experts > 0:
        act = m.top_k + m.n_shared_experts
        per_layer += e * (D + act * (3 * m.d_ff_expert) + D)
        per_layer += 4 * m.top_k * 2                 # router logits/weights
    elif m.d_ff > 0:
        per_layer += e * (D + 3 * m.d_ff + D)
    return m.n_layers * per_layer


def analytic_coefficients(m: ModelSpec, c: ClusterSpec,
                          ce_mode: str = "streaming") -> Coefficients:
    """Derive Eq. 1/3/5 coefficients from first principles.

    ``ce_mode`` selects the cross-entropy memory regime (paper §IV):
      * ``"naive"``     — full fp32 logits + intermediates: 8*V bytes/token.
      * ``"inplace"``   — Megatron's fused in-place CE (the paper's
                          executor): logits materialized once, grad written
                          in place: e*V + stats bytes/token.
      * ``"streaming"`` — the vocab-tiled online-logsumexp kernel
                          (beyond-paper): logits are never materialized; only
                          per-token fp32 (max, lse) stats remain.
    """
    eff = c.effective_flops * c.n_devices  # aggregate effective flops
    lin = _linear_flops_per_token(m) + _local_attn_flops_per_token(m)
    quad = _attn_flops_per_token_pair(m)
    # alpha1/alpha2 are "seconds per unit, whole model, on ONE device";
    # Eq. 1 divides by N, so scale by per-chip effective flops here.
    alpha1 = quad / c.effective_flops
    alpha2 = lin / c.effective_flops
    beta1 = 5e-6  # per-stage dispatch overhead (one step's launch overhead)
    # Ulysses all-to-all: volume/d_s per device per collective, link-limited.
    a2a_bw = c.link_bw * 0.8
    ag_bw = c.link_bw * 0.8
    if ce_mode == "streaming":
        m_logits = 16.0
    elif ce_mode == "inplace":
        m_logits = float(m.bytes_per_act * m.vocab + 8)
    else:
        m_logits = 8.0 * m.vocab
    return Coefficients(
        alpha1=alpha1,
        alpha2=alpha2,
        beta1=beta1,
        a2a_bw=a2a_bw,
        a2a_latency=1.5e-6,
        ag_bw=ag_bw,
        m_token=_act_bytes_per_token(m),
        m_logits=m_logits,
    )


# ---------------------------------------------------------------------------
# The cost model proper.
# ---------------------------------------------------------------------------


@dataclass
class CostModel:
    model: ModelSpec
    cluster: ClusterSpec
    coeffs: Optional[Coefficients] = None
    sp_policy: str = "auto"          # "none" | "ulysses" | "allgather_kv" | "auto"
    # effective SP degree d_s_eff (sub-groups of the model axis); 0 => the
    # full d_s. Tokens shard 1/d_s_eff per device and compute replicates
    # d_s/d_s_eff times — the planner trades that waste against the
    # saturation gain (utilization) and the per-layer collective cost.
    sp_degree: int = 0
    # straggler mitigation: per-stage slowdown multipliers (>= 1.0)
    stage_slowdowns: Optional[Sequence[float]] = None
    # Fig. 1(a) utilization model: tokens/SP-rank at which the matrix units
    # reaches half of peak efficiency.
    sat_half: float = 256.0
    # cross-entropy memory regime (see analytic_coefficients)
    ce_mode: str = "streaming"
    # measured-recompute correction (telemetry calibration): Eq. 11's
    # analytic recompute fraction times this factor. 1.0 = analytic.
    recompute_factor: float = 1.0

    def __post_init__(self) -> None:
        if self.coeffs is None:
            self.coeffs = analytic_coefficients(self.model, self.cluster,
                                                self.ce_mode)
        if self.sp_degree == 0:
            self.sp_degree = self.cluster.d_s
        if (self.sp_degree < 1 or self.cluster.d_s % self.sp_degree
                or self.sp_degree > self.cluster.d_s):
            raise ValueError(
                f"sp_degree={self.sp_degree} must divide the model axis "
                f"d_s={self.cluster.d_s}")
        # ONE policy heuristic for cost model and runtime alike:
        # core/sp.choose_sp_policy (tests/test_sp_policy.py pins that the
        # two consumers can never diverge again)
        if self.sp_policy == "auto":
            self.sp_policy = choose_sp_policy(self.model, self.sp_degree)
        if not sp_legal(self.model, self.sp_policy, self.sp_degree):
            raise ValueError(
                f"SP policy {self.sp_policy!r} is illegal for "
                f"{self.model.name} at d_s_eff={self.sp_degree} "
                f"(heads {self.model.n_heads}/{self.model.n_kv_heads}, "
                f"mla={self.model.kv_lora_rank > 0}, "
                f"attn_free={self.model.attn_free})")
        if self.stage_slowdowns is not None:
            if len(self.stage_slowdowns) != self.cluster.d_p:
                raise ValueError("stage_slowdowns must have d_p entries")

    # -- helpers ------------------------------------------------------------
    def _slowdown(self, p: Optional[int]) -> float:
        if self.stage_slowdowns is None or p is None:
            return 1.0
        return float(self.stage_slowdowns[p - 1])

    @property
    def sp_replication(self) -> int:
        """Chunk-compute replication across the model axis: every SP
        sub-group of ``d_s_eff`` devices holds the whole chunk, so
        ``r = d_s / d_s_eff`` replicas do identical work."""
        return self.cluster.d_s // self.sp_degree

    # ------------------------------------------------------------------
    # Eq. 1: computation time.
    # ------------------------------------------------------------------
    def utilization(self, chunk: Chunk) -> float:
        """Fig. 1(a)'s computational-intensity degradation: with few tokens
        per SP rank, the matrix units cannot be kept full. Saturation curve
        ``u = t / (t + t_half)`` with t = tokens per device along the SP axis,
        t_half = half-saturation point (~a few matrix-unit tiles). A reduced
        ``d_s_eff`` leaves MORE tokens per device, so short chunks regain
        saturation — the gain the planner weighs against the replicated
        compute (:attr:`sp_replication`)."""
        tpd = chunk.tokens / self.sp_degree
        return tpd / (tpd + self.sat_half)

    def t_comp(self, chunk: Chunk, *, per_stage: bool = False,
               stage: Optional[int] = None) -> float:
        co, cl = self.coeffs, self.cluster
        C, s0 = float(chunk.context), float(chunk.s0)
        quad = (C + s0) ** 2 - C ** 2 if s0 else 0.0
        lin = s0
        for s in chunk.short_slices:
            quad += float(s.length) ** 2
            lin += float(s.length)
        # compute parallelism along the sequence axis is d_s_eff, not d_s:
        # the r = d_s/d_s_eff replicas repeat the same work
        t = (co.alpha1 * 0.5 * quad + co.alpha2 * lin) \
            * self.sp_replication / cl.n_devices
        t /= self.utilization(chunk)
        t += co.beta1 / cl.d_p
        t *= self._slowdown(stage)
        if per_stage:
            # a single stage holds L/d_p of the layers => 1/d_p of the time,
            # but beta1/d_p is already per stage.
            t = (t - co.beta1 / cl.d_p * self._slowdown(stage)) / cl.d_p \
                + co.beta1 / cl.d_p * self._slowdown(stage)
        return t

    def t_comp_bwd(self, chunk: Chunk, **kw) -> float:
        return BWD_MULT * self.t_comp(chunk, **kw)

    # ------------------------------------------------------------------
    # Eq. 2-3: SP communication.
    # ------------------------------------------------------------------
    def t_sp_comm(self, chunk: Chunk, *, per_stage: bool = False) -> float:
        """Per-layer SP communication for one chunk, whole model (or stage).

        ulysses: Eq. 3's four all-to-alls (q, k, v, attn-out). The split-chunk
        context KV is stored *head-sharded*, so attending to it is free of
        communication.

        allgather_kv: K/V of the chunk's own tokens are all-gathered across
        the "model" axis once per layer; the gathered KV is appended to a
        *replicated* context buffer, so later slices re-read it locally
        (communication is linear in chunk tokens, NOT in context — the
        memory price is the replication factor in :meth:`m_dkv`).
        """
        m, co, cl = self.model, self.coeffs, self.cluster
        d = self.sp_degree
        if m.attn_free or self.sp_policy == "none" or d <= 1:
            return 0.0
        toks = float(chunk.tokens)
        e = m.bytes_per_act
        layers = m.n_layers if not per_stage else max(1, m.n_layers // cl.d_p)
        if self.sp_policy == "ulysses":
            vol = e * 2 * (m.d_head_total + m.d_kv) * toks / d
            t_layer = vol / co.a2a_bw + 4 * co.a2a_latency
        else:
            vol = e * 2 * m.d_kv * toks * (d - 1) / d
            t_layer = vol / co.ag_bw + co.a2a_latency
        return layers * t_layer

    @property
    def kv_replication(self) -> int:
        """Context-KV replication across the FULL model axis (relative to
        a 1/d_s shard): ulysses keeps context head-sharded over its
        sub-group (``d_s/d_s_eff`` replicas); allgather_kv and "none"
        hold the whole context per device (``d_s``)."""
        if self.sp_policy == "ulysses":
            return self.cluster.d_s // self.sp_degree
        return self.cluster.d_s

    # ------------------------------------------------------------------
    # Eq. 4: total chunk time.
    # ------------------------------------------------------------------
    def t_tot(self, chunk: Chunk, *, bwd: bool = False, per_stage: bool = False,
              stage: Optional[int] = None) -> float:
        mult = BWD_MULT if bwd else 1.0
        return (mult * self.t_comp(chunk, per_stage=per_stage, stage=stage)
                + mult * self.t_sp_comm(chunk, per_stage=per_stage))

    def t_fwd_bwd(self, chunk: Chunk, l_ckpt: int = 0) -> float:
        return (self.t_tot(chunk) + self.t_tot(chunk, bwd=True)
                + self.t_recompute(chunk, l_ckpt))

    def avg_stage_times(self, chunks: Sequence[Chunk]
                        ) -> Tuple[float, float]:
        """Mean per-stage ``(t_fwd, t_bwd)`` tick durations over a chunk set
        — the inputs to the schedule backends' bubble model
        (:meth:`repro_torch.core.schedule.ScheduleSpec.bubble_time`); the W-grad
        share of ``t_bwd`` is ``schedule.WGRAD_FRACTION``."""
        if not chunks:
            return 0.0, 0.0
        t_f = sum(self.t_tot(c, per_stage=True) for c in chunks)
        t_b = sum(self.t_tot(c, bwd=True, per_stage=True) for c in chunks)
        return t_f / len(chunks), t_b / len(chunks)

    def t_p2p(self, chunk: Chunk) -> float:
        """Stage-boundary activation hand-off for one chunk: the (token-
        sharded) hidden state over the link plus a launch latency. The pipeline
        simulator charges it per stage crossing; the schedule picker
        charges interleaving's extra ring trips with it."""
        m, cl = self.model, self.cluster
        vol = m.bytes_per_act * m.d_model * chunk.tokens / self.sp_degree
        return vol / cl.link_bw + 1e-6

    # ------------------------------------------------------------------
    # Eq. 11: recompute cost of checkpointing l_ckpt layers (per stage).
    # ------------------------------------------------------------------
    def t_recompute(self, chunk: Chunk, l_ckpt: int) -> float:
        """Re-running l_ckpt layers of THIS stage forward during backward.

        The paper's Eq. 11 normalizes by (L * d_s); physically the stage
        re-runs l_ckpt of its L/d_p layers, i.e. a fraction l_ckpt*d_p/L of
        the whole-model forward — which equals Eq. 11 up to the paper's
        normalization convention. We use the physical form.
        """
        if l_ckpt <= 0:
            return 0.0
        frac = min(1.0, l_ckpt * self.cluster.d_p / self.model.n_layers)
        return self.recompute_factor * frac * self.t_tot(chunk)

    def t_layer_fwd(self) -> float:
        """F-hat of Eq. 17: estimated forward time of ONE model layer for a
        workload-balanced chunk (uses the mean chunk cost; callers override
        with the actual chunk set when available)."""
        m, co, cl = self.model, self.coeffs, self.cluster
        # fall back to a 'capacity' chunk of T_m tokens
        toks = self.token_capacity()
        t = (co.alpha2 * toks) / cl.n_devices / m.n_layers
        return t

    # ------------------------------------------------------------------
    # Eq. 5 / 9 / 10: stage-aware activation memory (bytes per device).
    # ------------------------------------------------------------------
    def m_dkv(self, chunk: Chunk) -> float:
        """KV (+grad) residency for chunks whose KV has dependents (Eq. 5),
        scaled by the SP policy's context replication factor."""
        m, cl = self.model, self.cluster
        if not chunk.has_dependents or m.attn_free:
            return 0.0
        e = m.bytes_per_act
        repl = self.kv_replication
        return (repl * 2.0 * e * m.n_layers * m.d_kv / cl.n_devices) * chunk.tokens

    def m_ckpt(self, chunk: Chunk, l_ckpt: int) -> float:
        """Checkpoint storage (Eq. 9): layer inputs + un-freeable KV.
        Layer inputs are token-sharded at ``d_s_eff`` (the replication
        factor re-inflates the per-1/d_s normalization)."""
        m, cl = self.model, self.cluster
        e = m.bytes_per_act
        kv = 2 * m.d_kv * self.kv_replication if chunk.has_dependents else 0
        d_model = m.d_model * self.sp_replication
        return (e * (d_model + kv) * l_ckpt / cl.d_s) * chunk.tokens

    def m_act(self, stage: int, chunk: Chunk, l_ckpt: int = 0) -> float:
        """Eq. 10. ``stage`` is 1-based (p == d_p carries the logits)."""
        m, co, cl = self.model, self.coeffs, self.cluster
        toks = chunk.tokens
        live_frac = max(0.0, (m.n_layers - l_ckpt * cl.d_p) / m.n_layers)
        a = live_frac * co.m_token * self.sp_replication / cl.n_devices
        if stage == cl.d_p:
            a += co.m_logits / cl.d_s
        return self.m_dkv(chunk) + self.m_ckpt(chunk, l_ckpt) + a * toks

    def m_model_states(self, stage: int) -> float:
        """M_ms(p): params(bf16) + fp32 master + adam m/v + grad, ZeRO-3 over d_s.

        Stage 1 additionally hosts the (vocab-sharded) embedding; stage d_p
        the LM head when untied.
        """
        m, cl = self.model, self.cluster
        body = m.param_count() - m.vocab * m.d_model * (1 if m.tie_embeddings else 2)
        per_stage = body / cl.d_p
        if stage == 1:
            per_stage += m.vocab * m.d_model
        if stage == cl.d_p and not m.tie_embeddings:
            per_stage += m.vocab * m.d_model
        if stage == cl.d_p and m.tie_embeddings:
            per_stage += m.vocab * m.d_model  # tied head still materialized on use
        bytes_per_param = 2 + 4 + 4 + 4 + 4   # bf16 + master + m + v + fp32 grad
        return per_stage * bytes_per_param / cl.d_s

    # ------------------------------------------------------------------
    # Token capacity (Alg. 1 input C): max tokens resident at once.
    # ------------------------------------------------------------------
    def token_capacity(self) -> int:
        """Tokens whose *un-checkpointed* activations fit beside model states
        on the worst stage, for a window of d_p chunks (Eq. 7-8 worst case)."""
        m, co, cl = self.model, self.coeffs, self.cluster
        worst_ms = max(self.m_model_states(p) for p in (1, 2, cl.d_p))
        free = cl.capacity_bytes - worst_ms
        if free <= 0:
            raise ValueError(
                f"model states ({worst_ms/1e9:.1f} GB) exceed capacity "
                f"({cl.capacity_bytes/1e9:.1f} GB) — increase d_p or d_s")
        per_token = (co.m_token * self.sp_replication / cl.n_devices
                     + (2.0 * m.bytes_per_act * m.n_layers * m.d_kv
                        * self.kv_replication / cl.n_devices)
                     + co.m_logits / cl.d_s / cl.d_p)
        return int(free / per_token)

    # ------------------------------------------------------------------
    # Alg. 1 line 1: split the longest sequence into K balanced slices.
    # ------------------------------------------------------------------
    def split_balanced(self, length: int, k: int) -> List[int]:
        """Slice ``length`` into K slices of (approximately) equal *backward*
        cost under the quadratic attention model. Earlier slices are longer
        (they have less context), the tail is shortest — the paper's mesh.

        Closed form: slice boundaries are at equal increments of the
        cumulative cost function  g(x) = 0.5*alpha1*x^2 + alpha2*x.
        """
        if k <= 1 or length <= 0:
            return [length] if length > 0 else []
        a1 = self.coeffs.alpha1 * 0.5
        a2 = self.coeffs.alpha2
        total = a1 * length ** 2 + a2 * length
        bounds = [0]
        for i in range(1, k):
            target = total * i / k
            # solve a1*x^2 + a2*x = target
            if a1 > 0:
                x = (-a2 + math.sqrt(a2 * a2 + 4 * a1 * target)) / (2 * a1)
            else:
                x = target / a2 if a2 > 0 else length * i / k
            bounds.append(int(round(x)))
        bounds.append(length)
        # enforce monotone, nonzero slices (tiny sequences & large K)
        out: List[int] = []
        prev = 0
        for b in bounds[1:]:
            b = max(b, prev + 1) if b < length else b
            b = min(b, length)
            if b > prev:
                out.append(b - prev)
            prev = b
        if sum(out) != length:  # absorb rounding into the tail
            out[-1] += length - sum(out)
        return [s for s in out if s > 0]

    # convenience used throughout the scheduler
    def delta_warmup(self, chunks: Sequence[Chunk]) -> float:
        """Eq. 13's δ = (d_p - 1) * avg(T_tot) warmup-cooldown overhead."""
        if not chunks:
            return 0.0
        avg = sum(self.t_tot(c, per_stage=True)
                  + self.t_tot(c, bwd=True, per_stage=True)
                  for c in chunks) / len(chunks)
        return (self.cluster.d_p - 1) * avg

    def with_slowdowns(self, slowdowns: Sequence[float]) -> "CostModel":
        return CostModel(self.model, self.cluster, self.coeffs,
                         sp_policy=self.sp_policy, sp_degree=self.sp_degree,
                         stage_slowdowns=list(slowdowns),
                         sat_half=self.sat_half, ce_mode=self.ce_mode,
                         recompute_factor=self.recompute_factor)

    def with_sp(self, policy: str, degree: int) -> "CostModel":
        """This model re-costed at another point of the SP axis (shares
        the analytic coefficients) — the planner's sweep primitive."""
        return CostModel(self.model, self.cluster, self.coeffs,
                         sp_policy=policy, sp_degree=degree,
                         stage_slowdowns=self.stage_slowdowns,
                         sat_half=self.sat_half, ce_mode=self.ce_mode,
                         recompute_factor=self.recompute_factor)


# ---------------------------------------------------------------------------
# Regression refinement (paper: "verified and refined via offline profiling
# and regression fitting"). Samples are (chunk, measured_seconds) pairs; we
# refit (alpha1, alpha2, beta1) by least squares on the Eq. 1 basis.
# ---------------------------------------------------------------------------

def fit_coefficients(base: Coefficients, cluster: ClusterSpec,
                     samples: Iterable[Tuple[Chunk, float]]) -> Coefficients:
    rows: List[List[float]] = []
    ys: List[float] = []
    for chunk, seconds in samples:
        C, s0 = float(chunk.context), float(chunk.s0)
        quad = ((C + s0) ** 2 - C ** 2) * 0.5 if s0 else 0.0
        lin = s0
        for s in chunk.short_slices:
            quad += 0.5 * float(s.length) ** 2
            lin += float(s.length)
        rows.append([quad / cluster.n_devices, lin / cluster.n_devices,
                     1.0 / cluster.d_p])
        ys.append(seconds)
    A = np.asarray(rows, dtype=np.float64)
    y = np.asarray(ys, dtype=np.float64)
    sol, *_ = np.linalg.lstsq(A, y, rcond=None)
    a1, a2, b1 = (max(float(v), 0.0) for v in sol)
    return replace(base, alpha1=a1, alpha2=a2, beta1=b1)
