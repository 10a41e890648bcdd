"""Core datatypes for the InfiniPipe solver stack.

A copy of the JAX package's ``core/plan.py`` (same classes, same JSON), with
:class:`ClusterSpec` defaulting to one NVIDIA H100 instead of a TPU.
Everything in ``repro_torch.core`` is pure Python/NumPy (the host-side
"solver" of the paper's disaggregated architecture, Fig. 4): it imports no
torch, so planning can run on CPU workers and overlap the training step.

The uniform chunk representation follows §III-A.1 of the paper: every chunk is
``{C, S}`` where ``C`` is the causal context length already processed by
preceding slices of the same sequence (0 for batched chunks) and ``S`` is the
set of slice lengths packed into the chunk.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

from .sp import SPConfig

__all__ = [
    "BucketKey",
    "ChunkKind",
    "Slice",
    "Chunk",
    "SequenceInfo",
    "ModelSpec",
    "ClusterSpec",
    "Coefficients",
    "PipelinePlan",
    "ExecutionPlan",
    "SPConfig",
    "TickOp",
    "Tick",
]


class ChunkKind(str, enum.Enum):
    BATCHED = "batched"  # pack of short sequences, C == 0
    SPLIT = "split"      # one slice of a long sequence, C > 0 or more slices follow
    HYBRID = "hybrid"    # tail slice of a long sequence packed with shorts


@dataclass(frozen=True)
class Slice:
    """A contiguous token range of one logical sequence."""

    seq_id: int
    start: int          # token offset within the sequence
    length: int
    is_tail: bool       # last slice of its sequence (or a whole short sequence)

    def __post_init__(self) -> None:
        if self.length <= 0:
            raise ValueError(f"slice length must be positive, got {self.length}")
        if self.start < 0:
            raise ValueError(f"slice start must be >= 0, got {self.start}")


@dataclass(frozen=True)
class Chunk:
    """EPP micro-batch: the paper's uniform ``{C, S}`` representation.

    ``has_dependents`` is the indicator the paper writes as ``(1 - I_k)``:
    True iff some *later* chunk of the same sequence will still attend to this
    chunk's keys/values. Only non-tail split chunks have dependents; their KV
    cannot be freed under checkpointing (Eq. 9) and their dKV is materialized
    throughout the tail's backward (Eq. 5, the ``M_dkv`` term).
    """

    kind: ChunkKind
    context: int                 # C: causal context length (tokens) preceding s0
    slices: Tuple[Slice, ...]    # S (for SPLIT/HYBRID, slices[0] is s0, the sequence slice)

    def __post_init__(self) -> None:
        if self.kind is ChunkKind.BATCHED and self.context != 0:
            raise ValueError("batched chunks must have zero context")
        if self.kind is not ChunkKind.BATCHED and not self.slices:
            raise ValueError("split/hybrid chunks need at least the sequence slice")

    # -- token accounting ---------------------------------------------------
    @property
    def tokens(self) -> int:
        return sum(s.length for s in self.slices)

    @property
    def s0(self) -> int:
        """Length of the (split) sequence slice; 0 for batched chunks."""
        if self.kind is ChunkKind.BATCHED:
            return 0
        return self.slices[0].length

    @property
    def seq_id(self) -> Optional[int]:
        """The long sequence this chunk belongs to (None for batched)."""
        if self.kind is ChunkKind.BATCHED:
            return None
        return self.slices[0].seq_id

    @property
    def has_dependents(self) -> bool:
        if self.kind is ChunkKind.BATCHED:
            return False
        return not self.slices[0].is_tail

    @property
    def short_slices(self) -> Tuple[Slice, ...]:
        """Packed short sequences (everything but s0)."""
        if self.kind is ChunkKind.BATCHED:
            return self.slices
        return self.slices[1:]

    def to_json(self) -> Dict[str, Any]:
        return {
            "kind": self.kind.value,
            "context": self.context,
            "slices": [dataclasses.asdict(s) for s in self.slices],
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Chunk":
        return Chunk(
            kind=ChunkKind(d["kind"]),
            context=d["context"],
            slices=tuple(Slice(**s) for s in d["slices"]),
        )


@dataclass
class SequenceInfo:
    """Per-sequence bookkeeping produced by the sequence processor."""

    seq_id: int
    length: int
    n_chunks: int            # how many chunks this sequence spans
    chunk_ids: List[int]     # indices into the global chunk list, slice order


# ---------------------------------------------------------------------------
# Specs shared between the solver and the executor.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelSpec:
    """The subset of an architecture config the cost model needs.

    All dimension names follow the paper's notation where one exists:
    ``D`` = d_model, ``D_kv`` = total KV width (n_kv_heads * head_dim), ``L`` =
    n_layers, ``e`` = bytes per activation element.
    """

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # --- optional family extensions ---
    n_experts: int = 0            # routed experts (0 => dense MLP)
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    kv_lora_rank: int = 0         # > 0 => MLA (deepseek): context stores latent
    qk_rope_dim: int = 0          # MLA decoupled rope dim
    ssm_state: int = 0            # > 0 => mamba mixer present
    ssm_conv: int = 4
    d_inner: int = 0              # mamba inner width (default 2*d_model)
    attn_free: bool = False       # pure SSM (falcon-mamba): no attention at all
    hybrid_parallel: bool = False # hymba: attention and mamba heads in parallel
    local_window: int = 0         # sliding-window size for local layers
    local_global_ratio: int = 0   # N local layers per 1 global layer (gemma3: 5)
    qk_norm: bool = False
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    tie_embeddings: bool = True
    bytes_per_act: int = 2        # e: bf16 activations

    # ------------------------------------------------------------------
    @property
    def d_kv(self) -> int:
        """D_kv: total key (or value) width per layer as stored for context."""
        if self.kv_lora_rank > 0:
            # MLA: the context buffer stores the compressed latent + rope key.
            # (Halved because the latent is shared by K and V; the cost model
            # multiplies KV storage by 2.)
            return (self.kv_lora_rank + self.qk_rope_dim) // 2 or 1
        if self.attn_free:
            return 0
        return self.n_kv_heads * self.head_dim

    @property
    def d_head_total(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def inner(self) -> int:
        return self.d_inner if self.d_inner else 2 * self.d_model

    def n_global_layers(self) -> int:
        """Number of full-attention (global) layers."""
        if self.attn_free:
            return 0
        if self.local_global_ratio <= 0:
            return self.n_layers
        period = self.local_global_ratio + 1
        return (self.n_layers + period - 1) // period

    def n_local_layers(self) -> int:
        if self.attn_free:
            return 0
        return self.n_layers - self.n_global_layers()

    # --- parameter counting (used for M_ms, roofline MODEL_FLOPS) --------
    def param_count(self) -> int:
        D, Dh, Hq, Hkv = self.d_model, self.head_dim, self.n_heads, self.n_kv_heads
        per_layer = 0
        if not self.attn_free:
            if self.kv_lora_rank > 0:
                r, rr = self.kv_lora_rank, self.qk_rope_dim
                per_layer += D * (Hq * (Dh + rr))                   # q proj (+rope part)
                per_layer += D * (r + rr)                           # kv down
                per_layer += r * (Hq * Dh * 2)                      # k/v up
                per_layer += Hq * Dh * D                            # o proj
            else:
                per_layer += D * Hq * Dh + 2 * D * Hkv * Dh + Hq * Dh * D
        if self.ssm_state > 0:
            di, ds = self.inner, self.ssm_state
            per_layer += D * 2 * di            # in proj (x, z)
            per_layer += di * self.ssm_conv    # conv
            per_layer += di * (2 * ds + 2)     # B, C, dt projections (approx)
            per_layer += di * D                # out proj
            per_layer += di * ds               # A
        if self.n_experts > 0:
            per_layer += D * self.n_experts    # router
            per_layer += self.n_experts * 3 * D * self.d_ff_expert
            per_layer += self.n_shared_experts * 3 * D * self.d_ff_expert
        elif self.d_ff > 0 and not (self.attn_free and self.ssm_state > 0):
            per_layer += 3 * D * self.d_ff     # SwiGLU
        per_layer += 2 * D                     # norms
        total = self.n_layers * per_layer
        if self.is_encoder_decoder:
            enc_per_layer = per_layer + D * Hq * Dh + 2 * D * Hkv * Dh + Hq * Dh * D
            total += self.n_encoder_layers * enc_per_layer
        total += self.vocab * D * (1 if self.tie_embeddings else 2)
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared)."""
        if self.n_experts == 0:
            return self.param_count()
        dead = (self.n_experts - self.top_k) * 3 * self.d_model * self.d_ff_expert
        return self.param_count() - self.n_layers * dead


@dataclass(frozen=True)
class ClusterSpec:
    """Target hardware. Defaults = one NVIDIA H100 SXM (NVIDIA's data sheet):
    80 GB of HBM3 at 3.35 TB/s, 989 TFLOP/s dense bf16, NVLink at 450 GB/s
    each way between the cards of a host. ``link_bw`` is the stage-to-stage
    and SP collective link (NVLink here; the JAX package's ``ici_bw``),
    ``net_bw`` the link between hosts (the JAX package's ``dcn_bw``; 400
    Gb/s InfiniBand per card). ``d_p = d_s = 1``: the single-card step."""

    d_p: int = 1                 # pipeline stages
    d_s: int = 1                 # SP/FSDP/EP degree
    n_pods: int = 1              # data-parallel replicas over hosts
    flops_per_chip: float = 989e12      # bf16 dense peak
    hbm_bytes: float = 80e9             # HBM3 capacity
    hbm_bw: float = 3.35e12             # bytes/s
    link_bw: float = 450e9              # NVLink bytes/s, each way
    net_bw: float = 400e9 / 8           # between hosts, per card
    mfu: float = 0.5                    # achievable fraction of peak (refined by fit)
    mem_fraction: float = 0.92          # usable fraction of HBM

    @property
    def n_devices(self) -> int:
        return self.d_p * self.d_s  # per pod (the paper's N = d_s * d_p)

    @property
    def effective_flops(self) -> float:
        return self.flops_per_chip * self.mfu

    @property
    def capacity_bytes(self) -> float:
        return self.hbm_bytes * self.mem_fraction

    def with_(self, **kw: Any) -> "ClusterSpec":
        return dataclasses.replace(self, **kw)


@dataclass
class Coefficients:
    """Regression-refined cost-model coefficients (§III-A: 'verified and
    refined via offline profiling and regression fitting').

    alpha1: seconds per (token-pair) of causal attention  [quadratic term]
    alpha2: seconds per token of position-independent work [linear term]
    beta1:  fixed per-chunk overhead per stage (launch/dispatch)
    All are *whole-model* coefficients; Eq. 1 divides by N and d_p.
    """

    alpha1: float
    alpha2: float
    beta1: float
    a2a_bw: float          # effective all-to-all bandwidth (bytes/s per device)
    a2a_latency: float     # per-collective latency (s)
    ag_bw: float           # effective all-gather bandwidth for allgather-kv SP
    m_token: float         # activation bytes per token, whole model (M_token)
    m_logits: float        # logits bytes per token (M_logits)

    def to_json(self) -> Dict[str, float]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Dict[str, float]) -> "Coefficients":
        return Coefficients(**d)


# ---------------------------------------------------------------------------
# Schedule / plan artifacts.
# ---------------------------------------------------------------------------


class TickOp(str, enum.Enum):
    FWD = "F"
    BWD = "B"
    BUBBLE = "."


@dataclass(frozen=True)
class Tick:
    op: TickOp
    chunk: int = -1  # chunk index within the pipeline; -1 for bubbles


@dataclass
class PipelinePlan:
    """One 1F1B pipeline: an ordered set of chunks + schedule + ckpt config."""

    chunks: List[Chunk]
    # forward execution order is list order; f2b maps fwd index -> bwd index
    f2b: List[int]
    # per-stage tick schedule (stage-major): schedule[p] is the list of Ticks
    schedule: List[List[Tick]] = field(default_factory=list)
    # ckpt[p][k]: checkpointed layers for chunk k (fwd index) at stage p
    ckpt: List[List[int]] = field(default_factory=list)
    # the diagonal variables C of Eq. 15 (len == n + d_p - 1)
    ckpt_diag: List[int] = field(default_factory=list)
    n_split: int = 1          # N_split: max #chunks of any sequence in this pipeline
    est_time: float = 0.0     # simulator makespan estimate (s)
    est_recompute: float = 0.0
    est_peak_mem: List[float] = field(default_factory=list)  # per stage (bytes)
    # schedule backend the bubble model prefers for THIS pipeline
    # (core/schedule.py registry name + virtual-stage count)
    sched_backend: str = "gpipe-1f1b"
    v_stages: int = 1

    @property
    def n_chunks(self) -> int:
        return len(self.chunks)

    @property
    def b2f(self) -> List[int]:
        inv = [0] * len(self.f2b)
        for f, b in enumerate(self.f2b):
            inv[b] = f
        return inv

    def to_json(self) -> Dict[str, Any]:
        return {
            "chunks": [c.to_json() for c in self.chunks],
            "f2b": self.f2b,
            "ckpt": self.ckpt,
            "ckpt_diag": self.ckpt_diag,
            "n_split": self.n_split,
            "est_time": self.est_time,
            "est_recompute": self.est_recompute,
            "est_peak_mem": self.est_peak_mem,
            "schedule": [[(t.op.value, t.chunk) for t in row] for row in self.schedule],
            "sched_backend": self.sched_backend,
            "v_stages": self.v_stages,
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "PipelinePlan":
        return PipelinePlan(
            chunks=[Chunk.from_json(c) for c in d["chunks"]],
            f2b=list(d["f2b"]),
            schedule=[[Tick(TickOp(op), ch) for op, ch in row] for row in d["schedule"]],
            ckpt=[list(r) for r in d["ckpt"]],
            ckpt_diag=list(d["ckpt_diag"]),
            n_split=d["n_split"],
            est_time=d["est_time"],
            est_recompute=d["est_recompute"],
            est_peak_mem=list(d["est_peak_mem"]),
            sched_backend=d.get("sched_backend", "gpipe-1f1b"),
            v_stages=d.get("v_stages", 1),
        )


class BucketKey(NamedTuple):
    """Compiled-executable bucket identity (``ExecutionPlan.bucket_key``).

    A ``NamedTuple`` rather than a bare tuple so consumers access fields by
    NAME — positional slicing (``key[2:4]``) broke silently when PR 2
    reordered the tuple to lead with the schedule, and only survived by
    luck. It is still a tuple: hashing, equality and iteration (compile
    cache keys, test comparisons) are unchanged.
    """

    schedule: str       # schedule backend name (leads: layout is schedule-shaped)
    v_stages: int       # virtual stages per device (interleaved-1f1b)
    n_chunks: int       # chunk count rounded UP to chunk_rounding
    cap: int            # chunk token capacity rounded up to d_s
    ctx_cap: int        # context capacity rounded up to cap
    l_ckpt: int         # max ILP recompute depth baked into the step
    ckpt: str           # canonical remat-policy digest ("uN" uniform depth
                        # N; "v<sha12>" a per-(stage, chunk) vector) — plans
                        # with different remat never alias one executable
    split_bwd: bool = False   # RESOLVED zero-bubble B/W split: "auto"
                        # resolves to the schedule backend's capability,
                        # so auto and an explicit matching force share
                        # one bucket (identical HLO) while a true
                        # override gets its own executable
    dtype: str = "bfloat16"   # compute dtype baked into the step — a
                        # float32 (--reduced) and a bf16 run must never
                        # alias one executable
    sp_policy: str = "auto"   # RESOLVED sequence-parallel policy (none /
                        # ulysses / allgather_kv). "auto" only for legacy
                        # plans that carry no SPConfig — those keep the
                        # pre-SP-axis identity (runtime rederives the
                        # policy at full degree)
    d_s_eff: int = 0    # effective SP degree (sub-groups of the model
                        # axis); 0 only for legacy sp-less plans, which
                        # bucket_key() resolves to the full d_s. The
                        # collective pattern AND the local token shapes
                        # (cap // d_s_eff) are degree-shaped, so two
                        # plans differing only here must never alias an
                        # executable or a cache-store entry


@dataclass
class ExecutionPlan:
    """The solver's full output for one global batch (per pod)."""

    pipelines: List[PipelinePlan]
    sequences: List[SequenceInfo]
    k_split: int                       # the tuned hyper-parameter K of Alg. 1
    chunk_capacity: int                # T_m rounded up to the bucket geometry
    mesh_slices: List[int]             # Alg. 1 line 1 slice-length mesh
    est_total_time: float = 0.0
    solve_time: float = 0.0
    remat_mode: str = "uniform"        # "uniform" | "per_chunk"
    # schedule backend the executor runs (one compiled program covers every
    # pipeline of the plan, so this is the cross-pipeline consensus pick;
    # per-pipeline preferences live on PipelinePlan.sched_backend)
    schedule: str = "gpipe-1f1b"
    v_stages: int = 1                  # virtual stages per device (interleaved)
    # sequence-parallel axis: (policy, d_s_eff) chosen by the planner
    # jointly with chunking/checkpointing (core/sp.py). None = legacy
    # plan solved before the SP axis existed: bucket_key() emits the
    # back-compatible ("auto", d_s) identity and the runtime rederives
    # the policy at full degree.
    sp: Optional[SPConfig] = None
    meta: Dict[str, Any] = field(default_factory=dict)

    @property
    def n_chunks(self) -> int:
        return sum(p.n_chunks for p in self.pipelines)

    @property
    def total_tokens(self) -> int:
        return sum(c.tokens for p in self.pipelines for c in p.chunks)

    def uniform_ckpt(self) -> int:
        """Max ILP l_ckpt over all (p, k): the 'uniform' executor policy."""
        best = 0
        for p in self.pipelines:
            for row in p.ckpt:
                for v in row:
                    best = max(best, v)
        return best

    def ckpt_table(self, n_chunks: Optional[int] = None
                   ) -> List[List[int]]:
        """The per-(stage, chunk) checkpoint matrix for the WHOLE plan:
        rows are pipeline stages, columns follow the executor's chunk
        order (all pipelines' chunks concatenated). ``n_chunks`` pads the
        columns to the compiled bucket's rounded chunk count — padding
        chunks are fully masked, so their remat depth is 0.
        """
        d_p = max((len(p.ckpt) for p in self.pipelines), default=0)
        cols: List[List[int]] = []
        for p in self.pipelines:
            n = p.n_chunks
            ck = p.ckpt if p.ckpt else [[0] * n for _ in range(d_p)]
            for k in range(n):
                cols.append([int(ck[r][k]) if r < len(ck) else 0
                             for r in range(d_p)])
        if n_chunks is not None:
            while len(cols) < n_chunks:
                cols.append([0] * d_p)
            cols = cols[:n_chunks]
        return [[col[r] for col in cols] for r in range(d_p)]

    def ckpt_per_stage_max(self) -> List[int]:
        """Max remat depth each stage ever applies (one entry per stage) —
        the per-stage remat axis dry-run sweep records and the train
        bootstrap log prints."""
        return [max(r) if r else 0 for r in self.ckpt_table()]

    def ckpt_policy(self, n_chunks: Optional[int] = None
                    ) -> Tuple[int, Optional[Tuple[Tuple[int, ...], ...]], str]:
        """Canonicalized remat policy for the executor: ``(l_max, table,
        digest)``.

        * ``remat_mode == "uniform"``: every (stage, chunk) remats the max
          ILP depth — ``table`` is None (static split), digest ``"uN"``.
        * vector modes (``"stage_aware"`` / legacy ``"per_chunk"``): the
          padded per-(stage, chunk) matrix — collapsed back to None (and a
          ``"uN"`` digest) when every REAL entry agrees (bucket-padding
          columns are fully-masked chunks, so their depth is arbitrary and
          must not block the collapse), because a constant vector compiles
          to exactly the uniform program and SHOULD share its executable;
          otherwise a ``"v" + sha256[:12]`` digest over the canonical
          padded row-major bytes.
        """
        l_max = self.uniform_ckpt()
        if self.remat_mode == "uniform" or not self.pipelines:
            return l_max, None, f"u{l_max}"
        flat = [v for row in self.ckpt_table() for v in row]
        if not flat or all(v == flat[0] for v in flat):
            c = flat[0] if flat else 0
            return c, None, f"u{c}"
        import hashlib
        table = self.ckpt_table(n_chunks)
        blob = json.dumps(table).encode()
        return (l_max, tuple(tuple(row) for row in table),
                "v" + hashlib.sha256(blob).hexdigest()[:12])

    def bucket_key(self, d_s: int, *, chunk_rounding: int = 8,
                   cap_quantum: int = 0, split_bwd: Any = "auto",
                   dtype: str = "bfloat16") -> BucketKey:
        """The compiled-executable bucket this plan lands in:
        :class:`BucketKey` ``(schedule, v_stages, n_chunks, cap, ctx_cap,
        l_ckpt, ckpt, split_bwd, dtype, sp_policy, d_s_eff)`` — access
        fields by name, not position.

        The schedule backend leads the key: tick count, stream routing and
        layer stacking are all schedule-shaped, so two plans that agree on
        geometry but not on schedule must NOT share an executable (a
        cross-schedule cache hit would run the wrong program).

        n_chunks rounds UP to a multiple of ``chunk_rounding`` (padding
        chunks are fully masked — zero loss/grad), cap to the SP degree
        ``d_s`` (token sharding), and ctx_cap to the capacity, so
        consecutive iterations reuse one compiled executable
        (runtime/compile_cache.py).

        ``cap_quantum`` optionally coarsens the capacity grid beyond the
        planner's bucket_rounding: long-context batches produce widely
        varying chunk capacities, so a coarser quantum trades masked
        padding tokens for executable reuse (benchmarks/run.py's
        ``cache_bucket_reuse`` measures the curve).

        ``split_bwd`` / ``dtype`` mirror the executor knobs of the same
        names (launch/train.py ``--split-bwd`` / compute dtype). Both
        change the compiled HLO without changing the geometry, so both
        are key fields — the lint pass ``plan-bucket-key`` enforces that
        every such axis stays visible here. ``split_bwd`` accepts the
        tri-state ``"auto"``/``"on"``/``"off"`` (or a bool) and stores
        the RESOLVED bool: "auto" on zero-bubble-h1 and a forced "on"
        compile the same program and share one bucket.
        """
        chunks = [c for p in self.pipelines for c in p.chunks]
        n = -(-len(chunks) // chunk_rounding) * chunk_rounding
        # the quantum itself must respect d_s alignment or cap would break
        # token sharding (cap_loc = cap // d_s)
        q = -(-max(d_s, cap_quantum) // d_s) * d_s
        cap = -(-self.chunk_capacity // q) * q
        max_ctx = max((c.context for c in chunks), default=0)
        ctx_cap = -(-(max_ctx + cap) // cap) * cap
        # the remat policy is baked into the compiled step (a constant
        # table in HLO), so its canonical digest must disambiguate the
        # bucket: two plans agreeing on geometry but not on remat would
        # otherwise warm-hit a wrong-remat executable
        l_max, _, digest = self.ckpt_policy(n)
        if isinstance(split_bwd, str):
            if split_bwd == "auto":
                # lazy import: core/schedule.py imports this module at
                # load time, so the resolution direction must defer
                from .schedule import get_schedule
                split = get_schedule(self.schedule, self.v_stages).split_bwd
            elif split_bwd in ("on", "off"):
                split = split_bwd == "on"
            else:
                raise ValueError(
                    f"split_bwd must be 'auto'/'on'/'off' or a bool, "
                    f"got {split_bwd!r}")
        else:
            split = bool(split_bwd)
        # the SP axis is part of executable identity: the collective
        # pattern (sub-group a2a vs KV all-gather vs none) and the local
        # token shapes (cap // d_s_eff) are both policy/degree-shaped.
        # Legacy sp-less plans keep the pre-axis ("auto", d_s) identity
        # so existing cache-store entries stay warm.
        sp_policy = self.sp.policy if self.sp is not None else "auto"
        d_s_eff = self.sp.d_s_eff if self.sp is not None else d_s
        return BucketKey(schedule=self.schedule, v_stages=self.v_stages,
                         n_chunks=n, cap=cap, ctx_cap=ctx_cap,
                         l_ckpt=l_max, ckpt=digest, split_bwd=split,
                         dtype=str(dtype), sp_policy=sp_policy,
                         d_s_eff=d_s_eff)

    def to_json(self) -> Dict[str, Any]:
        return {
            "pipelines": [p.to_json() for p in self.pipelines],
            "sequences": [dataclasses.asdict(s) for s in self.sequences],
            "k_split": self.k_split,
            "chunk_capacity": self.chunk_capacity,
            "mesh_slices": self.mesh_slices,
            "est_total_time": self.est_total_time,
            "solve_time": self.solve_time,
            "remat_mode": self.remat_mode,
            "schedule": self.schedule,
            "v_stages": self.v_stages,
            "sp": self.sp.to_json() if self.sp is not None else None,
            "meta": self.meta,
        }

    def dumps(self) -> str:
        return json.dumps(self.to_json())

    @staticmethod
    def loads(s: str) -> "ExecutionPlan":
        d = json.loads(s)
        return ExecutionPlan(
            pipelines=[PipelinePlan.from_json(p) for p in d["pipelines"]],
            sequences=[SequenceInfo(**q) for q in d["sequences"]],
            k_split=d["k_split"],
            chunk_capacity=d["chunk_capacity"],
            mesh_slices=list(d["mesh_slices"]),
            est_total_time=d["est_total_time"],
            solve_time=d["solve_time"],
            remat_mode=d.get("remat_mode", "uniform"),
            schedule=d.get("schedule", "gpipe-1f1b"),
            v_stages=d.get("v_stages", 1),
            sp=SPConfig.from_json(d.get("sp")),
            meta=d.get("meta", {}),
        )
