"""Dry-run artifact analysis helpers (no device, no side effects: safe to
import from benchmarks).

Counterpart of the JAX package's ``launch/analysis.py``:

* :func:`analytic_collectives`: the reference's per-step collective volume
  (bytes moved per device), its arithmetic over the port's geometries
  (``runtime/pipeline.PipelineGeometry``,
  ``runtime/encdec_pipeline.EncDecGeometry``,
  ``runtime/serve_step.DecodeGeometry``); a train or prefill cell's chunk
  dims, which the reference's compiled geometry carries and the port's
  plan holds, come as a :class:`BucketDims`;
* :func:`collective_counts`: the stand-in for the reference's
  ``collective_scan`` (there is no HLO to scan): the collectives that
  code ran, by kind, as counted by ``runtime/sp.KINDS`` and
  ``runtime/sharding.ZSTATS`` since a :func:`collective_snapshot`, with
  the stage hand-offs the caller counts;
* :func:`telemetry_report`, :func:`format_telemetry_report`: a digest of a
  run's ``--telemetry-dir`` (the port writes the reference's files).

The reference's ``compile_cache_report`` and ``format_cache_report`` wait
for the port's bucket cache (``ROADMAP.md`` queue 1, item 8).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["BucketDims", "analytic_collectives", "collective_snapshot",
           "collective_counts", "telemetry_report",
           "format_telemetry_report"]


@dataclass(frozen=True)
class BucketDims:
    """A train or prefill cell's chunk dims (the reference's compiled
    geometry's): ``n_chunks`` chunks of ``cap`` tokens (``cap_enc``
    encoder frames), ``ctx_cap`` context rows, the remat depth ``l_ckpt``
    and the plan's per-(stage, chunk) table ``ckpt_table`` (None:
    uniform), ``layers_per_stage`` layer slots a stage and ``enc_stages``
    encoder stages (the encoder-decoder)."""
    n_chunks: int
    cap: int
    ctx_cap: int
    l_ckpt: int
    layers_per_stage: int
    ckpt_table: Optional[Tuple[Tuple[int, ...], ...]] = None
    cap_enc: int = 0
    enc_stages: int = 0


def analytic_collectives(cfg, geom, kind: str,
                         dims: Optional[BucketDims] = None) -> dict:
    """Exact per-step collective volume (bytes moved per device) from the
    executor's own schedule (the reference's arithmetic): ``geom`` the
    port's pipeline, encoder-decoder or decode geometry, ``dims`` a train
    or prefill cell's :class:`BucketDims`."""
    s = cfg.spec
    e = 2  # bf16
    d_s, d_p = geom.d_s, geom.d_p
    out = {"ici_bytes": 0.0, "p2p_bytes": 0.0, "dcn_bytes": 0.0}
    zero3_mode = getattr(geom, "zero3_mode", None) or "per_tick"
    if kind in ("train", "prefill"):
        n, cap = dims.n_chunks, dims.cap
        # plans may run SP below the mesh degree: attention collectives span
        # d_eff-member sub-groups and compute replicates rep x (the batch
        # still rests sharded over the full axis, so ZeRO volumes keep d_s)
        d_eff = getattr(geom, "d_s_eff", 0) or d_s
        rep = d_s // d_eff
        cap_loc = cap // d_eff
        ticks = n + d_p - 1
        L_s = dims.layers_per_stage
        D = s.d_model
        per_layer = 0.0
        body = s.param_count() - s.vocab * D * (1 if s.tie_embeddings else 2)
        if s.n_experts:
            body -= s.n_layers * s.n_experts * 3 * D * s.d_ff_expert
        zero_layer_vol = e * body / s.n_layers * (d_s - 1) / d_s
        if zero3_mode == "per_tick":
            # ZeRO-3 param gather per layer PER TICK (skips EP experts)
            per_layer += zero_layer_vol
        if not s.attn_free:
            if geom.policy == "ulysses":
                per_layer += e * 2 * (s.d_head_total + s.d_kv) * cap / d_eff
            elif geom.policy == "allgather_kv":
                per_layer += e * 2 * s.d_kv * cap * (d_eff - 1) / d_eff
            # "none": attention is token-local, no SP collective
        if s.ssm_state:
            # scan summaries all-gather within the d_eff-member sub-group
            per_layer += 4 * 2 * d_eff * s.inner * s.ssm_state
        if s.n_experts:
            # EP rides the full model axis on rep x replicated rows
            per_layer += e * 2 * cap * rep * D * (d_s - 1) / d_s
        per_tick = L_s * per_layer
        # vocab-parallel embed/CE gather over the FULL axis on rep x rows
        per_tick += e * cap * rep * D * (d_s - 1) / d_s  # embed psum_scatter
        per_tick += e * cap * rep * D * (d_s - 1) / d_s  # CE hidden all-gather
        out["ici_bytes"] = ticks * per_tick
        out["p2p_bytes"] = ticks * e * cap_loc * D    # stage hand-off
        if kind == "train":
            # every forward collective transposes once in backward
            # (all_gather <-> reduce_scatter, a2a <-> a2a); checkpointed
            # layers re-run their forward gathers during recompute.
            # stage-aware tables recompute a different depth per (stage,
            # chunk); the mean depth gives the exact aggregate re-gather
            # volume (collapses to l_ckpt for uniform geometries)
            tab = dims.ckpt_table
            if tab is not None:
                vals = [v for row in tab for v in row]
                l_ck = sum(vals) / max(len(vals), 1)
            else:
                l_ck = dims.l_ckpt
            n_layers = max(s.n_layers, 1)
            remat_frac = min(1.0, l_ck * d_p / n_layers)
            out["ici_bytes"] *= (2.0 + remat_frac)
            out["dcn_bytes"] = 2 * s.param_count() * 4 / max(d_s * d_p, 1)
        if zero3_mode == "per_step":
            # one stage-wide gather (+ grad reduce-scatter in train)
            once = L_s * zero_layer_vol * (2.0 if kind == "train" else 1.0)
            out["ici_bytes"] += once
    else:  # decode
        nm, bm = geom.n_micro, geom.bm
        ticks = nm + d_p - 1
        L_s = geom.layers_per_stage
        D = s.d_model
        per_layer = e * (s.param_count() / s.n_layers) * (d_s - 1) / d_s
        per_layer += 4 * bm * s.n_heads * (2 + s.head_dim)  # LSE psum merge
        per_tick = L_s * per_layer + e * bm * D * 2
        out["ici_bytes"] = ticks * per_tick
        out["p2p_bytes"] = ticks * e * bm * D
    return out


# ---------------------------------------------------------------------------

def collective_snapshot() -> dict:
    """The collective counters now (``runtime/sp.KINDS``,
    ``runtime/sharding.ZSTATS``), for :func:`collective_counts`."""
    from repro_torch.runtime import sp
    from repro_torch.runtime.sharding import ZSTATS
    return {"kinds": {k: dict(v) for k, v in sp.KINDS.items()},
            "zero3": {k: ZSTATS[k] for k in ("gathers", "regathers",
                                             "gather_bytes",
                                             "scatter_bytes")}}


def collective_counts(since: dict,
                      handoffs: Sequence[int] = (0, 0)) -> dict:
    """The collectives run since the snapshot ``since``, by kind (the
    reference's ``collective_scan`` kinds in the port's words:
    ``all-gather``, ``reduce-scatter``, ``all-to-all``, ``all-reduce``,
    ``send-recv``; and ``stage hand-off`` from ``handoffs = (count,
    bytes)``, which the caller counts as the executor does), each as
    ``{"count", "bytes"}`` (bytes moved between ranks, ``runtime/sp``'s
    convention); ``zero3``: of them, the ZeRO-3 gathers, re-gathers and
    their bytes and the reduce-scatters' bytes."""
    now = collective_snapshot()
    out: Dict[str, dict] = {}
    for kind, rec in now["kinds"].items():
        was = since["kinds"].get(kind, {"count": 0, "bytes": 0})
        d = {k: rec[k] - was[k] for k in ("count", "bytes")}
        if d["count"]:
            out[kind] = d
    if handoffs[0]:
        out["stage hand-off"] = {"count": int(handoffs[0]),
                                 "bytes": int(handoffs[1])}
    out["zero3"] = {k: now["zero3"][k] - since["zero3"][k]
                    for k in now["zero3"]}
    return out


# ---------------------------------------------------------------------------

def telemetry_report(telemetry_dir: str) -> dict:
    """Digest a run's ``--telemetry-dir``: the timeline JSONL spill(s),
    the per-fingerprint calibration store, and the plan journal.

    Returns one dict per artifact class so tooling can assert on it
    without re-parsing JSONL:

    * ``steps``: count, wall-time mean/p95 per bucket, probed-step count;
    * ``replan``: trigger/decision/swap counts and the swap steps;
    * ``compile``: cold/warm event counts from the cache's timeline hook;
    * ``calibrations``: the persisted store keyed by mesh fingerprint;
    * ``journal_steps``: entries in plans.jsonl (0 = journaling off).
    """
    d = Path(telemetry_dir)
    out: dict = {"dir": str(d), "steps": {"count": 0, "probed": 0},
                 "buckets": {}, "replan": {"triggers": {}, "decisions": {},
                                           "swaps": 0, "swap_steps": []},
                 "compile": {}, "calibrations": {}, "journal_steps": 0}
    walls: dict = {}
    for spill in sorted(d.glob("timeline-*.jsonl")):
        with open(spill) as f:
            for line in f:
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue   # torn tail line of a live run
                kind = ev.get("kind")
                if kind == "step":
                    out["steps"]["count"] += 1
                    if ev.get("probed"):
                        out["steps"]["probed"] += 1
                    walls.setdefault(str(ev.get("bucket")), []).append(
                        float(ev.get("wall_s", 0.0)))
                elif kind == "compile":
                    evt = ev.get("event", "?")
                    out["compile"][evt] = out["compile"].get(evt, 0) + 1
                elif kind == "replan":
                    ph = ev.get("phase")
                    if ph == "trigger":
                        r = ev.get("reason", "?")
                        out["replan"]["triggers"][r] = \
                            out["replan"]["triggers"].get(r, 0) + 1
                    elif ph == "decision":
                        dec = ev.get("decision", "?")
                        out["replan"]["decisions"][dec] = \
                            out["replan"]["decisions"].get(dec, 0) + 1
                        if dec == "swap" and ev.get("mode") == "auto":
                            out["replan"]["swaps"] += 1
                            out["replan"]["swap_steps"].append(
                                int(ev.get("step", -1)))
    for bucket, ws in walls.items():
        ws = sorted(ws)
        out["buckets"][bucket] = {
            "steps": len(ws),
            "wall_s_mean": round(sum(ws) / len(ws), 6),
            "wall_s_p95": round(ws[min(len(ws) - 1,
                                       int(0.95 * len(ws)))], 6)}
    cal = d / "calibration.json"
    if cal.exists():
        try:
            out["calibrations"] = json.loads(cal.read_text())
        except ValueError:
            out["calibrations"] = {}
    journal = d / "plans.jsonl"
    if journal.exists():
        with open(journal) as f:
            out["journal_steps"] = sum(1 for line in f if line.strip())
    return out


def format_telemetry_report(rep: dict) -> str:
    """One-line human summary of :func:`telemetry_report` output."""
    cals = rep.get("calibrations", {})
    vers = {fp: c.get("version") for fp, c in cals.items()}
    return (f"steps={rep['steps']['count']} "
            f"(probed={rep['steps']['probed']}) "
            f"buckets={len(rep['buckets'])} "
            f"swaps={rep['replan']['swaps']}@{rep['replan']['swap_steps']} "
            f"triggers={rep['replan']['triggers']} "
            f"compile={rep['compile']} "
            f"calibrations={vers} journal={rep['journal_steps']}")
