"""Mixture-of-Experts block: top-k router, routed experts, shared experts.

Counterpart of the JAX package's ``models/moe.py``. Weights are stored
``[d_out, d_in]``: ``router [E, D]``, ``w_gate`` and ``w_up [E, F, D]``,
``w_down [E, D, F]``, and the optional ``shared`` SwiGLU block (``F`` times
the shared-expert count wide).

* :func:`moe_apply`, the model's path, computes the reference's function
  by dispatch: the (token, pick) pairs are sorted by expert id, each
  non-empty expert runs its SwiGLU over its contiguous range of pairs, and
  each token's k outputs are summed in float32 **in ascending expert
  id**, the order in which the reference's scan over experts adds them.
  Reading the group sizes is one host sync per call (remat recomputes
  included); an empty expert launches nothing.
* :func:`moe_apply_dense` is the plain version, the reference's one-hot
  combine over every expert (64x the tokens' FLOPs at olmoe's 64 experts,
  8x top-8's), for the tests.

The routed part is one autograd function that keeps the block's input
``x`` (once), the routing (``ids``, float32 weights, the sort order) and
the gate and up products ``g``, ``u`` of the ``T·k`` pairs: the gathered
rows, the gated activation and the expert outputs are recomputed in the
backward, so a layer keeps ``D + 2·k·F`` values a token, under the
planner's ``D + 3·k·F + D``; both directions run each expert's pairs in
blocks of rows (EXPERT_BLOCK_BYTES) and the backward holds one block's
row-gradients at a time, its weight products summed in float32 per
expert. The input's gradient sums each token's
row-gradients by a gather, an add and a scatter per expert, in ascending
expert id (unique rows per expert: no atomics, the same bits on every
run). Under :func:`~repro_torch.models.layers.deferred_weight_grads` the
four weight gradients (router, ``w_gate``, ``w_up``, ``w_down``, each a
whole stacked leaf, zero for empty experts) go to the store, one entry
per leaf, which keeps each expert's ``dg``, ``du`` for them; without a
store the backward runs the same products on the same operands.
"""

from __future__ import annotations

import contextlib
import itertools
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .layers import (dense_init, swiglu_apply, swiglu_init, weight_grad_store,
                     weight_key)

__all__ = ["init_moe", "router_logits", "route", "router_weights",
           "moe_apply", "routed_experts", "moe_apply_dense", "observe_router",
           "COUNTS"]

Params = Dict[str, torch.Tensor]

# host counters of the routed path, read and zeroed by their callers: the
# expert products issued (3 per block of a non-empty expert's pairs in a
# forward, 7 in a backward) and the host syncs that read the group sizes
# (one a forward)
COUNTS = {"expert_matmuls": 0, "host_syncs": 0}

# bytes of one float32 [rows, max(D, F)] temporary, which sets the rows of
# an expert's blocks: a random router can send nearly every token to one
# expert (46,371 of 47,231 in a layer of olmoe's first train step), whose
# ~10 float32 temporaries over all its rows would take 3 GB beyond the
# planner's charge; olmoe's blocks are 8,192 rows
EXPERT_BLOCK_BYTES = 2 ** 26

# called as fn(router, logits, ids, sizes) by every routed forward while
# set (observe_router)
_OBSERVER: Optional[Callable] = None


@contextlib.contextmanager
def observe_router(fn: Optional[Callable]):
    """Within the block every routed forward calls ``fn(router, logits,
    ids, sizes)``: the router weight, the float32 logits ``[T, E]``, the
    picks ``[T, k]`` and the pairs per expert (host ints)."""
    global _OBSERVER
    prev, _OBSERVER = _OBSERVER, fn
    try:
        yield
    finally:
        _OBSERVER = prev


def _experts_init(gen: torch.Generator, E: int, d_in: int, d_out: int, *,
                  device, dtype) -> torch.Tensor:
    """``E`` stacked dense weights ``[E, d_out, d_in]``, ``dense_init``'s
    truncated fan-in normal."""
    w = torch.empty((E, d_out, d_in), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def init_moe(cfg: ArchConfig, gen: torch.Generator, *, device,
             dtype=torch.float32) -> Params:
    s = cfg.spec
    D, E, Fe = s.d_model, s.n_experts, s.d_ff_expert
    kw = dict(dtype=dtype, device=device)
    p = {"router": dense_init(gen, D, E, scale=0.02, **kw),
         "w_gate": _experts_init(gen, E, D, Fe, **kw),
         "w_up": _experts_init(gen, E, D, Fe, **kw),
         "w_down": _experts_init(gen, E, Fe, D, **kw)}
    if s.n_shared_experts > 0:
        p["shared"] = swiglu_init(gen, D, Fe * s.n_shared_experts, **kw)
    return p


def router_logits(router: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float32 logits ``[T, E]``."""
    return F.linear(x.float(), router.float())


def route(logits: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of the logits, then a softmax over the k picks: (weights
    ``[T, k]`` float32, expert ids ``[T, k]``), largest logit first."""
    top, ids = torch.topk(logits, k, dim=-1)
    return torch.softmax(top, dim=-1), ids


def router_weights(cfg: ArchConfig, p: Params, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``router_weights``: (weights, expert ids)."""
    return route(router_logits(p["router"], x), cfg.spec.top_k)


def _gated(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``silu(g) * u``, silu in float32 rounded to g's dtype, as the
    reference's ``_expert_ffn`` rounds it."""
    g32 = g.float()
    return (g32 * torch.sigmoid(g32)).to(g.dtype) * u


def _blocks(sizes: List[int], width: int,
            experts: Optional[Tuple[int, int]] = None):
    """``(expert, [(first pair, end), ...])`` of every non-empty expert (of
    the range ``experts``, if given), in ascending expert id, its pairs in
    blocks whose float32 ``[rows, width]`` temporaries take
    EXPERT_BLOCK_BYTES."""
    rows = max(1, EXPERT_BLOCK_BYTES // (4 * width))
    lo, hi = experts or (0, len(sizes))
    a = 0
    for e, n in enumerate(sizes):
        if n and lo <= e < hi:
            yield e, [(c, min(c + rows, a + n))
                      for c in range(a, a + n, rows)]
        a += n


def _add_rows(acc: torch.Tensor, rows: torch.Tensor, val: torch.Tensor):
    """``acc[rows] += val`` for distinct ``rows``: a gather, an add and a
    scatter (no atomics)."""
    acc.index_copy_(0, rows, acc.index_select(0, rows) + val)


def _add_wgrads(parts: List, want, x: torch.Tensor, te: torch.Tensor,
                dg: torch.Tensor, du: torch.Tensor, dy: torch.Tensor,
                h: torch.Tensor) -> None:
    """Adds one block's products ``dz.T @ operand`` to an expert's float32
    sums ``parts`` (gate, up, down) where ``want``: ``dg``, ``du`` against
    the block's rows of x, ``dy`` against its gated activation ``h``."""
    xe = x.index_select(0, te) if want[0] or want[1] else None
    for i, (dz, op) in enumerate(((dg, xe), (du, xe), (dy, h))):
        if want[i]:
            p = dz.t().mm(op).float()
            parts[i] = p if parts[i] is None else parts[i] + p
            COUNTS["expert_matmuls"] += 1


def group_sizes(flat: torch.Tensor, E: int) -> List[int]:
    """The rows routed to each of ``E`` experts from the flat expert ids
    (one host sync). Meta tensors carry no ids: the dry-run takes the
    balanced split, the ``T·k`` rows spread over the experts as evenly as
    they go (the largest group ``ceil(T·k / E)``)."""
    if flat.device.type == "meta":
        q, r = divmod(flat.numel(), E)
        return [q + (e < r) for e in range(E)]
    return torch.bincount(flat, minlength=E).tolist()


class _RoutedExperts(torch.autograd.Function):
    """The routed experts' output ``[T, D]`` in x's dtype (see the module
    docstring); with ``experts = (lo, hi)``, the float32 sum of the experts
    ``[lo, hi)`` alone (expert parallelism, ``runtime/ep.py``)."""

    @staticmethod
    def forward(ctx, x, router, w_gate, w_up, w_down, k, store,
                experts=None):
        dt = x.dtype
        T, D = x.shape
        E, Fe = router.shape[0], w_gate.shape[1]
        # a rank's shard of the experts (ZeRO-3's expert dim): its first
        # expert is the range's
        off = 0 if w_gate.shape[0] == E else experts[0]
        logits = router_logits(router, x)
        w, ids = route(logits, k)
        flat = ids.reshape(-1)
        order = torch.argsort(flat, stable=True)
        sizes = group_sizes(flat, E)
        COUNTS["host_syncs"] += 1
        if _OBSERVER is not None:
            _OBSERVER(router, logits, ids, sizes)
        tok = order // k
        wp = w.reshape(-1).index_select(0, order)
        keep = any(ctx.needs_input_grad[:5])
        g_all = x.new_empty((T * k, Fe)) if keep else None
        u_all = x.new_empty((T * k, Fe)) if keep else None
        acc = torch.zeros((T, D), dtype=torch.float32, device=x.device)
        for e, blocks in _blocks(sizes, max(D, Fe), experts):
            wg, wu, wd = (t[e - off].to(dt) for t in (w_gate, w_up, w_down))
            for a, b in blocks:
                te = tok[a:b]
                xe = x.index_select(0, te)
                g, u = F.linear(xe, wg), F.linear(xe, wu)
                y = F.linear(_gated(g, u), wd)
                COUNTS["expert_matmuls"] += 3
                if keep:
                    g_all[a:b], u_all[a:b] = g, u
                _add_rows(acc, te, y.float() * wp[a:b, None])
        if keep:
            ctx.save_for_backward(x, router, w_gate, w_up, w_down, g_all,
                                  u_all, w, ids, order)
            # the leaves themselves: under remat the saved ones come back
            # as aliases
            ctx.sizes, ctx.store = sizes, store
            ctx.leaves = tuple(weight_key(t) for t in (router, w_gate, w_up,
                                                        w_down))
            ctx.experts, ctx.off = experts, off
        return acc if experts is not None else acc.to(dt)

    @staticmethod
    def backward(ctx, dout):
        (x, router, w_gate, w_up, w_down, g_all, u_all, w, ids,
         order) = ctx.saved_tensors
        sizes, store, off = ctx.sizes, ctx.store, ctx.off
        dt = x.dtype
        T, k = w.shape
        # detached: a closure over a tensor with a graph would hold this
        # node and its store (a cycle the GC cannot see)
        x, dout = x.detach(), dout.detach()
        tok = order // k
        wp = w.reshape(-1).index_select(0, order)
        need = ctx.needs_input_grad[1:5]
        leaves = (w_gate, w_up, w_down)
        grads = [torch.zeros_like(t) if n and store is None else None
                 for t, n in zip(leaves, need[1:])]
        want = [t is not None for t in grads]
        deferred = []   # (expert, first pair, end, dg, du) for the store
        # (pairs of experts outside the range keep a zero weight gradient)
        dw_pairs = (torch.empty if ctx.experts is None else torch.zeros)(
            (T * k,), dtype=torch.float32, device=x.device)
        acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        for e, blocks in _blocks(sizes, max(x.shape[1], g_all.shape[1]),
                                 ctx.experts):
            wg, wu, wd = (t[e - off].to(dt) for t in leaves)
            parts = [None] * 3
            for a, b in blocks:
                te = tok[a:b]
                g, u = g_all[a:b], u_all[a:b]
                g32 = g.float()
                sig = torch.sigmoid(g32)
                s = (g32 * sig).to(dt)
                h = s * u
                y = F.linear(h, wd)
                do = dout.index_select(0, te).float()
                dw_pairs[a:b] = (do * y.float()).sum(-1)
                dy = (do * wp[a:b, None]).to(dt)
                del do, y
                dh = dy.mm(wd)
                du = dh * s
                dg = ((dh * u).float() * sig *
                      (1.0 + g32 * (1.0 - sig))).to(dt)
                del g32, sig, dh
                COUNTS["expert_matmuls"] += 4
                _add_rows(acc, te, (dg.mm(wg) + du.mm(wu)).float())
                if store is None:
                    _add_wgrads(parts, want, x, te, dg, du, dy, h)
                else:
                    deferred.append((e, a, b, dg, du))
            for out, part in zip(grads, parts):
                if out is not None:
                    out[e - off] = part.to(out.dtype)
        # the router: the softmax over the picks, then the logits' product
        dw = torch.empty_like(dw_pairs).index_copy_(0, order, dw_pairs)
        dw = dw.view(T, k)
        dz = w * (dw - (dw * w).sum(-1, keepdim=True))
        dlogits = torch.zeros((T, router.shape[0]), dtype=torch.float32,
                              device=x.device).scatter_(1, ids, dz)
        acc += dlogits.mm(router.float())
        dx = acc.to(dt)
        del acc

        rdt = router.dtype              # (the dtype, not the weight)

        def d_router():
            return dlogits.t().mm(x.float()).to(rdt)
        if store is None:
            return (dx, d_router() if need[0] else None, *grads, None, None,
                    None)

        def d_experts(i):
            # the fused backward's products on the same operands: h and dy
            # recomputed from the saved g, u and the output's gradient
            def product():
                out = torch.zeros_like(leaves[i])
                want = [j == i for j in range(3)]
                for e, group in itertools.groupby(deferred, lambda r: r[0]):
                    parts = [None] * 3
                    for _, a, b, dg, du in group:
                        te = tok[a:b]
                        h = _gated(g_all[a:b], u_all[a:b])
                        dy = (dout.index_select(0, te).float() *
                              wp[a:b, None]).to(dt)
                        _add_wgrads(parts, want, x, te, dg, du, dy, h)
                    out[e - off] = parts[i].to(out.dtype)
                return out
            return product
        store.extend(zip(ctx.leaves, (d_router, d_experts(0), d_experts(1),
                                      d_experts(2))))
        return dx, None, None, None, None, None, None, None


def routed_experts(cfg: ArchConfig, p: Params, x: torch.Tensor, *,
                   experts: Tuple[int, int]) -> torch.Tensor:
    """The float32 sum ``[T, D]`` of the routed experts ``[lo, hi)`` over
    the normed rows ``x``, each token's picks in that range weighted by its
    softmax over all ``top_k`` picks (expert parallelism's share of one
    rank: ``runtime/ep.py``)."""
    return _RoutedExperts.apply(x, p["router"], p["w_gate"], p["w_up"],
                                p["w_down"], cfg.spec.top_k,
                                weight_grad_store(), experts)


def moe_apply(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: [T, D] (the normed hidden rows, compute dtype) -> [T, D]: the
    routed experts by dispatch, then the shared experts."""
    s = cfg.spec
    out = _RoutedExperts.apply(x, p["router"], p["w_gate"], p["w_up"],
                               p["w_down"], s.top_k, weight_grad_store(),
                               None)
    if s.n_shared_experts > 0:
        out = out + swiglu_apply(p["shared"], x)
    return out


def _expert_ffn(w_gate, w_up, w_down, x):
    g = F.linear(x, w_gate.to(x.dtype))
    u = F.linear(x, w_up.to(x.dtype))
    return F.linear(_gated(g, u), w_down.to(x.dtype))


def moe_apply_dense(cfg: ArchConfig, p: Params, x: torch.Tensor
                    ) -> torch.Tensor:
    """The plain version: the reference's dense one-hot combine, every
    expert over every token, summed in ascending expert id (autograd
    throughout; for the tests)."""
    s = cfg.spec
    T, D = x.shape
    w, ids = router_weights(cfg, p, x)
    combine = torch.zeros((T, s.n_experts), dtype=torch.float32,
                          device=x.device).scatter_add(1, ids, w)
    acc = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    for e in range(s.n_experts):
        y = _expert_ffn(p["w_gate"][e], p["w_up"][e], p["w_down"][e], x)
        acc = acc + y.float() * combine[:, e:e + 1]
    out = acc.to(x.dtype)
    if s.n_shared_experts > 0:
        sh = p["shared"]
        out = out + _expert_ffn(sh["w_gate"], sh["w_up"], sh["w_down"], x)
    return out
