"""Integer linear programming for Alg. 2 — an in-repo replacement for SCIP.

A copy of the JAX package's ``core/ilp.py`` (pure Python and NumPy;
same outputs, which ``tests/test_torch_planner.py`` holds equal).

The checkpointing ILP (Eq. 20) is an integer *covering* program:

    min  sum(x)           s.t.   A x >= b,   0 <= x <= ub,   x integer

with A >= 0 (raising any variable only helps). We solve it exactly with
branch-and-bound over a dense two-phase simplex LP relaxation, warm-started
by a greedy cover. Like the paper's SCIP setup (§V-F), a relative optimality
``gap`` (default 2%) terminates the search early with a certificate.

Problem sizes produced by InfiniPipe are tiny by ILP standards
(n + d_p - 1 <= ~100 variables, a few hundred window constraints), so a
dense NumPy simplex is more than fast enough (<10 ms typical).
"""

from __future__ import annotations

import heapq
import itertools
import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["IlpResult", "solve_cover_ilp", "simplex_lp", "greedy_cover"]

_EPS = 1e-9


@dataclass
class IlpResult:
    status: str                  # "optimal" | "feasible" | "infeasible"
    x: Optional[np.ndarray]      # integer solution (or None)
    objective: float
    lower_bound: float
    nodes: int = 0
    gap: float = 0.0


# ---------------------------------------------------------------------------
# Dense two-phase simplex for:  min c^T x  s.t.  A x >= b, 0 <= x <= ub.
# ---------------------------------------------------------------------------

def simplex_lp(c: np.ndarray, A: np.ndarray, b: np.ndarray,
               ub: np.ndarray, max_iter: int = 20000
               ) -> Tuple[str, Optional[np.ndarray], float]:
    """Two-phase primal simplex (Bland's rule; dense tableau).

    Returns (status, x, objective) with status in {"optimal", "infeasible"}.
    The feasible region is always bounded (box constraints), so "unbounded"
    cannot occur.
    """
    c = np.asarray(c, dtype=np.float64)
    A = np.asarray(A, dtype=np.float64).reshape(-1, c.size)
    b = np.asarray(b, dtype=np.float64)
    ub = np.asarray(ub, dtype=np.float64)
    n = c.size
    m1 = A.shape[0]

    # Standard form rows:
    #   A x - s = b          (surplus s >= 0)          [m1 rows]
    #   x + w   = ub         (slack   w >= 0)          [n  rows]
    # Negative-b covering rows are trivially satisfiable with s; but to get a
    # basic feasible start we add artificials on rows whose rhs > 0 (after
    # making rhs nonnegative).
    m = m1 + n
    ncols = n + m1 + n  # x | s | w
    T = np.zeros((m, ncols))
    rhs = np.zeros(m)
    T[:m1, :n] = A
    T[:m1, n:n + m1] = -np.eye(m1)
    rhs[:m1] = b
    T[m1:, :n] = np.eye(n)
    T[m1:, n + m1:] = np.eye(n)
    rhs[m1:] = ub

    # Make all rhs >= 0.
    neg = rhs < 0
    T[neg] *= -1.0
    rhs[neg] *= -1.0

    # Choose an initial basis: prefer natural slack columns where they carry
    # +1 coefficient; otherwise artificials.
    basis = np.full(m, -1, dtype=np.int64)
    art_cols: List[int] = []
    full = np.hstack([T, np.zeros((m, 0))])
    for i in range(m):
        # natural candidate: the surplus/slack column of this row if its sign
        # ended up +1 after the flip.
        cand = n + i if i < m1 else n + m1 + (i - m1)
        if full[i, cand] > 0.5:
            basis[i] = cand
        else:
            art_cols.append(i)
    n_art = len(art_cols)
    if n_art:
        art = np.zeros((m, n_art))
        for j, i in enumerate(art_cols):
            art[i, j] = 1.0
            basis[i] = ncols + j
        full = np.hstack([full, art])

    def _pivot(tab: np.ndarray, rhs_: np.ndarray, basis_: np.ndarray,
               obj: np.ndarray, obj_rhs: List[float], max_it: int,
               ban_from: Optional[int] = None) -> str:
        """``ban_from``: columns >= ban_from (phase-1 artificials) are barred
        from re-entering the basis once they leave it."""
        stall = 0
        banned = np.zeros(tab.shape[1], dtype=bool)
        for it in range(max_it):
            # Dantzig rule (vectorized); fall back to Bland's rule when the
            # objective stalls, which guarantees anti-cycling.
            cand_obj = np.where(banned, 0.0, obj)
            if stall < 40:
                enter = int(np.argmin(cand_obj))
                if cand_obj[enter] >= -_EPS:
                    return "optimal"
            else:
                neg = np.nonzero(cand_obj < -_EPS)[0]
                if neg.size == 0:
                    return "optimal"
                enter = int(neg[0])
            # vectorized ratio test
            col = tab[:, enter]
            mask = col > _EPS
            if not mask.any():
                return "unbounded"
            ratios = np.full(tab.shape[0], np.inf)
            ratios[mask] = rhs_[mask] / col[mask]
            best = ratios.min()
            ties = np.nonzero(ratios <= best + _EPS)[0]
            leave = int(ties[np.argmin(basis_[ties])])  # Bland tie-break
            piv = tab[leave, enter]
            tab[leave] /= piv
            rhs_[leave] /= piv
            factors = tab[:, enter].copy()
            factors[leave] = 0.0
            nz = np.abs(factors) > _EPS
            if nz.any():
                tab[nz] -= factors[nz, None] * tab[leave]
                rhs_[nz] -= factors[nz] * rhs_[leave]
            f = obj[enter]
            before = obj_rhs[0]
            if abs(f) > _EPS:
                obj -= f * tab[leave]
                obj_rhs[0] -= f * rhs_[leave]
            stall = stall + 1 if abs(obj_rhs[0] - before) <= _EPS else 0
            if ban_from is not None and basis_[leave] >= ban_from:
                banned[basis_[leave]] = True
            basis_[leave] = enter
        return "maxiter"

    # ---- phase 1: minimize sum of artificials ----
    if n_art:
        obj1 = np.zeros(full.shape[1])
        obj1[ncols:] = 1.0
        obj_rhs = [0.0]
        # price out the basic artificials
        for i in range(m):
            if basis[i] >= ncols:
                obj1 -= full[i]
                obj_rhs[0] -= rhs[i]
        st = _pivot(full, rhs, basis, obj1, obj_rhs, max_iter, ban_from=ncols)
        art_sum = float(sum(rhs[i] for i in range(m) if basis[i] >= ncols))
        if st == "maxiter" or art_sum > 1e-6:
            return "infeasible", None, math.inf
        # drive remaining artificials out of the basis if possible
        for i in range(m):
            if basis[i] >= ncols:
                for j in range(ncols):
                    if abs(full[i, j]) > 1e-7:
                        piv = full[i, j]
                        full[i] /= piv
                        rhs[i] /= piv
                        for r in range(m):
                            if r != i and abs(full[r, j]) > _EPS:
                                f = full[r, j]
                                full[r] -= f * full[i]
                                rhs[r] -= f * rhs[i]
                        basis[i] = j
                        break
        full = full[:, :ncols]

    # ---- phase 2 ----
    obj2 = np.zeros(full.shape[1])
    obj2[:n] = c
    obj_rhs = [0.0]
    for i in range(m):
        if basis[i] < full.shape[1] and abs(obj2[basis[i]]) > _EPS:
            f = obj2[basis[i]]
            obj2 -= f * full[i]
            obj_rhs[0] -= f * rhs[i]
    st = _pivot(full, rhs, basis, obj2, obj_rhs, max_iter)
    if st != "optimal":
        return "infeasible", None, math.inf
    x = np.zeros(n)
    for i in range(m):
        if basis[i] < n:
            x[basis[i]] = rhs[i]
    # Defensive verification: a correct run always satisfies these.
    tol = 1e-6 * max(1.0, float(np.abs(b).max() if b.size else 1.0))
    if ((x < -1e-7).any() or (x > ub + 1e-7).any()
            or (A @ x - b < -tol).any()):  # pragma: no cover
        raise RuntimeError("simplex returned an infeasible vertex — "
                           "numerical failure")
    return "optimal", np.clip(x, 0.0, ub), float(c @ x)


# ---------------------------------------------------------------------------
# Greedy cover: fast feasible incumbent for the B&B.
# ---------------------------------------------------------------------------

def greedy_cover(A: np.ndarray, b: np.ndarray, ub: np.ndarray
                 ) -> Optional[np.ndarray]:
    """Greedy integer cover for  A x >= b, 0 <= x <= ub  (A >= 0)."""
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    n = A.shape[1]
    x = np.zeros(n)
    resid = b - A @ x
    for _ in range(int(np.sum(ub)) + n + 8):
        viol = resid > 1e-9
        if not viol.any():
            return x
        # score: total violated-residual reduction per unit of each variable
        head = np.minimum(A[viol], resid[viol, None])
        score = head.sum(axis=0)
        score[x >= ub - 1e-9] = -1.0
        j = int(np.argmax(score))
        if score[j] <= 0:
            return None  # saturated but still violated => infeasible
        # raise x_j as much as useful (cover the largest violated row it serves)
        need = 0.0
        for i in np.nonzero(viol)[0]:
            if A[i, j] > 1e-12:
                need = max(need, resid[i] / A[i, j])
        step = min(math.ceil(need - 1e-12), ub[j] - x[j])
        step = max(step, 1.0)
        x[j] = min(ub[j], x[j] + step)
        resid = b - A @ x
    return None


def _reduce_then_round(xf: np.ndarray, A: np.ndarray, b: np.ndarray,
                       ub: np.ndarray) -> Optional[np.ndarray]:
    """Round an LP solution up, then greedily decrement while feasible."""
    x = np.minimum(np.ceil(xf - 1e-9), ub)
    resid = A @ x - b
    if (resid < -1e-7).any():
        return None
    order = np.argsort(-x)
    for j in order:
        while x[j] > 0:
            col = A[:, j]
            if (resid - col < -1e-9).any():
                break
            x[j] -= 1
            resid = resid - col
    return x


# ---------------------------------------------------------------------------
# Branch and bound.
# ---------------------------------------------------------------------------

def solve_cover_ilp(A: np.ndarray, b: np.ndarray, ub: np.ndarray, *,
                    gap: float = 0.02, max_nodes: int = 2000) -> IlpResult:
    """Exact-to-``gap`` solver for  min sum(x) s.t. A x >= b, 0<=x<=ub, x∈Z."""
    A = np.atleast_2d(np.asarray(A, dtype=np.float64))
    b = np.asarray(b, dtype=np.float64).ravel()
    ub = np.asarray(ub, dtype=np.float64).ravel()
    n = ub.size
    if A.size == 0 or not (b > 1e-9).any():
        return IlpResult("optimal", np.zeros(n), 0.0, 0.0)
    # drop trivially satisfied rows
    keep = b > 1e-9
    A, b = A[keep], b[keep]
    # quick infeasibility check: even x == ub violates some row
    if (A @ ub - b < -1e-7).any():
        return IlpResult("infeasible", None, math.inf, math.inf)

    # Row equilibration: memory constraints mix ~1e9 rhs with ~1e6
    # coefficients; scaling each row by its largest entry keeps the simplex
    # well-conditioned. The feasible set (and integer optimum) is unchanged.
    scale = np.maximum(np.abs(A).max(axis=1), np.abs(b))
    scale[scale <= 0] = 1.0
    A = A / scale[:, None]
    b = b / scale

    c = np.ones(n)
    incumbent = greedy_cover(A, b, ub)
    best_obj = float(incumbent.sum()) if incumbent is not None else math.inf

    # node = (lp_bound, counter, lb_vec, ub_vec)
    counter = itertools.count()
    status0, x0, obj0 = simplex_lp(c, A, b, ub)
    if status0 != "optimal":
        if incumbent is not None:  # LP numeric trouble but greedy worked
            return IlpResult("feasible", incumbent, best_obj, 0.0)
        return IlpResult("infeasible", None, math.inf, math.inf)

    rounded = _reduce_then_round(x0, A, b, ub)
    if rounded is not None and rounded.sum() < best_obj:
        incumbent, best_obj = rounded, float(rounded.sum())

    heap: List[Tuple[float, int, np.ndarray, np.ndarray]] = [
        (obj0, next(counter), np.zeros(n), ub.copy())]
    nodes = 0
    global_lb = obj0
    while heap and nodes < max_nodes:
        lb_bound, _, lo, hi = heapq.heappop(heap)
        global_lb = lb_bound
        # Integral objective (c == 1): an absolute gap < 1 certifies optimality.
        if (best_obj <= 1e-12
                or best_obj - lb_bound < 1.0 - 1e-9
                or (best_obj - lb_bound) <= gap * max(best_obj, 1.0)):
            break
        nodes += 1
        # re-solve with node bounds: substitute x = lo + y, 0 <= y <= hi - lo
        span = hi - lo
        bb = b - A @ lo
        status, y, obj = simplex_lp(c, A, bb, span)
        if status != "optimal":
            continue
        obj += float(lo.sum())
        if obj >= best_obj - 1e-9:
            continue
        x = lo + y
        frac = np.abs(x - np.round(x))
        j = int(np.argmax(frac))
        if frac[j] < 1e-6:
            xi = np.round(x)
            if (A @ xi - b >= -1e-7).all() and xi.sum() < best_obj:
                incumbent, best_obj = xi, float(xi.sum())
            continue
        rounded = _reduce_then_round(x, A, b, ub)
        if rounded is not None and rounded.sum() < best_obj:
            incumbent, best_obj = rounded, float(rounded.sum())
        floor_v = math.floor(x[j])
        hi2 = hi.copy(); hi2[j] = floor_v
        lo2 = lo.copy(); lo2[j] = floor_v + 1
        if hi2[j] >= lo[j] - 1e-9:
            heapq.heappush(heap, (obj, next(counter), lo.copy(), hi2))
        if lo2[j] <= hi[j] + 1e-9:
            heapq.heappush(heap, (obj, next(counter), lo2, hi.copy()))

    if incumbent is None:
        return IlpResult("infeasible", None, math.inf, math.inf, nodes=nodes)
    lb = min(global_lb, best_obj)
    rel_gap = (best_obj - lb) / max(best_obj, 1.0)
    status = "optimal" if rel_gap <= gap + 1e-9 else "feasible"
    return IlpResult(status, incumbent, best_obj, lb, nodes=nodes, gap=rel_gap)
