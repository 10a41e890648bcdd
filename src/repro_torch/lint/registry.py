"""Pass registry of the plan auditor (the plan half of the JAX package's
``lint/registry.py``).

A pass runs on solver output (:class:`repro_torch.core.plan.ExecutionPlan`
and the pipeline geometry) before a plan runs; it is pure Python and
cheap enough to run on every new bucket. Adding a pass::

    @register_pass("plan-my-check", doc="one-line description")
    def _my_check(ctx, report):
        ...
        report.add("plan-my-check", SEV_ERROR, "what went wrong")

The pass function mutates the report; it must not raise for findings
(raising is reserved for broken inputs, which ``run_plan_checks`` turns
into an error finding rather than crashing the host).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

__all__ = ["LintPass", "register_pass", "get_pass", "available_passes"]


@dataclass(frozen=True)
class LintPass:
    name: str
    doc: str
    fn: Callable


_PASSES: Dict[str, LintPass] = {}


def register_pass(name: str, *, doc: str = "") -> Callable:
    def deco(fn: Callable) -> Callable:
        if name in _PASSES:
            raise ValueError(f"lint pass {name!r} already registered")
        _PASSES[name] = LintPass(name=name,
                                 doc=doc or (fn.__doc__ or "").strip(),
                                 fn=fn)
        return fn
    return deco


def get_pass(name: str) -> LintPass:
    try:
        return _PASSES[name]
    except KeyError:
        raise ValueError(f"unknown lint pass {name!r}; known: "
                         f"{sorted(_PASSES)}")


def available_passes() -> Tuple[LintPass, ...]:
    return tuple(_PASSES.values())
