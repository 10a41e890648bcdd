"""Plan auditor: static plan and schedule invariants checked before a plan
runs (the plan passes of the JAX package's ``lint/``; its program passes
read jaxprs and HLO and have no counterpart here).

Entry point: :func:`run_plan_checks` (the training loop runs it the first
time it meets a bucket, and the re-planning controller on each candidate
that would move the bucket).
"""

from .plan_checks import (BUCKET_KEY_AXES, PlanContext,
                          check_bucket_key_completeness,
                          check_ppermute_perm, run_plan_checks)
from .registry import LintPass, available_passes, get_pass, register_pass
from .report import (LINT_MODES, SEV_ERROR, SEV_WARNING, Finding,
                     LintError, LintReport)

__all__ = [
    "Finding", "LintReport", "LintError", "LINT_MODES",
    "SEV_ERROR", "SEV_WARNING",
    "LintPass", "register_pass", "get_pass", "available_passes",
    "PlanContext", "run_plan_checks", "check_ppermute_perm",
    "check_bucket_key_completeness", "BUCKET_KEY_AXES",
]
