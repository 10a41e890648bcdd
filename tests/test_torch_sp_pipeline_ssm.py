"""Port parity of the training step on a sequence-parallel axis for the
SSM families: hybrid hymba-1.5b (allgather_kv, the SSM prefix scan and
the conv halo) and attention-free falcon-mamba-7b (policy ``none`` at
``d_s_eff = 2``: the scan alone shards the tokens), at ``(d_p, d_s)`` in
(1, 2), (2, 2), (1, 4) and at ``d_s_eff < d_s``, under the three
schedules, against the JAX loss over whole sequences; two planted faults
(the conv halo taken from the rank's own rows, the fold skipping a
rank's ``a_prod``) fall outside the limits.

The cases and checks are ``tests/test_torch_sp_pipeline.py``'s (its
docstring says what each holds); this file runs the SSM families'
whole-sequence oracles beside it under ``pytest -n``.
"""

import pytest

from test_torch_sp_pipeline import check_whole, run, within
from test_torch_threads import torch_thread_share  # noqa: F401

CASES = [
    ("hymba-1.5b", 1, 2, "allgather_kv", 2, "gpipe-1f1b"),
    ("hymba-1.5b", 2, 2, "allgather_kv", 2, "zero-bubble-h1"),
    ("hymba-1.5b", 1, 4, "allgather_kv", 4, "interleaved-1f1b"),
    ("hymba-1.5b", 1, 4, "allgather_kv", 2, "zero-bubble-h1"),
    ("falcon-mamba-7b", 1, 2, "none", 2, "gpipe-1f1b"),
    ("falcon-mamba-7b", 1, 4, "none", 4, "zero-bubble-h1"),
    ("falcon-mamba-7b", 2, 2, "none", 1, "interleaved-1f1b"),
]


@pytest.mark.parametrize("arch,d_p,d_s,policy,degree,sched", CASES)
def test_sp_step_matches_whole_sequences(arch, d_p, d_s, policy, degree,
                                         sched):
    check_whole(arch, d_p, d_s, policy, degree, sched)


@pytest.mark.parametrize("fault", ["halo from own rows",
                                   "fold skips a_prod"])
def test_ssm_faults_fall_outside_the_limits(fault):
    key = ("hymba-1.5b", 1, 2, "allgather_kv", 2, "gpipe-1f1b")
    assert within(run(*key), "hymba-1.5b")[2]
    rel, worst, ok = within(run(*key, fault=fault), "hymba-1.5b")
    assert not ok, (fault, rel, worst)
