"""Port parity of the pipeline executor on reduced hymba-1.5b at ``d_p =
4``: every schedule, split on and off, against the JAX loss over whole
sequences; the split's and the remat table's bits.

The cases and checks are ``tests/test_torch_pipeline.py``'s (its
docstring says what each holds); this file runs hymba-1.5b's cases at
``d_p = 4`` (``d_p = 2``: ``test_torch_pipeline_hymba.py``), so that
its whole-sequence oracle and runs are computed once, beside the other
pipeline files under ``pytest -n``.
"""

import pytest

from test_torch_pipeline import (SCHEDULES, check_remat_table_bits,
                                 check_split_is_fused,
                                 check_whole_sequences)
from test_torch_threads import torch_thread_share  # noqa: F401

ARCHS = ("hymba-1.5b",)


@pytest.mark.parametrize("split", [False, True], ids=["fused", "split"])
@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("d_p", [4])
@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_matches_whole_sequences(arch, d_p, sched, split):
    check_whole_sequences(arch, d_p, sched, split)


@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("d_p", [4])
@pytest.mark.parametrize("arch", ARCHS)
def test_split_backward_is_the_fused_one(arch, d_p, sched):
    check_split_is_fused(arch, d_p, sched)


@pytest.mark.parametrize("sched", ["interleaved-1f1b", "zero-bubble-h1"])
@pytest.mark.parametrize("d_p", [4])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_table_does_not_change_the_bits(arch, d_p, sched):
    check_remat_table_bits(arch, d_p, sched)
