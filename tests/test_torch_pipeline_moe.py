"""Port parity of the pipeline executor on MoE layers (reduced
olmoe-1b-7b, 4 experts, top-2): ``d_p = 2`` under gpipe-1f1b and
zero-bubble-h1 with the split equals ``ChunkedTrainer`` and the
whole-sequence JAX gradients, and the split equals the fused backward bit
for bit.

The cases and checks are ``tests/test_torch_pipeline.py``'s; this file
runs them beside the other pipeline files under ``pytest -n``.
"""

import pytest

from test_torch_pipeline import check_moe_pipeline, check_moe_split_is_fused
from test_torch_threads import torch_thread_share  # noqa: F401


@pytest.mark.parametrize("sched,split", [("gpipe-1f1b", False),
                                         ("zero-bubble-h1", True)])
def test_moe_pipeline_equals_the_chunked_trainer(sched, split):
    check_moe_pipeline(sched, split)


def test_moe_split_backward_is_the_fused_one():
    check_moe_split_is_fused()
