"""Port parity of the dry-run's prefill and decode cells against the JAX
package's ``launch/dryrun.py`` (the checks of ``test_torch_dryrun.py``,
whose training cells take that module's time): hymba-1.5b ``prefill_32k``
(16x16), olmoe-1b-7b ``decode_32k`` (16x16) and gemma3-1b ``decode_32k``
on two pods (2x16x16, the decode state's pod dim)."""

import pytest

from test_torch_dryrun import check_cell, port_record, reference_records
from test_torch_threads import torch_thread_share  # noqa: F401

CELLS = [("hymba-1.5b", "prefill_32k", False),
         ("olmoe-1b-7b", "decode_32k", False),
         ("gemma3-1b", "decode_32k", True)]


@pytest.fixture(scope="module")
def ref():
    return reference_records(CELLS)


@pytest.mark.parametrize("arch,shape,mp", CELLS)
def test_cell_matches_the_reference(ref, arch, shape, mp):
    rec = port_record(arch, shape, mp)
    check_cell(ref["|".join(map(str, (arch, shape, mp)))], rec, arch, shape,
               mp)
    mem = rec["memory"]
    assert mem["argument_bytes"] == max(mem["argument_bytes_per_stage"])
