"""Port parity: the port's host planner against the JAX package's.

For every architecture of the JAX registry (its ``ModelSpec`` copied field
by field into the port's), every length preset of ``data/synth.py`` and a
cluster of ``d_p`` in {1, 2, 4} stages passed explicitly to both packages,
``plan_batch(...).to_json()`` and the ``materialize_plan`` arrays must be
equal (exact: both are the same pure-Python arithmetic). The one field
left out is ``solve_time``, the solver's own wall clock. A batch for which
no plan is feasible must be refused by both.
"""

import dataclasses

import numpy as np
import pytest

from repro.configs import arch_names, get_arch
from repro.core import ClusterSpec as JCluster
from repro.core import CostModel as JCost
from repro.core import PlannerConfig as JConfig
from repro.core import plan_batch as jplan
from repro.data import materialize_plan as jmat
from repro.data import sample_corpus_batch as jcorpus
from repro.data.synth import PRESETS
from repro_torch.core import ClusterSpec, CostModel, ModelSpec, \
    PlannerConfig, plan_batch
from repro_torch.data import materialize_plan, sample_corpus_batch
from test_torch_threads import torch_thread_share  # noqa: F401

# the hardware fields of the port's H100 default, given to both packages
HW = dict(flops_per_chip=989e12, hbm_bytes=80e9, hbm_bw=3.35e12, mfu=0.5,
          mem_fraction=0.92)
LINK = 450e9
NET = 50e9


def _plans(arch, preset, d_p, *, n=8, context=4096, vocab=512, seed=3):
    jspec = get_arch(arch).spec
    spec = ModelSpec(**dataclasses.asdict(jspec))
    jcl = JCluster(d_p=d_p, d_s=1, ici_bw=LINK, dcn_bw=NET, **HW)
    cl = ClusterSpec(d_p=d_p, d_s=1, link_bw=LINK, net_bw=NET, **HW)
    corpus = sample_corpus_batch(preset, n, context, vocab, seed=seed)
    jc = jcorpus(preset, n, context, vocab, seed=seed)
    assert all(np.array_equal(corpus[i], jc[i]) for i in jc)
    lengths = [len(v) for v in corpus.values()]
    cfg = dict(bucket_rounding=256, remat_mode="stage_aware")
    out = []
    for plan_fn, cm, conf in ((jplan, JCost(jspec, jcl), JConfig(**cfg)),
                              (plan_batch, CostModel(spec, cl),
                               PlannerConfig(**cfg))):
        try:
            out.append(plan_fn(cm, lengths, conf))
        except (RuntimeError, ValueError) as e:
            out.append(type(e).__name__)
    return out, corpus, jc


def _json(plan):
    d = plan.to_json()
    d.pop("solve_time")
    return d


@pytest.mark.parametrize("d_p", [1, 2, 4])
@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("arch", arch_names())
def test_plan_json_and_buffers_equal(arch, preset, d_p):
    (jp, tp), corpus, jc = _plans(arch, preset, d_p)
    if isinstance(jp, str) or isinstance(tp, str):
        assert jp == tp, (jp, tp)
        return
    assert _json(tp) == _json(jp)
    a, b = materialize_plan(tp, corpus), jmat(jp, jc)
    for k, v in b.as_dict().items():
        np.testing.assert_array_equal(a.as_dict()[k], v, err_msg=k)
    assert tp.ckpt_table() == jp.ckpt_table()
    assert tp.bucket_key(1) == tuple(jp.bucket_key(1))


def test_h100_defaults():
    cl = ClusterSpec()
    assert (cl.d_p, cl.d_s, cl.hbm_bytes, cl.hbm_bw, cl.flops_per_chip,
            cl.link_bw) == (1, 1, 80e9, 3.35e12, 989e12, 450e9)
