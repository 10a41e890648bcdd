"""Port parity: the MoE block against the JAX package's ``models/moe.py``.

Reduced olmoe-1b-7b (4 experts, top-2, d_model 64) and, for the shared
experts, a reduced deepseek-v2-lite's MoE parameters at the module level
(no MLA needed there); a wider variant (16 experts, top-4, 24 tokens)
leaves some experts empty. The JAX init is bridged through the port's
layout (``[d_out, d_in]``, the last two axes swapped); inputs are numpy
draws from fixed seeds. Tolerances:

* router picks equal exactly and their weights within ``1e-6`` (float32,
  the same input);
* the dispatched block against ``moe_apply_dense`` of the JAX package and
  its gradients against ``jax.grad`` of it: ``rtol = 1e-5, atol = 1e-6``
  (float32 sums taken in another order);
* against the port's own ``moe_apply_dense``: float32 ``rtol = atol =
  1e-6``; bf16 within two units of the last place of each tensor's
  largest value (``2^-6`` of it: the dense version sums the experts'
  input gradients in bf16 under autograd, the dispatch in float32);
* an expert's pairs in blocks of rows: within ``rtol = atol = 1e-6`` of
  one block;
* a repeat and the split backward's store: the same bits; an empty
  expert: zero gradients for its weights, the rest within ``rtol =
  1e-5, atol = 1e-6`` of the dense version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import moe as jmoe
from repro_torch.configs import get_arch
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import deferred_weight_grads
from repro_torch.models.model import tree_leaves
from repro_torch.weights import DENSE_LEAVES
from test_torch_threads import torch_thread_share  # noqa: F401

JAX_TOL = dict(rtol=1e-5, atol=1e-6)


def _cfgs(name):
    """The JAX and port configs of ``name`` reduced (deepseek-v2-lite: 4
    experts, top-2, 1 shared expert)."""
    if name == "olmoe-wide":
        kw = dict(n_experts=16, top_k=4)
        j, t = (c.reduced() for c in (jax_get_arch("olmoe-1b-7b"),
                                      get_arch("olmoe-1b-7b")))
        return (dataclasses.replace(j, spec=dataclasses.replace(j.spec, **kw)),
                dataclasses.replace(t, spec=dataclasses.replace(t.spec, **kw)))
    return jax_get_arch(name).reduced(), get_arch(name).reduced()


def _to_port(tree, name=""):
    if isinstance(tree, dict):
        return {k: _to_port(v, k) for k, v in tree.items()}
    a = np.asarray(tree)
    if name in DENSE_LEAVES:
        a = np.swapaxes(a, -1, -2)
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _to_jax_layout(tree, name=""):
    if isinstance(tree, dict):
        return {k: _to_jax_layout(v, k) for k, v in tree.items()}
    a = tree.detach().float().numpy()
    return np.swapaxes(a, -1, -2) if name in DENSE_LEAVES else a


@pytest.fixture(scope="module",
                params=["olmoe-1b-7b", "deepseek-v2-lite", "olmoe-wide"])
def block(request):
    jcfg, tcfg = _cfgs(request.param)
    assert jcfg.spec.n_experts == tcfg.spec.n_experts
    raw = jax.tree.map(np.asarray, jmoe.init_moe(jcfg, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(4)
    T = 24 if request.param == "olmoe-wide" else 40
    x = rng.standard_normal((T, jcfg.spec.d_model)).astype(np.float32)
    dy = rng.standard_normal((T, jcfg.spec.d_model)).astype(np.float32)
    return request.param, jcfg, tcfg, raw, x, dy


def _leaf_params(raw, dtype=torch.float32):
    p = _to_port(raw)

    def live(t):
        if isinstance(t, dict):
            return {k: live(v) for k, v in t.items()}
        return t.to(dtype).requires_grad_(True)
    return live(p)


def _run(fn, cfg, p, x, dy, dtype=torch.float32):
    """Forward and backward of ``fn(cfg, p, x)`` seeded with ``dy``:
    (output, dx, parameter gradients in ``tree_leaves`` order)."""
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    out = fn(cfg, p, xt)
    out.backward(torch.from_numpy(dy).to(dtype))
    grads = [a.grad for a in tree_leaves(p)]
    for a in tree_leaves(p):
        a.grad = None
    return out.detach(), xt.grad, grads


def test_router_picks_equal_jax(block):
    _, jcfg, tcfg, raw, x, _ = block
    jw, ji = jmoe.router_weights(jcfg, raw, jnp.asarray(x))
    tw, ti = tmoe.router_weights(tcfg, _to_port(raw), torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_allclose(np.asarray(jw), tw.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_moe_apply_equals_jax_dense(block):
    _, jcfg, tcfg, raw, x, _ = block
    want = jmoe.moe_apply_dense(jcfg, raw, jnp.asarray(x))
    got = tmoe.moe_apply(tcfg, _to_port(raw), torch.from_numpy(x))
    np.testing.assert_allclose(np.asarray(want), got.numpy(), **JAX_TOL)


def test_gradients_equal_jax_grad_of_dense(block):
    _, jcfg, tcfg, raw, x, dy = block

    def f(p, xx):
        return jnp.sum(jmoe.moe_apply_dense(jcfg, p, xx) * jnp.asarray(dy))
    jgp, jgx = jax.grad(f, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, raw), jnp.asarray(x))
    p = _leaf_params(raw)
    _, dx, grads = _run(tmoe.moe_apply, tcfg, p, x, dy)
    np.testing.assert_allclose(np.asarray(jgx), dx.numpy(), **JAX_TOL)
    got = _to_jax_layout(
        jax.tree.unflatten(jax.tree.structure(jax.tree.map(
            lambda a: 0, _to_port(raw))), grads))
    for a, b in zip(jax.tree.leaves(jgp), jax.tree.leaves(got)):
        np.testing.assert_allclose(np.asarray(a), b, **JAX_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dispatch_equals_own_dense(block, dtype):
    _, _, tcfg, raw, x, dy = block
    a = _run(tmoe.moe_apply, tcfg, _leaf_params(raw, dtype), x, dy, dtype)
    b = _run(tmoe.moe_apply_dense, tcfg, _leaf_params(raw, dtype), x, dy,
             dtype)
    for u, v in zip([a[0], a[1], *a[2]], [b[0], b[1], *b[2]]):
        assert u.dtype == v.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(u, v, rtol=1e-6, atol=1e-6)
        else:
            err = float((u.float() - v.float()).abs().max())
            assert err <= 2 ** -6 * float(v.float().abs().max()), err


def test_repeat_gives_the_same_bits(block):
    _, _, tcfg, raw, x, dy = block
    for dtype in (torch.float32, torch.bfloat16):
        p = _leaf_params(raw, dtype)
        a, b = (_run(tmoe.moe_apply, tcfg, p, x, dy, dtype)
                for _ in range(2))
        for u, v in zip([a[0], a[1], *a[2]], [b[0], b[1], *b[2]]):
            assert torch.equal(u, v)


def test_weight_grad_store_takes_one_entry_per_leaf(block):
    """Under ``deferred_weight_grads`` the backward leaves the four routed
    leaves' gradients (each a whole stacked leaf) and the shared block's to
    the store, one entry per leaf; each product is the fused backward's
    gradient, and ``dx`` the fused one, bit for bit."""
    name, _, tcfg, raw, x, dy = block
    p = _leaf_params(raw)
    fused = _run(tmoe.moe_apply, tcfg, p, x, dy)
    store = []
    xt = torch.from_numpy(x).requires_grad_(True)
    with deferred_weight_grads(store):
        out = tmoe.moe_apply(tcfg, p, xt)
        out.backward(torch.from_numpy(dy))
    assert torch.equal(out.detach(), fused[0])
    assert torch.equal(xt.grad, fused[1])
    assert all(a.grad is None for a in tree_leaves(p))
    leaves = tree_leaves(p)
    assert sorted(id(w) for w, _ in store) == sorted(id(a) for a in leaves)
    want = {id(a): g for a, g in zip(leaves, fused[2])}
    for w, product in store:
        got = product()
        assert got.shape == w.shape and torch.equal(got, want[id(w)])
    assert len(store) == (7 if name == "deepseek-v2-lite" else 4)


def test_expert_row_blocks(block, monkeypatch):
    """Each expert's pairs run in blocks of rows (here 5): the block
    equals the unblocked one within float32 rounding, the split store
    still gives the fused bits, and each block issues its own products."""
    _, _, tcfg, raw, x, dy = block
    whole = _run(tmoe.moe_apply, tcfg, _leaf_params(raw), x, dy)
    width = max(tcfg.spec.d_model, tcfg.spec.d_ff_expert)
    monkeypatch.setattr(tmoe, "EXPERT_BLOCK_BYTES", 5 * 4 * width)
    seen = []
    before = dict(tmoe.COUNTS)
    p = _leaf_params(raw)
    with tmoe.observe_router(lambda r, lg, ids, sizes: seen.append(sizes)):
        blocked = _run(tmoe.moe_apply, tcfg, p, x, dy)
    n_blocks = sum(-(-n // 5) for n in seen[0])
    assert n_blocks > sum(1 for n in seen[0] if n)
    assert (tmoe.COUNTS["expert_matmuls"] - before["expert_matmuls"]
            == 10 * n_blocks)
    for u, v in zip([whole[0], whole[1], *whole[2]],
                    [blocked[0], blocked[1], *blocked[2]]):
        torch.testing.assert_close(u, v, rtol=1e-6, atol=1e-6)
    store = []
    xt = torch.from_numpy(x).requires_grad_(True)
    with deferred_weight_grads(store):
        tmoe.moe_apply(tcfg, p, xt).backward(torch.from_numpy(dy))
    assert torch.equal(xt.grad, blocked[1])
    want = {id(a): g for a, g in zip(tree_leaves(p), blocked[2])}
    for w, product in store:
        assert torch.equal(product(), want[id(w)])


def test_empty_expert(block):
    """An expert no token picks launches nothing, its weights' gradients
    are zero, and the block still equals the dense one."""
    _, _, tcfg, raw, x, dy = block
    raw = jax.tree.map(np.array, raw)
    E = tcfg.spec.n_experts
    raw["router"][:, E - 1] = -1.0      # logit -sum(x): never in the top k
    x = np.abs(x)
    seen = []
    p = _leaf_params(raw)
    before = dict(tmoe.COUNTS)
    with tmoe.observe_router(lambda r, lg, ids, sizes: seen.append(sizes)):
        a = _run(tmoe.moe_apply, tcfg, p, x, dy)
    (sizes,) = seen
    assert sizes[E - 1] == 0 and sum(sizes) == len(x) * tcfg.spec.top_k
    used = sum(1 for n in sizes if n)
    assert tmoe.COUNTS["host_syncs"] - before["host_syncs"] == 1
    assert (tmoe.COUNTS["expert_matmuls"] - before["expert_matmuls"]
            == 10 * used)
    names = [k if k != "shared" else f"shared.{j}"
             for k in sorted(p) for j in (sorted(p[k]) if k == "shared"
                                          else [k])]
    grads = dict(zip(names, a[2]))
    for k in ("w_gate", "w_up", "w_down"):
        assert not grads[k][E - 1].any()
        assert grads[k][:E - 1].abs().sum() > 0
    b = _run(tmoe.moe_apply_dense, tcfg, _leaf_params(raw), x, dy)
    for u, v in zip([a[0], a[1], *a[2]], [b[0], b[1], *b[2]]):
        torch.testing.assert_close(u, v, **JAX_TOL)


def test_router_fault_falls_outside_the_tolerance(block, monkeypatch):
    """The fault ``chip_smoke.py`` plants (the router's (k+1)-th pick in
    place of its k-th) moves the block by far more than the tolerance."""
    _, _, tcfg, raw, x, _ = block
    good = tmoe.moe_apply(tcfg, _to_port(raw), torch.from_numpy(x))
    k = tcfg.spec.top_k

    def shifted(logits, kk):
        top, ids = torch.topk(logits, kk + 1, dim=-1)
        keep = list(range(kk - 1)) + [kk]
        return torch.softmax(top[:, keep], dim=-1), ids[:, keep]
    monkeypatch.setattr(tmoe, "route", shifted)
    bad = tmoe.moe_apply(tcfg, _to_port(raw), torch.from_numpy(x))
    assert k < tcfg.spec.n_experts
    assert float((bad - good).abs().max()) > 1e3 * JAX_TOL["atol"]


def test_init_draws_from_its_generator_on_its_device():
    cfg = get_arch("olmoe-1b-7b").reduced()
    s = cfg.spec
    a, b = (tmoe.init_moe(cfg, torch.Generator().manual_seed(7),
                          device="cpu") for _ in range(2))
    for u, v in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(u, v)
    assert a["router"].shape == (s.n_experts, s.d_model)
    assert a["w_gate"].shape == a["w_up"].shape == (
        s.n_experts, s.d_ff_expert, s.d_model)
    assert a["w_down"].shape == (s.n_experts, s.d_model, s.d_ff_expert)
    assert "shared" not in a
