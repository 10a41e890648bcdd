"""Port parity: the port's cross-entropy (the plain versions of kernels B,
C1 and C2, the autograd function ``ops.fused_cross_entropy`` and the two
loss oracles) against the JAX package's Pallas kernels in interpret mode
and ``jax.grad`` of ``ref.cross_entropy_reference``, at the shapes of
``tests/test_kernels.py`` (ragged vocabularies, ``valid`` masks, bf16 and
float32 inputs rounded identically in both frameworks).

Tolerances: ``lse`` and the target logit ``rtol = atol = 1e-5`` (float32
sums in another order; bf16 inputs are upcast exactly in both); losses
``rtol 1e-5``; gradients ``rtol 1e-4, atol 1e-5`` (those of the JAX
package's own CE tests). The CUDA kernels are held against the plain
versions on the card in ``tests/test_torch_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.cross_entropy import (cross_entropy_bwd_dh_pallas,
                                         cross_entropy_bwd_dw_pallas,
                                         cross_entropy_fwd_pallas)
from repro.kernels.ops import fused_cross_entropy as jfused
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(T, D, V, seed, scale, dtype="float32"):
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((T, D)) * scale).astype(np.float32)
    w = (rng.standard_normal((V, D)) * scale).astype(np.float32)
    tgt = rng.integers(0, V, T).astype(np.int32)
    jh, jw = jnp.asarray(h, JDT[dtype]), jnp.asarray(w, JDT[dtype])
    th = torch.from_numpy(h).to(TDT[dtype])
    tw = torch.from_numpy(w).to(TDT[dtype])
    return (jh, jw, jnp.asarray(tgt)), (th, tw, torch.from_numpy(tgt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,D,V", [(32, 16, 100), (64, 32, 1000),
                                   (128, 64, 517)])
def test_forward_matches_pallas_and_oracle(dtype, T, D, V):
    (jh, jw, jt), (th, tw, tt) = _inputs(T, D, V, T + V, 0.5, dtype)
    valid = np.arange(T) % 5 != 0
    lse_p, tl_p = cross_entropy_fwd_pallas(jh, jw, jt, jnp.asarray(valid),
                                           block_t=16, block_v=64,
                                           interpret=True)
    lse, tl = tref.cross_entropy_fwd_plain(th, tw, tt)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_p), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(tl_p), rtol=1e-5,
                               atol=1e-5)
    want, n = jref.cross_entropy_reference(jh, jw, jt, jnp.asarray(valid))
    tv = torch.from_numpy(valid)
    for fn in (tref.cross_entropy_reference, tref.streaming_cross_entropy,
               ops.fused_cross_entropy):
        s, c = fn(th, tw, tt, tv)
        np.testing.assert_allclose(float(s), float(want), rtol=1e-5)
        assert float(c) == float(n)


def test_backward_matches_pallas_and_autodiff():
    (jh, jw, jt), (th, tw, tt) = _inputs(48, 24, 301, 5, 0.3)
    valid = np.arange(48) % 3 != 1

    def loss_ref(h, w):
        return jref.cross_entropy_reference(h, w, jt, jnp.asarray(valid))[0]
    dh_r, dw_r = jax.grad(loss_ref, argnums=(0, 1))(jh, jw)
    lse, _ = cross_entropy_fwd_pallas(jh, jw, jt, jnp.asarray(valid),
                                      block_t=16, block_v=64, interpret=True)
    g_rows = jnp.asarray(valid, jnp.float32)
    dh_p = cross_entropy_bwd_dh_pallas(jh, jw, jt, lse, g_rows, block_t=16,
                                       block_v=64, interpret=True)
    dw_p = cross_entropy_bwd_dw_pallas(jh, jw, jt, lse, g_rows, block_t=16,
                                       block_v=64, interpret=True)
    t_lse = torch.from_numpy(np.asarray(lse))
    t_g = torch.from_numpy(np.asarray(g_rows))
    dh = tref.cross_entropy_bwd_dh_plain(th, tw, tt, t_lse, t_g)
    dw = tref.cross_entropy_bwd_dw_plain(th, tw, tt, t_lse, t_g)
    for got, pal, auto in ((dh, dh_p, dh_r), (dw, dw_p, dw_r)):
        np.testing.assert_allclose(got.numpy(), np.asarray(pal), **GRAD_TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(auto), **GRAD_TOL)


@pytest.mark.parametrize("all_valid", [True, False])
def test_fused_gradients_match_jax(all_valid):
    """Mean loss and its gradients through ``ops.fused_cross_entropy`` (T =
    40 is padded to the kernels' 64-row multiple) against JAX's
    ``fused_cross_entropy(use_pallas=True)`` and autodiff of the naive
    reference."""
    (jh, jw, jt), (th, tw, tt) = _inputs(40, 16, 130, 9, 0.3)
    valid = np.ones(40, bool) if all_valid else np.arange(40) % 4 != 2
    jv = jnp.asarray(valid)

    def mean_p(h, w):
        s, n = jfused(h, w, jt, jv, block_t=16, block_v=64, use_pallas=True)
        return s / n

    def mean_r(h, w):
        s, n = jref.cross_entropy_reference(h, w, jt, jv)
        return s / n
    lp, gp = jax.value_and_grad(mean_p, argnums=(0, 1))(jh, jw)
    lr, gr = jax.value_and_grad(mean_r, argnums=(0, 1))(jh, jw)
    h, w = th.clone().requires_grad_(True), tw.clone().requires_grad_(True)
    before = ops.fused_cross_entropy.plain_calls
    s, n = ops.fused_cross_entropy(h, w, tt, torch.from_numpy(valid))
    (s / n).backward()
    assert ops.fused_cross_entropy.plain_calls == before + 2  # fwd + bwd
    for want_l in (lp, lr):
        np.testing.assert_allclose(float(s / n), float(want_l), rtol=1e-5)
    for got, want in ((h.grad, gp[0]), (w.grad, gp[1]), (h.grad, gr[0]),
                      (w.grad, gr[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


def test_targets_outside_the_vocabulary_never_match():
    """A target of -1 (padding) or >= V contributes no target logit and no
    one-hot term, as in the kernels."""
    th = torch.randn(6, 8)
    tw = torch.randn(10, 8)
    tt = torch.tensor([0, -1, 9, 10, 3, -1], dtype=torch.int32)
    lse, tl = tref.cross_entropy_fwd_plain(th, tw, tt)
    assert tl[1] == 0 and tl[3] == 0 and tl[0] != 0
    g = torch.ones(6)
    dh = tref.cross_entropy_bwd_dh_plain(th, tw, tt, lse, g)
    p = torch.softmax(th @ tw.T, dim=-1)
    np.testing.assert_allclose(dh[1].numpy(), (p[1] @ tw).numpy(),
                               rtol=1e-5, atol=1e-6)
