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
from test_torch_threads import torch_thread_share  # noqa: F401

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


# ---------------------------------------------------------------------------
# The tensor-core kernels (bf16 B and C1) and their launch geometry
# ---------------------------------------------------------------------------

# chip_smoke.py's bf16 limit (its TOL["bfloat16"]), with atol scaled by the
# largest |want| as it scales it for gradients
BF16_TOL = dict(rtol=1e-2, atol=4e-3)


def _close_scaled(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) or 1.0
    err = np.abs(got - want)
    assert (err <= tol["atol"] * scale + tol["rtol"] * np.abs(want)).all(), \
        (float(err.max()), scale)
    return float(err.max())


def _dh_rounded_coef(hidden, w, targets, lse, g_rows):
    """C1 as the bf16 kernel computes it: the coefficient formed in float32,
    rounded to bf16 as the second product's operand, products with W's
    bf16 values summed in float32, the result in hidden's dtype."""
    t, ok = tref._target_hits(targets, w.shape[0])
    coef = (hidden.float() @ w.float().T - lse.float()[:, None]).exp()
    coef.scatter_add_(1, t[:, None], -ok.float()[:, None])
    coef = (coef * g_rows.float()[:, None]).to(torch.bfloat16).float()
    return (coef @ w.float()).to(hidden.dtype)


@pytest.mark.parametrize("T,D,V", [(64, 32, 300), (128, 64, 1000),
                                   (192, 96, 517)])
def test_bf16_dh_rounding_matches_pallas(T, D, V):
    """The one new rounding of the tensor-core C1 (the coefficient meets
    bf16 before the second product) stays within the bf16 tolerance of the
    JAX package's C1 (``cross_entropy_bwd_dh_pallas``, interpret mode), on
    vocabularies that are not a multiple of the tile, with targets outside
    [0, V) (padding -1 and past V) and rows with g = 0."""
    (jh, jw, jt), (th, tw, tt) = _inputs(T, D, V, 3 * T + V, 0.5, "bfloat16")
    tgt = np.asarray(jt).copy()
    tgt[::7], tgt[3] = -1, V + 3
    tgt[1] = V - 1
    jt, tt = jnp.asarray(tgt), torch.from_numpy(tgt)
    valid = np.ones(T, bool)
    lse, _ = cross_entropy_fwd_pallas(jh, jw, jt, jnp.asarray(valid),
                                      block_t=16, block_v=64, interpret=True)
    g = np.random.default_rng(T).uniform(0.5, 1.5, T).astype(np.float32)
    g[::5] = 0.0
    want = cross_entropy_bwd_dh_pallas(jh, jw, jt, lse, jnp.asarray(g),
                                       block_t=16, block_v=64,
                                       interpret=True)
    t_lse, t_g = torch.from_numpy(np.asarray(lse)), torch.from_numpy(g)
    got = _dh_rounded_coef(th, tw, tt, t_lse, t_g)
    assert got.dtype == torch.bfloat16
    want32 = np.asarray(want.astype(jnp.float32))
    _close_scaled(got.float().numpy(), want32, BF16_TOL)
    # and the plain version (no rounding of the coefficient) too
    plain = tref.cross_entropy_bwd_dh_plain(th, tw, tt, t_lse, t_g)
    _close_scaled(plain.float().numpy(), want32, BF16_TOL)


def _dw_rounded_coef(hidden, w, targets, lse, g_rows):
    """C2 as the bf16 kernel computes it: the coefficient formed in float32,
    rounded to bf16 as the second product's operand, products with h's
    bf16 values summed in float32, the result in w's dtype."""
    t, ok = tref._target_hits(targets, w.shape[0])
    coef = (hidden.float() @ w.float().T - lse.float()[:, None]).exp()
    coef.scatter_add_(1, t[:, None], -ok.float()[:, None])
    coef = (coef * g_rows.float()[:, None]).to(torch.bfloat16).float()
    return (coef.T @ hidden.float()).to(w.dtype)


@pytest.mark.parametrize("T,D,V", [(64, 32, 300), (128, 64, 1000),
                                   (192, 96, 517)])
def test_bf16_dw_rounding_matches_pallas(T, D, V):
    """The one new rounding of the tensor-core C2 (the coefficient meets
    bf16 before the second product, as in C1) stays within the bf16
    tolerance of the JAX package's C2 (``cross_entropy_bwd_dw_pallas``,
    interpret mode), on vocabularies that are not a multiple of the tile
    (C2's vocabulary tiles are its rows: the last one ragged), with targets
    outside [0, V) (padding -1 and past V) and rows with g = 0."""
    (jh, jw, jt), (th, tw, tt) = _inputs(T, D, V, 5 * T + V, 0.5, "bfloat16")
    tgt = np.asarray(jt).copy()
    tgt[::7], tgt[3] = -1, V + 3
    tgt[1] = V - 1
    jt, tt = jnp.asarray(tgt), torch.from_numpy(tgt)
    valid = np.ones(T, bool)
    lse, _ = cross_entropy_fwd_pallas(jh, jw, jt, jnp.asarray(valid),
                                      block_t=16, block_v=64, interpret=True)
    g = np.random.default_rng(T + 1).uniform(0.5, 1.5, T).astype(np.float32)
    g[::5] = 0.0
    want = cross_entropy_bwd_dw_pallas(jh, jw, jt, lse, jnp.asarray(g),
                                       block_t=16, block_v=64,
                                       interpret=True)
    t_lse, t_g = torch.from_numpy(np.asarray(lse)), torch.from_numpy(g)
    got = _dw_rounded_coef(th, tw, tt, t_lse, t_g)
    assert got.dtype == torch.bfloat16 and got.shape == (V, D)
    want32 = np.asarray(want.astype(jnp.float32))
    _close_scaled(got.float().numpy(), want32, BF16_TOL)
    # and the plain version (no rounding of the coefficient) too
    plain = tref.cross_entropy_bwd_dw_plain(th, tw, tt, t_lse, t_g)
    _close_scaled(plain.float().numpy(), want32, BF16_TOL)
    # the rounding moves dW by more than float32 rounding
    exact = tref.cross_entropy_bwd_dw_plain(th.float(), tw.float(), tt,
                                            t_lse, t_g)
    rounded = _dw_rounded_coef(th.float(), tw.float(), tt, t_lse, t_g)
    assert float((rounded - exact).abs().max()) > \
        1e-5 * float(exact.abs().max())


def test_plain_versions_stay_the_plain_function():
    """``ref``'s B, C1 and C2 compute the exact function in float32 (no
    bf16 rounding of the coefficient): against float64 arithmetic on the
    same bf16 inputs, to float32 rounding."""
    (_, _, _), (th, tw, tt) = _inputs(48, 64, 333, 11, 0.5, "bfloat16")
    g = torch.linspace(0.5, 1.5, 48)
    h64, w64 = th.double(), tw.double()
    logits = h64 @ w64.T
    lse64 = torch.logsumexp(logits, -1)
    p = (logits - lse64[:, None]).exp()
    p[torch.arange(48), tt.long()] -= 1.0
    coef = p * g.double()[:, None]
    lse, tl = tref.cross_entropy_fwd_plain(th, tw, tt)
    np.testing.assert_allclose(lse.numpy(), lse64.numpy(), rtol=1e-6)
    np.testing.assert_allclose(
        tl.numpy(), logits[torch.arange(48), tt.long()].numpy(), rtol=1e-5,
        atol=1e-6)
    dh = tref.cross_entropy_bwd_dh_plain(th.float(), tw.float(), tt, lse, g)
    dw = tref.cross_entropy_bwd_dw_plain(th.float(), tw.float(), tt, lse, g)
    np.testing.assert_allclose(dh.numpy(), (coef @ w64).numpy(), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(dw.numpy(), (coef.T @ h64).numpy(),
                               rtol=1e-4, atol=1e-6)
    # the rounded coefficient is a different function: it moves dh by more
    # than float32 rounding
    rounded = _dh_rounded_coef(th.float(), tw.float(), tt, lse, g)
    assert float((rounded - dh).abs().max()) > 1e-5 * float(dh.abs().max())


def _heads():
    from repro_torch.configs import arch_names, get_arch
    return [(n, get_arch(n).spec.d_model, get_arch(n).spec.vocab)
            for n in arch_names()]


def _vocab_ranges(V, n_split, dtype):
    """The vocabulary entries ``[lo, hi)`` of each split of B as the
    kernels in ``csrc/cross_entropy.cu`` derive them from the number of
    splits: float32 (``ce_fwd_kernel``) ``ceil(n_vt / S)`` tiles a split,
    bf16 (``ce_fwd_mma_kernel``) tiles ``[z n_vt // S, (z + 1) n_vt // S)``."""
    from repro_torch.kernels import cross_entropy as ce
    tile = ce.MMA_VOCAB_TILE if dtype == torch.bfloat16 else ce.VOCAB_TILE
    n_vt = -(-V // tile)
    if dtype == torch.bfloat16:
        bounds = [z * n_vt // n_split for z in range(n_split + 1)]
    else:
        per = -(-n_vt // n_split)
        bounds = [min(n_vt, z * per) for z in range(n_split + 1)]
    return [(min(V, a * tile), min(V, b * tile))
            for a, b in zip(bounds, bounds[1:])]


def _d_slices(D, width):
    """The D columns ``[d0, d1)`` of each slice as the kernels derive them
    from the slice width: slice ``i`` starts at ``i * width``."""
    return [(d0, min(D, d0 + width)) for d0 in range(0, D, width)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name,D,V", _heads())
def test_launch_geometry_covers_each_entry_once(name, D, V, dtype):
    """B's vocab splits (for the token tile of the dtype's kernel), C1's
    and C2's D slices and C2's vocabulary clusters cover each vocabulary
    entry and each column of D exactly once, for every head in the
    registry, at the chunk lengths of the train phases and at short
    chunks; bf16 slices fit one cluster.
    The wrappers pass the kernels the split count and the slice width;
    the ranges here follow the kernels' own formulas, and
    ``tests/test_torch_gpu.py`` holds the kernels themselves to the plain
    versions (targets in the last, ragged vocab tile; D of 1,600)."""
    from repro_torch.kernels import cross_entropy as ce
    for T in (64, 192, 8192, 16384, 28032, 41216):
        for n_sm in (132, 114):
            S = ce.vocab_splits(T, V, n_sm, dtype)
            assert 1 <= S <= ce.MAX_VSPLIT
            ranges = _vocab_ranges(V, S, dtype)
            assert len(ranges) == S
            hits = np.zeros(V, np.int32)
            for lo, hi in ranges:
                hits[lo:hi] += 1
            assert (hits == 1).all(), (T, S)
            if dtype == torch.bfloat16:
                assert all(hi > lo for lo, hi in ranges)
                tile = ce.MMA_VOCAB_TILE
                assert all(lo % tile == 0 for lo, _ in ranges)
    width = ce.d_slice_width(D, dtype)
    slices = _d_slices(D, width)
    cols = np.zeros(D, np.int32)
    for d0, d1 in slices:
        cols[d0:d1] += 1
    assert (cols == 1).all()
    assert all(d1 - d0 <= width for d0, d1 in slices)
    if dtype == torch.bfloat16:
        assert width % ce.DH_SLICE_MULTIPLE == 0
        assert len(slices) <= ce.DH_MAX_SLICES
        # slices wider than DH_SLICE_MAX only where they bring a cluster
        # that would take more than DH_PORTABLE CTAs down to DH_PORTABLE
        assert width <= ce.DH_SLICE_MAX or (
            width <= ce.DH_SLICE_WIDE and len(slices) <= ce.DH_PORTABLE
            < -(-D // ce.DH_SLICE_MAX))
        # C2's clusters: cluster c owns the 64 vocabulary entries [64 c,
        # min(64 c + 64, V)) (the last ragged), one CTA per D slice above;
        # each (entry, column) has one owner, which writes it once
        tile = ce.TOKEN_MULTIPLE
        n_cl = -(-V // tile)
        rows = np.zeros(V, np.int32)
        for c in range(n_cl):
            rows[c * tile:min(V, (c + 1) * tile)] += 1
        assert (rows == 1).all()
        assert n_cl * tile - V < tile
    else:
        assert width % 32 == 0 and width <= ce.DS_MAX
        assert len(slices) == -(-D // ce.DS_MAX)


@pytest.mark.parametrize("D,width,slices", [(2560, 384, 7), (3584, 448, 8),
                                            (5120, 384, 14)])
def test_bf16_slice_plan_of_the_new_heads(D, width, slices):
    """qwen3-4b's, qwen2-vl-7b's and stablelm-12b's hidden widths: bf16 C1
    and C2 take 7 slices of 384 columns at 2,560 and 14 at 5,120 (a
    cluster above the portable 8); at 3,584, 384 columns would take 10,
    so the slices widen to 448 and take 8. The last one is narrower at
    2,560 and 5,120 (256 and 128 columns); every column lies in exactly
    one slice; float32 slices of at most DS_MAX columns cover D too."""
    from repro_torch.kernels import cross_entropy as ce
    assert ce.d_slice_width(D, torch.bfloat16) == width
    assert width in (ce.DH_SLICE_MAX, ce.DH_SLICE_WIDE)
    assert width % ce.DH_SLICE_MULTIPLE == 0
    pieces = _d_slices(D, width)
    assert len(pieces) == slices <= ce.DH_MAX_SLICES
    assert pieces[-1][1] - pieces[-1][0] == D - (slices - 1) * width
    cols = np.zeros(D, np.int32)
    for d0, d1 in pieces:
        cols[d0:d1] += 1
    assert (cols == 1).all()
    w32 = ce.d_slice_width(D, torch.float32)
    assert w32 <= ce.DS_MAX and w32 % 32 == 0
    assert sum(d1 - d0 for d0, d1 in _d_slices(D, w32)) == D
