"""Port parity: the SSM family (mamba mixer, selective scan D and its
gradient D') against the JAX package, on the CPU.

* The plain scan (``repro_torch.kernels.ref.mamba_scan_reference``, what
  ``ops.mamba_scan`` runs on CPU tensors) against the Pallas kernel
  ``mamba_scan_pallas`` in interpret mode and the jnp path of the JAX
  ``ops.mamba_scan``, at the shapes and dtypes of ``tests/test_kernels.py``
  and its tolerances: float32 ``2e-5`` (h_last ``1e-4``), bf16 ``3e-2``.
* The scan's gradients against ``jax.grad`` of the jnp path, float32
  ``rtol 1e-4, atol 1e-5`` (sums over a few dozen steps in another order).
* ``mamba_apply`` (outputs, the carried ``(h, conv_tail)`` and the
  gradients of the lean conv and scan functions) and ``forward_chunk``
  with the context carry, for reduced falcon-mamba-7b and hymba-1.5b,
  against the JAX ``DecoderLM`` through ``weights.from_jax``: float32
  ``rtol = atol = 1e-5`` (gradients ``rtol 1e-4, atol 1e-6``).
* Packed segments do not leak into each other (as
  ``tests/test_models_smoke.py::test_mamba_segment_reset_blocks_leakage``).
* Pad rows are state-neutral: a split chunk cut to a buffer with pad rows
  hands on the same state as one without them, and the next chunk equals
  the unchunked forward. This is where the port departs from the
  reference, whose pad rows reset the state (``ROADMAP.md``, reference
  caveats).
* The mixer keeps no more activation bytes per token than the planner's
  memory model charges it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.kernels import ops as jops
from repro.kernels.mamba_scan import mamba_scan_pallas
from repro.models import DecoderLM as JLM
from repro.models import ssm as jssm
from repro_torch.configs import get_arch
from repro_torch.kernels import ops, ref
from repro_torch.models import DecoderLM, layer_params
from repro_torch.models import ssm as tssm
from repro_torch.weights import DENSE_LEAVES, from_jax
from test_torch_threads import torch_thread_share  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
GTOL = dict(rtol=1e-4, atol=1e-6)
ARCHS = ("falcon-mamba-7b", "hymba-1.5b")


def _scan_inputs(T, DI, DS, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    delta = np.log1p(np.exp(rng.standard_normal((T, DI))))
    xs = rng.standard_normal((T, DI))
    B = rng.standard_normal((T, DS))
    C = rng.standard_normal((T, DS))
    A = -np.exp(rng.standard_normal((DI, DS)) * 0.3)
    reset = (rng.uniform(size=T) < 0.1).astype(np.int32)
    reset[0] = 1
    h0 = rng.standard_normal((DI, DS))
    f32 = [a.astype(np.float32) for a in (delta, xs, B, C, A)]
    if dtype == "bfloat16":      # round the inputs to bf16 for both sides
        f32[:4] = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(
            jnp.float32)) for a in f32[:4]]
    return (*f32, reset, h0.astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,DI,DS", [(32, 16, 4), (64, 32, 8), (96, 8, 16)])
def test_plain_scan_matches_pallas_and_jnp(dtype, T, DI, DS):
    delta, xs, B, C, A, reset, h0 = _scan_inputs(T, DI, DS, T + DI, dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jin = [jnp.asarray(a, jdt) for a in (delta, xs, B, C)]
    y_p, h_p = mamba_scan_pallas(*jin, jnp.asarray(A), jnp.asarray(reset),
                                 jnp.asarray(h0), block_t=16, block_di=8,
                                 interpret=True)
    y_j, h_j = jops.mamba_scan(*jin, jnp.asarray(A), jnp.asarray(reset),
                               jnp.asarray(h0), use_pallas=False)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tin = [_t(a).to(tdt) for a in (delta, xs, B, C)]
    y_t, h_t = ops.mamba_scan(*tin, _t(A), _t(reset), _t(h0))
    y_r, h_r = ref.mamba_scan_reference(*tin, _t(A), _t(reset), _t(h0))
    assert y_t.dtype == h_t.dtype == torch.float32
    assert torch.equal(y_t, y_r) and torch.equal(h_t, h_r)
    ytol = 2e-5 if dtype == "float32" else 3e-2
    htol = 1e-4 if dtype == "float32" else 3e-2
    for y_ref, h_ref in ((y_p, h_p), (y_j, h_j)):
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_ref, np.float32),
                                   rtol=ytol, atol=ytol)
        np.testing.assert_allclose(h_t.numpy(), np.asarray(h_ref, np.float32),
                                   rtol=htol, atol=htol)


def test_scan_carry_state():
    """Scanning [0:T/2] then [T/2:T] from the carried state equals one
    scan (the JAX package's ``test_mamba_scan_carry_state``)."""
    delta, xs, B, C, A, _, _ = _scan_inputs(50, 8, 4, 21)
    reset = np.zeros(50, np.int32)
    reset[0] = 1
    h0 = np.zeros((8, 4), np.float32)
    full = ops.mamba_scan(*map(_t, (delta, xs, B, C, A, reset, h0)))
    y1, h_mid = ops.mamba_scan(*(_t(a[:25]) for a in (delta, xs, B, C)),
                               _t(A), _t(reset[:25]), _t(h0))
    y2, h_end = ops.mamba_scan(*(_t(a[25:]) for a in (delta, xs, B, C)),
                               _t(A), _t(reset[25:] * 0), h_mid)
    np.testing.assert_allclose(torch.cat([y1, y2]).numpy(), full[0].numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h_end.numpy(), full[1].numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("T,DI,DS", [(40, 16, 4), (70, 8, 16)])
def test_scan_gradients_match_jax_grad(T, DI, DS):
    """D's gradient (the plain backward on the CPU) in every input against
    ``jax.grad`` of the jnp scan, for ``sum(wy * y) + sum(wh * h_last)``."""
    delta, xs, B, C, A, reset, h0 = _scan_inputs(T, DI, DS, 7)
    rng = np.random.default_rng(8)
    wy = rng.standard_normal((T, DI)).astype(np.float32)
    wh = rng.standard_normal((DI, DS)).astype(np.float32)

    def jloss(*a):
        y, h = jops.mamba_scan(*a[:5], jnp.asarray(reset), a[5],
                               use_pallas=False)
        return jnp.sum(y * wy) + jnp.sum(h * wh)
    ins = (delta, xs, B, C, A, h0)
    jg = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.asarray, ins))
    leaves = [_t(a).requires_grad_(True) for a in ins]
    y, h = ops.mamba_scan(*leaves[:5], _t(reset), leaves[5])
    ((y * _t(wy)).sum() + (h * _t(wh)).sum()).backward()
    for a, b in zip(leaves, jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


def _gated_inputs(T, DI, DS, seed):
    """The gated scan's float32 inputs: ``dt_pre`` around the mixer's
    softplus bias, pad rows (live False) in the middle and at the end,
    resets inside a tile and on both edges of tile 1 (rows 64 and 127,
    where T allows), none on row 0 (the non-zero h0 counts)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    dt_pre = (rng.standard_normal((T, DI)) - 2.0).astype(f)
    xc = rng.standard_normal((T, DI)).astype(f)
    B = rng.standard_normal((T, DS)).astype(f)
    C = rng.standard_normal((T, DS)).astype(f)
    z = rng.standard_normal((T, DI)).astype(f)
    bias = (rng.standard_normal(DI) * 0.5).astype(f)
    A = -np.exp(rng.standard_normal((DI, DS)) * 0.3).astype(f)
    d_skip = rng.standard_normal(DI).astype(f)
    h0 = rng.standard_normal((DI, DS)).astype(f)
    live = np.ones(T, bool)
    live[T // 3:T // 3 + 5] = False
    live[-7:] = False
    reset = np.zeros(T, bool)
    reset[[r for r in (10, 64, 127) if r < T]] = True
    reset &= live
    return dict(dt_pre=dt_pre, xc=xc, B=B, C=C, z=z, dt_bias=bias, A=A,
                d_skip=d_skip, live=live, reset=reset, h0=h0)


_GATED_DIFF = ("dt_pre", "xc", "B", "C", "z", "dt_bias", "A", "d_skip",
               "h0")


@pytest.mark.parametrize("T,DI,DS", [(150, 8, 4), (100, 6, 16)])
def test_gated_scan_matches_jax(T, DI, DS):
    """The plain gated scan (``ref.mamba_scan_gated``, what
    ``ops.mamba_scan_gated_fwd`` runs on the CPU) and its gradient
    (``ref.mamba_scan_gated_grad``) against the JAX package's mixer math
    (``models/ssm.py``: softplus of ``dt_pre + dt_bias``, the scan through
    ``repro.kernels.ops.mamba_scan``, the skip and the gate), with the
    port's pad rows (delta 0 where live is False) and ``jax.grad`` for
    every input, for ``sum(w_out * out) + sum(w_h * h_last)``. float32,
    within 1e-5 relative: ``rtol = 1e-5`` and ``atol = 1e-5`` times the
    largest magnitude of the JAX result."""
    case = _gated_inputs(T, DI, DS, T + DI)
    rng = np.random.default_rng(3)
    w_out = rng.standard_normal((T, DI)).astype(np.float32)
    w_h = rng.standard_normal((DI, DS)).astype(np.float32)
    live, reset = jnp.asarray(case["live"]), jnp.asarray(case["reset"])

    def jgated(dt_pre, xc, B, C, z, dt_bias, A, d_skip, h0):
        delta = jnp.where(live[:, None], jax.nn.softplus(dt_pre + dt_bias),
                          0.0)
        y, h = jops.mamba_scan(delta, xc, B, C, A, reset, h0,
                               use_pallas=False)
        y = y + d_skip[None] * xc
        return y * jax.nn.silu(z), h

    def jloss(*a):
        out, h = jgated(*a)
        return jnp.sum(out * w_out) + jnp.sum(h * w_h)
    jin = [jnp.asarray(case[k]) for k in _GATED_DIFF]
    j_out, j_h = jgated(*jin)
    jg = jax.grad(jloss, argnums=tuple(range(len(jin))))(*jin)
    tin = {k: _t(v) for k, v in case.items()}
    before = ops.mamba_scan.plain_calls
    out, h, ckpt = ops.mamba_scan_gated_fwd(**tin)
    assert ckpt is None and ops.mamba_scan.plain_calls == before + 1

    def close(got, want, name):
        want = np.asarray(want)
        scale = float(np.abs(want).max()) or 1.0
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)
    close(out, j_out, "out")
    close(h, j_h, "h_last")
    grads = ops.mamba_scan_gated_bwd(**tin, ckpt=None, dout=_t(w_out),
                                     dh_last=_t(w_h))
    got = dict(zip(("dt_pre", "xc", "z", "B", "C", "A", "dt_bias", "d_skip",
                    "h0"), grads))
    for name, g in zip(_GATED_DIFF, jg):
        close(got[name], g, name)
    assert float(got["dt_pre"][~tin["live"]].abs().max()) == 0.0


def _tile_rows(T, L):
    return [slice(k * L, min(T, (k + 1) * L)) for k in range(-(-T // L))]


def _decay(d_t, A, rst):
    return torch.where(rst, torch.zeros_like(A), torch.exp(d_t[:, None] * A))


def _tiled_scan(delta, xs, B, C, A, reset, h0, L=64):
    """A model of kernel D's three passes: (a) per tile the summary ``Q``
    (the end state from 0), its sum of delta and whether a row resets; (b)
    the carry ``h_in[k+1] = P_k h_in[k] + Q_k`` with ``P_k = 0`` after a
    reset, else ``exp(A sum delta)``; (c) each tile re-expanded from its
    ``h_in``. Returns ``(y, h_last, ckpt)``."""
    d, x, Bf, Cf = delta.float(), xs.float(), B.float(), C.float()
    rst = reset != 0
    tiles = _tile_rows(d.shape[0], L)
    summ = []
    for rows in tiles:
        q = torch.zeros_like(h0)
        for t in range(rows.start, rows.stop):
            q = _decay(d[t], A, rst[t]) * q + (d[t] * x[t])[:, None] * Bf[t]
        summ.append((q, d[rows].sum(0), bool(rst[rows].any())))
    ckpt, h = [], h0.clone()
    for q, dsum, hit in summ:
        ckpt.append(h)
        P = torch.zeros_like(A) if hit else torch.exp(A * dsum[:, None])
        h = P * h + q
    y = torch.empty_like(d)
    for rows, hk in zip(tiles, ckpt):
        for t in range(rows.start, rows.stop):
            hk = _decay(d[t], A, rst[t]) * hk + (d[t] * x[t])[:, None] * Bf[t]
            y[t] = (hk * Cf[t]).sum(-1)
    return y, h, ckpt


def _tiled_scan_grad(delta, xs, B, C, A, reset, ckpt, dy, dh_last, L=64,
                     sub=8):
    """A model of kernel D''s passes: (a') per tile the reverse summary
    ``R`` (the gradient leaving the tile leftwards from 0); (b') the
    reverse carry ``u_in[k-1] = P_k u_in[k] + R_k`` from ``dh_last``, which
    ends at dh0; (c') per tile, the states recomputed from ``ckpt`` in
    sub-tiles of ``sub`` rows and walked back from ``u_in``; dA summed per
    tile, then over tiles in order. Returns ``(d_delta, d_xs, dB, dC, dA,
    dh0)``."""
    d, x, Bf, Cf, g = (t.float() for t in (delta, xs, B, C, dy))
    rst = reset != 0
    tiles = _tile_rows(d.shape[0], L)
    summ = []
    for rows in tiles:
        u = torch.zeros_like(A)
        for t in range(rows.stop - 1, rows.start - 1, -1):
            u = _decay(d[t], A, rst[t]) * (u + g[t][:, None] * Cf[t])
        summ.append((u, d[rows].sum(0), bool(rst[rows].any())))
    u_in = [None] * len(tiles)
    u = dh_last.clone()
    for k in range(len(tiles) - 1, -1, -1):
        r, dsum, hit = summ[k]
        u_in[k] = u
        P = torch.zeros_like(A) if hit else torch.exp(A * dsum[:, None])
        u = P * u + r
    dh0 = u
    dd, dx = torch.zeros_like(d), torch.zeros_like(d)
    dB, dC = torch.zeros_like(Bf), torch.zeros_like(Cf)
    dA_tiles = []
    for rows, h_in, u in zip(tiles, ckpt, u_in):
        starts, h = [], h_in
        for t in range(rows.start, rows.stop):      # walk 1
            if (t - rows.start) % sub == 0:
                starts.append(h)
            h = _decay(d[t], A, rst[t]) * h + (d[t] * x[t])[:, None] * Bf[t]
        da = torch.zeros_like(A)
        for j in range(len(starts) - 1, -1, -1):
            a0 = rows.start + j * sub
            seg = range(a0, min(rows.stop, a0 + sub))
            hs, h = [], starts[j]
            for t in seg:                          # recompute the sub-tile
                h = _decay(d[t], A, rst[t]) * h + \
                    (d[t] * x[t])[:, None] * Bf[t]
                hs.append(h)
            for i in range(len(hs) - 1, -1, -1):   # walk it back
                t = seg[i]
                h_p = hs[i - 1] if i else starts[j]
                a = _decay(d[t], A, rst[t])
                dh = u + g[t][:, None] * Cf[t]
                dadt = dh * h_p * a
                da += dadt * d[t][:, None]
                dd[t] = (dadt * A + dh * x[t][:, None] * Bf[t]).sum(-1)
                dx[t] = (dh * d[t][:, None] * Bf[t]).sum(-1)
                dB[t] = (dh * (d[t] * x[t])[:, None]).sum(0)
                dC[t] = (g[t][:, None] * hs[i]).sum(0)
                u = a * dh
        dA_tiles.append(da)
    return dd, dx, dB, dC, torch.stack(dA_tiles).sum(0), dh0


@pytest.mark.parametrize("resets", ["tile edges", "every row", "none"])
@pytest.mark.parametrize("T,DI,DS", [(150, 8, 4), (300, 6, 16)])
def test_tile_decomposition_matches_plain_scan(T, DI, DS, resets):
    """The algebra of the chunked scan (:func:`_tiled_scan`,
    :func:`_tiled_scan_grad`: 64-row tiles, the last one ragged) against
    the plain scan and its stepwise gradient (``ref.mamba_scan_reference``
    / ``ref.mamba_scan_grad``), within 1e-5 (``rtol``, and ``atol`` times
    the largest magnitude): resets on a tile's first and last row (64,
    127) and inside one, on every row, or none; a non-zero h0."""
    delta, xs, B, C, A, _, h0 = map(_t, _scan_inputs(T, DI, DS, T + DS))
    reset = torch.zeros(T, dtype=torch.int32)
    if resets == "tile edges":
        reset[[10, 64, 127]] = 1
    elif resets == "every row":
        reset[:] = 1
    rng = np.random.default_rng(T)
    dy = _t(rng.standard_normal((T, DI)).astype(np.float32))
    dh = _t(rng.standard_normal((DI, DS)).astype(np.float32))

    def close(got, want):
        scale = float(want.abs().max()) or 1.0
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5 * scale)
    y, h_last, ckpt = _tiled_scan(delta, xs, B, C, A, reset, h0)
    y_r, h_r = ref.mamba_scan_reference(delta, xs, B, C, A, reset, h0)
    close(y, y_r)
    close(h_last, h_r)
    got = _tiled_scan_grad(delta, xs, B, C, A, reset, ckpt, dy, dh)
    _, *want = ref.mamba_scan_grad(delta, xs, B, C, A, reset, h0, dy, dh)
    for a, b in zip(got, want):
        close(a, b)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    jcfg = jget(request.param).reduced(n_layers=3)
    tcfg = get_arch(request.param).reduced(n_layers=3)
    raw = jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.PRNGKey(5)))
    return jcfg, tcfg, raw, from_jax(tcfg, raw, device="cpu")


def _packed(lengths, ctx=0):
    """seg/pos of packed sequences (the first continues at ``ctx``)."""
    seg = np.concatenate([np.full(n, i, np.int32)
                          for i, n in enumerate(lengths)])
    pos = np.concatenate([np.arange(n, dtype=np.int32) + (ctx if i == 0
                                                         else 0)
                          for i, n in enumerate(lengths)])
    return seg, pos


def test_registry_matches_jax():
    for name in ARCHS:
        a, b = get_arch(name), jget(name)
        assert dataclasses.asdict(a.spec) == dataclasses.asdict(b.spec)
        assert {f.name: getattr(a, f.name) for f in dataclasses.fields(a)
                if f.name != "spec"} == \
            {f.name: getattr(b, f.name) for f in dataclasses.fields(b)
             if f.name != "spec"}


def test_bridge_keeps_conv_layout(arch):
    jcfg, _, raw, tparams = arch
    for name, a in raw["layers"]["mamba"].items():
        b = tparams["layers"]["mamba"][name].numpy()
        want = np.swapaxes(a, -1, -2) if name in DENSE_LEAVES else a
        np.testing.assert_array_equal(b, want)
    s = jcfg.spec
    assert tparams["layers"]["mamba"]["conv_w"].shape == (
        s.n_layers, s.ssm_conv, s.inner)


def test_mamba_apply_matches_jax(arch):
    """One packed chunk that continues a sequence (non-zero state and conv
    tail in) and starts two more: the output, the state and tail handed
    on, and the gradients in the input, the carry and every mixer weight
    (the lean conv and scan backwards) against ``jax.grad``."""
    jcfg, tcfg, raw, tparams = arch
    s = jcfg.spec
    seg, pos = _packed([9, 14, 11], ctx=30)
    T = len(seg)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((T, s.d_model)).astype(np.float32)
    h0 = rng.standard_normal((s.inner, s.ssm_state)).astype(np.float32)
    tail = rng.standard_normal((s.ssm_conv - 1, s.inner)).astype(np.float32)
    w_out = rng.standard_normal((T, s.d_model)).astype(np.float32)
    w_h = rng.standard_normal(h0.shape).astype(np.float32)
    w_t = rng.standard_normal(tail.shape).astype(np.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a[1]), raw["layers"]["mamba"])

    def jloss(p, x, h0, tail):
        out, h, t = jssm.mamba_apply(jcfg, p, x, pos=jnp.asarray(pos),
                                     state=h0, conv_tail=tail)
        return jnp.sum(out * w_out) + jnp.sum(h * w_h) + jnp.sum(t * w_t), \
            (out, h, t)
    (_, (jo, jh, jt)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True)(
            jp, jnp.asarray(x), jnp.asarray(h0), jnp.asarray(tail))
    tp = {k: v.clone().requires_grad_(True)
          for k, v in layer_params(tparams, 1)["mamba"].items()}
    tx, th0, ttail = (_t(a).requires_grad_(True) for a in (x, h0, tail))
    out, h, t = tssm.mamba_apply(tcfg, tp, tx, pos=_t(pos), seg=_t(seg),
                                 state=th0, conv_tail=ttail)
    for a, b in ((jo, out), (jh, h), (jt, t)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), **TOL)
    ((out * _t(w_out)).sum() + (h * _t(w_h)).sum()
     + (t * _t(w_t)).sum()).backward()
    for name, g in jg[0].items():
        got = tp[name].grad.numpy()
        want = np.asarray(g)
        if name in DENSE_LEAVES:
            want = want.T
        np.testing.assert_allclose(got, want, err_msg=name, **GTOL)
    for a, b in zip((tx, th0, ttail), jg[1:]):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), **GTOL)


def test_forward_chunk_with_context_carry(arch):
    """Two split chunks of one sequence through the stacked carry (KV on
    hymba, ``(h, conv_tail)`` on both): hidden states and every carry field
    against the JAX model."""
    jcfg, tcfg, raw, tparams = arch
    cap, T1, T2 = 48, 20, 16
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.spec.vocab, T1 + T2).astype(np.int32)
    jl, tl = JLM(jcfg), DecoderLM(tcfg)
    jctx = jl.init_ctx(cap, jnp.float32)
    tctx = tl.init_ctx(cap, torch.float32, device="cpu")
    off = 0
    for T, rest in ((T1, [5, 3]), (T2, [4])):
        tok = tokens[off:off + T]
        seg, pos = _packed([T - sum(rest)] + rest, ctx=off)
        xa, jctx = jl.forward_chunk(
            raw, jnp.asarray(tok), jnp.asarray(seg), jnp.asarray(pos),
            ctx=jctx, ctx_len=off, compute_dtype=jnp.float32)
        xb, tctx = tl.forward_chunk(
            tparams, _t(tok).long(), _t(seg), _t(pos), ctx=tctx, ctx_len=off,
            compute_dtype=torch.float32)
        np.testing.assert_allclose(xb.detach().numpy(), np.asarray(xa),
                                   **TOL)
        for a, b in zip(jctx, tctx):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                           **TOL)
        off += T - sum(rest)
    assert tctx.k is None if jcfg.spec.attn_free else tctx.k is not None


@pytest.mark.parametrize("name", ARCHS)
def test_segment_reset_blocks_leakage(name):
    """Packed mamba: tokens of segment 1 are unaffected by segment 0."""
    cfg = get_arch(name).reduced()
    model = DecoderLM(cfg)
    params = model.init(torch.Generator().manual_seed(3), device="cpu")
    rng = np.random.default_rng(3)
    tok_a, tok_b, tok_c = (rng.integers(0, cfg.spec.vocab, 24)
                           for _ in range(3))
    seg, pos = _packed([24, 24])
    outs = [model.forward_chunk(params, _t(np.concatenate([a, tok_b])).long(),
                                _t(seg), _t(pos), compute_dtype=torch.float32)
            [0] for a in (tok_a, tok_c)]
    np.testing.assert_allclose(outs[0][24:].detach().numpy(),
                               outs[1][24:].detach().numpy(), **TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_padded_split_chunk_carries_the_same_state(name):
    """One 200-token sequence in chunks [0, 100) and [100, 200): the first
    chunk in a buffer of 100 rows, then of 128 rows (28 pad rows: seg -1,
    pos 0). The state handed on is the same, and the second chunk's
    hidden states equal the unchunked JAX forward's rows [100, 200). (The
    reference's own chunked forward misses here by 0.30 and 1.41 at this
    size: its pad rows reset the state.)"""
    jcfg = jget(name).reduced(n_layers=2)
    cfg = get_arch(name).reduced(n_layers=2)
    raw = jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.PRNGKey(9)))
    params = from_jax(cfg, raw, device="cpu")
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.spec.vocab, 200).astype(np.int32)
    full, _ = JLM(jcfg).forward_chunk(
        raw, jnp.asarray(toks), jnp.zeros(200, jnp.int32),
        jnp.arange(200, dtype=jnp.int32), compute_dtype=jnp.float32)
    model = DecoderLM(cfg)
    carries = []
    for rows in (100, 128):
        tok = np.zeros(rows, np.int32)
        tok[:100] = toks[:100]
        seg = np.full(rows, -1, np.int32)
        seg[:100] = 0
        pos = np.zeros(rows, np.int32)
        pos[:100] = np.arange(100)
        ctx = model.init_ctx(256, torch.float32, device="cpu")
        _, ctx = model.forward_chunk(params, _t(tok).long(), _t(seg),
                                     _t(pos), ctx=ctx,
                                     compute_dtype=torch.float32)
        h2, _ = model.forward_chunk(
            params, _t(toks[100:]).long(), torch.zeros(100, dtype=torch.int32),
            torch.arange(100, 200, dtype=torch.int32), ctx=ctx, ctx_len=100,
            compute_dtype=torch.float32)
        np.testing.assert_allclose(h2.detach().numpy(),
                                   np.asarray(full)[100:], **TOL)
        carries.append(ctx)
    for a, b in zip(carries[0][2:], carries[1][2:]):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   **TOL)


def test_mixer_keeps_the_planners_bytes_per_token():
    """bf16 hymba mixer at a reduced width: the bytes its autograd graph
    keeps per token (unique storages, the input excluded) stay within the
    planner's ``e (2 D + 5 d_inner)`` for the SSM mixer."""
    cfg = get_arch("hymba-1.5b").reduced(d_model=128)
    s = cfg.spec
    p = tssm.init_mamba(cfg, torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.bfloat16)
    p = {k: v.requires_grad_(True) for k, v in p.items()}
    T = 512
    x = torch.randn((T, s.d_model), dtype=torch.bfloat16,
                    requires_grad=True)
    kept = {}
    skip = {t.untyped_storage().data_ptr() for t in [x, *p.values()]}

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in skip:
            kept[ptr] = t.untyped_storage().nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out, _, _ = tssm.mamba_apply(cfg, p, x, pos=torch.arange(T),
                                     seg=torch.zeros(T, dtype=torch.int32))
    per_token = sum(kept.values()) / T
    assert per_token <= 2 * (2 * s.d_model + 5 * s.inner), per_token
    out.float().sum().backward()
    assert all(v.grad is not None for v in p.values())


def test_train_cli_refuses_falcon_on_one_card():
    """falcon-mamba-7b's states (126 GB) exceed one 80 GB card: the
    training CLI stops at the planner with its message, before it
    allocates any parameter."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    env = dict(os.environ)
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1] / "src")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "falcon-mamba-7b", "--steps", "1"],
        capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 5, r.stderr[-2000:]
    assert "exceed capacity" in r.stderr and "train OK" not in r.stdout
