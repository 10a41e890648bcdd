"""Port parity: the pipelined prefill and fixed-batch decode
(``runtime/serve_step.DecodeStepBuilder``, ``sp.sharded_greedy``,
``attention.decode_attention``, ``ssm.mamba_decode``) against the JAX
package, on the CPU, float32, inputs from numpy seeds, weights carried
by ``weights.from_jax``.

* ``sharded_greedy`` equals the JAX one under ``jax.vmap(axis_name=...)``
  at ``d_s`` 1, 2 and 3 (a vocabulary not divisible by 3), ties to the
  lowest id within a block and across blocks, in the decode case (the
  same rows on every rank) and the prefill case (token blocks);
* the decode state's shapes and bytes equal the JAX
  ``decode_state_struct`` (less the pod dim) for every registry family at
  ``(d_p, d_s)`` (1, 1), (2, 2) and (1, 4);
* one falcon-mamba-7b ``decode_step`` from a random state equals the JAX
  ``decode_step_fn`` on a ``(1, 1)`` mesh within 1e-5 (the new state and
  the ids): the one family where the reference's step is right;
* ``generate``'s ids equal the JAX ``DecoderLM.forward_chunk`` greedy over
  the whole sequence for six families at four meshes: one JAX forward of
  each prompt with the port's ids behind it, whose argmax at every
  generated position must be the port's next id (true exactly when the
  port's sequence is the greedy one);
* the state after prefill equals ``forward_chunk``'s carry for the prompt
  alone, also for a prompt split over two chunks on two SP ranks;
* ``decode_attention``'s rank merge equals the unsharded attention at
  ``d_s`` 2 and 3, with a rank that holds no live row;
* the reference's defect: the JAX ``decode_step_fn`` drops the attention
  term from the residual (``src/repro/runtime/serve_step.py:358-385``), so
  its first id on reduced hymba-1.5b differs from the whole-sequence
  greedy, while the port's equals it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_arch as jget
from repro.models import DecoderLM as JLM
from repro.models.layers import rms_norm as jrms_norm
from repro.runtime import serve_step as jss
from repro.runtime import sp as jsp
from repro.runtime.sharding import shard_dim_tree, shard_map_compat
from repro.runtime.train_step import param_pspecs, prepare_params
from repro_torch.configs import get_arch
from repro_torch.configs.registry import ARCHS as REGISTRY
from repro_torch.kernels import ref
from repro_torch.models import attention as tattn
from repro_torch.models.model import DecoderLM
from repro_torch.runtime import serve_step as ss
from repro_torch.runtime import sp
from repro_torch.weights import from_jax
from test_torch_threads import torch_thread_share  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")

TOL = dict(rtol=1e-5, atol=1e-5)
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2)]
# gemma3-1b at 6 layers: window-8 local layers and one global layer
FAMILIES = {"gemma3-1b": dict(n_layers=6), "hymba-1.5b": {},
            "falcon-mamba-7b": {}, "olmoe-1b-7b": {}, "deepseek-v2-lite": {},
            "qwen3-4b": {}}
N_PROMPTS, PROMPT, NEW = 3, 13, 6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# sharded_greedy

def _greedy_inputs(V, seed):
    """Small integers: every logit exact in float32 in any summation order,
    so equal rows tie exactly. Rows 0-2 point at row 5, whose copies sit
    at 6 (its block) and 80 (another block at d_s 2 and 3); row 3 at row
    90 and its copy 40, which comes first."""
    D, T = 16, 10
    rng = np.random.default_rng(seed)
    w = rng.integers(-2, 3, (V, D)).astype(np.float32)
    h = rng.integers(-2, 3, (T, D)).astype(np.float32)
    w[5] = 3.0
    w[90] = -3.0
    w[6] = w[80] = w[5]
    w[40] = w[90]
    h[:3] = w[5]
    h[3] = w[90]
    return w, h


@pytest.mark.parametrize("d", [1, 2, 3])
def test_sharded_greedy_matches_jax(d):
    V = 97
    w, h = _greedy_inputs(V, d)
    pad = -V % d
    wp = np.concatenate([w, np.zeros((pad, w.shape[1]), np.float32)])
    want = jax.vmap(lambda hh, ww: jsp.sharded_greedy(hh, ww, "x",
                                                      vocab_true=V),
                    in_axes=(None, 0), axis_name="x")(
        jnp.asarray(h), jnp.asarray(wp).reshape(d, -1, w.shape[1]))
    want = np.asarray(want)
    assert (want == want[0]).all()          # every rank the same ids
    assert list(want[0][:4]) == [5, 5, 5, 40]
    got = sp.sharded_greedy(_t(h), _t(w), d, vocab_true=V)
    np.testing.assert_array_equal(got.numpy(), want[0])
    # the prefill case: token blocks gathered first; a picked row
    blocks = [_t(a) for a in np.array_split(h, d)]
    np.testing.assert_array_equal(
        sp.sharded_greedy(blocks, _t(w), d, vocab_true=V).numpy(), want[0])
    rows = torch.tensor([7, 3])
    np.testing.assert_array_equal(
        sp.sharded_greedy(blocks, _t(w), d, rows=rows).numpy(),
        want[0][[7, 3]])
    # a block of each rank as the ranks' own shards (a list)
    shards = [t.clone() for t in sp.row_views(_t(w), d)]
    np.testing.assert_array_equal(
        sp.sharded_greedy(_t(h), shards, d).numpy(), want[0])


# ---------------------------------------------------------------------------
# the decode state

def _jgeom(geom):
    return jss.DecodeGeometry(
        batch_per_pod=geom.batch_per_pod, cache_len=geom.cache_len,
        d_p=geom.d_p, d_s=geom.d_s, layers_per_stage=geom.layers_per_stage,
        n_micro=geom.n_micro)


def _whole(name, blocks, d_p):
    """The port's per-stage, per-rank blocks of one state entry -> the
    reference's global array shape (the ranks' sharded dim joined)."""
    axis = {"cache_k": 3, "cache_v": 3, "ssm_h": 3, "conv_tail": 4,
            "memory": 2}[name]
    if name == "memory":
        return torch.cat(blocks, dim=axis).shape
    assert len(blocks) == d_p
    return torch.stack([torch.cat(r, dim=axis) for r in blocks]).shape


@pytest.mark.parametrize("mesh", [(1, 1), (2, 2), (1, 4)])
@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_decode_state_matches_jax_struct(name, mesh):
    d_p, d_s = mesh
    cfg = get_arch(name).reduced()
    geom = ss.make_decode_geometry(cfg, d_p=d_p, d_s=d_s, batch_per_pod=5,
                                   cache_len=64)
    jcfg = jget(name).reduced()
    want = jss.decode_state_struct(jcfg, _jgeom(geom), 1)
    state = ss.init_decode_state(cfg, geom, ["cpu"] * d_p)
    assert set(want) == {k for k in state if k not in ("length",
                                                        "mem_len")}
    for key, st in want.items():
        got = state[key]
        shape = got.shape if key == "tokens" else _whole(key, got, d_p)
        dt = got.dtype if key == "tokens" else \
            (got[0] if key == "memory" else got[0][0]).dtype
        assert tuple(shape) == st.shape, key
        assert str(dt).replace("torch.", "") == np.dtype(st.dtype).name, key
    nbytes = sum(int(np.prod(st.shape)) * np.dtype(st.dtype).itemsize
                 for st in want.values())
    assert ss.decode_state_bytes(geom, cfg) == nbytes
    held = sum(t.numel() * t.element_size() for k, v in state.items()
               if k not in ("length", "mem_len")
               for t in ([v] if k == "tokens" else v if k == "memory"
                         else [x for r in v for x in r]))
    assert held == nbytes
    # at full width too (shapes only)
    full = ss.make_decode_geometry(get_arch(name), d_p=d_p, d_s=d_s,
                                   batch_per_pod=16, cache_len=4096)
    assert ss.decode_state_bytes(full, get_arch(name)) == sum(
        int(np.prod(st.shape)) * np.dtype(st.dtype).itemsize
        for st in jss.decode_state_struct(jget(name), _jgeom(full),
                                          1).values())


def test_geometry_checks():
    cfg = get_arch("hymba-1.5b").reduced()
    g = ss.make_decode_geometry(cfg, d_p=2, d_s=2, batch_per_pod=16,
                                cache_len=1086)
    assert (g.n_micro, g.bm, g.s_cap, g.s_loc, g.layers_per_stage) == \
        (2, 8, 1088, 544, 2)
    with pytest.raises(ValueError, match="multiple of d_s"):
        ss.make_decode_geometry(cfg, d_p=1, d_s=2, batch_per_pod=2,
                                cache_len=7)
    with pytest.raises(ValueError, match="d_inner"):
        ss.make_decode_geometry(cfg, d_p=1, d_s=3, batch_per_pod=2,
                                cache_len=9)
    windows, active = ss._layer_tables(get_arch("gemma3-1b").reduced(
        n_layers=6), 4, 2)
    assert active.tolist() == [[True, True]] * 3 + [[False, False]]
    assert windows.tolist() == [[8, 8], [8, 8], [8, 0], [0, 0]]


# ---------------------------------------------------------------------------
# one falcon-mamba step against the reference's decode_step_fn

def _jax_decode(jcfg, raw, jgeom, state):
    """The reference's ``decode_step_fn`` on a ``(1, 1)`` mesh, float32."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    params = prepare_params(jcfg, raw, mesh, param_dtype=jnp.float32)
    fn = jss.decode_step_fn(jcfg, jgeom, shard_dim_tree(params["stages"], 1),
                            pod_axis=None)
    sspecs = jss.decode_state_specs(jcfg, jgeom, pod=None, data="data",
                                    model="model")
    mapped = shard_map_compat(fn, mesh=mesh,
                              in_specs=(param_pspecs(jcfg, params, mesh),
                                        sspecs),
                              out_specs=(P(), sspecs))
    ids, new = jax.jit(mapped)(params, {k: jnp.asarray(v)
                                        for k, v in state.items()})
    return np.asarray(ids), {k: np.asarray(v) for k, v in new.items()}


def test_falcon_step_matches_jax_decode_step_fn():
    name = "falcon-mamba-7b"
    jcfg, cfg = jget(name).reduced(n_layers=3), get_arch(name).reduced(
        n_layers=3)
    raw = jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.PRNGKey(0)))
    b = ss.DecodeStepBuilder(cfg, from_jax(cfg, raw, device="cpu"),
                             compute_dtype=torch.float32, device="cpu")
    b.geom = geom = ss.make_decode_geometry(cfg, d_p=1, d_s=1,
                                            batch_per_pod=3, cache_len=20,
                                            compute_dtype=torch.float32)
    jgeom = jss.DecodeGeometry(3, 20, 1, 1, 3, 1, jnp.float32)
    rng = np.random.default_rng(1)
    s = cfg.spec
    jstate = {
        "tokens": rng.integers(0, s.vocab, (1, 3)).astype(np.int32),
        "ssm_h": rng.standard_normal((1, 1, 3, 3, s.inner, s.ssm_state)
                                     ).astype(np.float32),
        "conv_tail": rng.standard_normal((1, 1, 3, 3, s.ssm_conv - 1,
                                          s.inner)).astype(np.float32)}
    jids, jnew = _jax_decode(jcfg, raw, jgeom, jstate)
    state = ss.init_decode_state(cfg, geom, ["cpu"])
    state["tokens"].copy_(_t(jstate["tokens"][0]))
    state["ssm_h"][0][0].copy_(_t(jstate["ssm_h"][0]))
    state["conv_tail"][0][0].copy_(_t(jstate["conv_tail"][0]))
    state["length"] = 9
    ids = ss.decode_step(b.model, geom, b.stages, state, b.devices)
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_array_equal(state["tokens"].numpy(), jnew["tokens"])
    np.testing.assert_allclose(state["ssm_h"][0][0].numpy(),
                               jnew["ssm_h"][0], **TOL)
    np.testing.assert_allclose(state["conv_tail"][0][0].numpy(),
                               jnew["conv_tail"][0], **TOL)
    assert state["length"] == 10


# ---------------------------------------------------------------------------
# generate against the JAX whole-sequence greedy

@functools.lru_cache(maxsize=None)
def family(name):
    """(port cfg, bridged params, JAX cfg, raw params, the jitted JAX
    greedy over packed whole sequences, prompts)."""
    over = FAMILIES[name]
    jcfg, cfg = jget(name).reduced(**over), get_arch(name).reduced(**over)
    raw = jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(0, cfg.spec.vocab, PROMPT)]
               for _ in range(N_PROMPTS)]
    n = PROMPT + NEW - 1
    seg = jnp.asarray(np.repeat(np.arange(N_PROMPTS, dtype=np.int32), n))
    pos = jnp.asarray(np.tile(np.arange(n, dtype=np.int32), N_PROMPTS))
    jraw = jax.tree.map(jnp.asarray, raw)
    head = jraw.get("unembed", jraw["embed"])

    @jax.jit
    def greedy(tokens):
        x, _ = JLM(jcfg).forward_chunk(jraw, tokens, seg, pos,
                                       compute_dtype=jnp.float32)
        h = jrms_norm(x, jraw["final_norm"], jcfg.rms_eps)
        return jnp.argmax(h @ head.T, axis=-1)
    return cfg, from_jax(cfg, raw, device="cpu"), greedy, prompts


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_generate_is_the_jax_greedy(name, mesh):
    cfg, params, greedy, prompts = family(name)
    d_p, d_s = mesh
    b = ss.DecodeStepBuilder(cfg, params, d_p=d_p, d_s=d_s,
                             compute_dtype=torch.float32, device="cpu",
                             chunk_cap=8 if d_s > 1 else None)
    ids = b.generate(prompts, NEW)
    assert b.geom.n_micro == min(d_p, N_PROMPTS)
    seqs = np.asarray([p + i[:-1] for p, i in zip(prompts, ids)], np.int32)
    want = np.asarray(greedy(jnp.asarray(seqs.reshape(-1)))).reshape(
        N_PROMPTS, -1)[:, PROMPT - 1:]
    np.testing.assert_array_equal(np.asarray(ids), want)


def test_one_shot_generate_serves_ssm_families():
    """The port's one-shot oracle (the chip phases' ``decode_verify``)
    runs ``forward_chunk`` for SSM and hybrid archs too."""
    from repro_torch.serve.engine import one_shot_generate
    for name in ("falcon-mamba-7b", "hymba-1.5b"):
        cfg, params, _, prompts = family(name)
        want = ss.DecodeStepBuilder(cfg, params, compute_dtype=torch.float32,
                                    device="cpu").generate(prompts, 3)
        assert one_shot_generate(cfg, params, prompts, 3, device="cpu") == \
            want


# ---------------------------------------------------------------------------
# the state after prefill

@functools.lru_cache(maxsize=None)
def jax_carry(name, i):
    """The JAX ``forward_chunk``'s carry after prompt ``i`` alone."""
    jcfg = jget(name).reduced(**FAMILIES[name])
    raw = jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.PRNGKey(0)))
    _, jctx = JLM(jcfg).forward_chunk(
        raw, jnp.asarray(family(name)[3][i], jnp.int32),
        jnp.zeros(PROMPT, jnp.int32), jnp.arange(PROMPT, dtype=jnp.int32),
        ctx=JLM(jcfg).init_ctx(PROMPT, jnp.float32), ctx_len=0,
        compute_dtype=jnp.float32)
    return jctx


@pytest.mark.parametrize("mesh,cap", [((1, 1), None), ((2, 2), 8)])
@pytest.mark.parametrize("name", ["hymba-1.5b", "deepseek-v2-lite"])
def test_prefill_state_is_the_forward_chunk_carry(name, mesh, cap):
    cfg, params, _, prompts = family(name)
    d_p, d_s = mesh
    b = ss.DecodeStepBuilder(cfg, params, d_p=d_p, d_s=d_s,
                             compute_dtype=torch.float32, device="cpu",
                             chunk_cap=cap)
    _, state = b.prefill(prompts, max_new=4)
    geom = b.geom
    assert state["length"] == PROMPT
    L_s = geom.layers_per_stage
    for i in range(len(prompts)):
        m, bb = divmod(i, geom.bm)
        jctx = jax_carry(name, i)
        for layer in range(cfg.spec.n_layers):
            p, l = divmod(layer, L_s)
            for key, ax in (("cache_k", 0), ("cache_v", 1)):
                if key not in state:
                    continue
                got = torch.cat([r[m, l, bb] for r in state[key][p]])
                np.testing.assert_allclose(
                    got[:PROMPT].numpy(), np.asarray(jctx[ax][layer]), **TOL)
                assert not got[PROMPT:].any()
            if "ssm_h" in state:
                got = torch.cat([r[m, l, bb] for r in state["ssm_h"][p]])
                np.testing.assert_allclose(got.numpy(),
                                           np.asarray(jctx.ssm_h[layer]),
                                           **TOL)
                got = torch.cat([r[m, l, bb] for r in state["conv_tail"][p]],
                                dim=1)
                np.testing.assert_allclose(got.numpy(),
                                           np.asarray(jctx.ssm_tail[layer]),
                                           **TOL)


# ---------------------------------------------------------------------------
# the rank merge of decode attention

@pytest.mark.parametrize("window", [0, 9])
@pytest.mark.parametrize("d", [2, 3])
def test_decode_attention_merge_equals_unsharded(d, window):
    """The ranks' partials merged equal attention over the whole cache;
    at ``length`` 20 of 3 x 16 rows the last rank holds no live row; the
    new row lands in its owner's block."""
    cfg = get_arch("llama3.2-3b").reduced()
    s = cfg.spec
    gen = torch.Generator().manual_seed(d)
    lp = DecoderLM(cfg).init(gen, device="cpu")["layers"]
    p = {k: v[0] for k, v in lp["attn"].items()}
    bm, s_loc, length = 3, 48 // d, 20
    rng = np.random.default_rng(d + window)
    cache_k = _t(rng.standard_normal((bm, 48, s.n_kv_heads, s.head_dim))
                 .astype(np.float32))
    cache_v = _t(rng.standard_normal(cache_k.shape).astype(np.float32))
    x = _t(rng.standard_normal((bm, s.d_model)).astype(np.float32))
    blocks_k = [c.clone() for c in cache_k.split(s_loc, dim=1)]
    blocks_v = [c.clone() for c in cache_v.split(s_loc, dim=1)]
    got = tattn.decode_attention(cfg, p, x, blocks_k, blocks_v,
                                 length=length, window=window)
    pos = torch.full((bm,), length, dtype=torch.int32)
    q, k_new, v_new = tattn.project_qkv(cfg, p, x, pos)
    np.testing.assert_array_equal(
        torch.cat(blocks_k, dim=1)[:, length].numpy(), k_new.numpy())
    cache_k[:, length], cache_v[:, length] = k_new, v_new
    rows = torch.arange(48, dtype=torch.int32)
    outs = []
    for b in range(bm):
        o = ref.flash_attention_reference(
            q[b:b + 1], cache_k[b], cache_v[b], torch.zeros(1, dtype=torch.int32),
            torch.zeros(48, dtype=torch.int32), pos[:1], rows, window=window,
            scale=1.0 / np.sqrt(s.head_dim))
        outs.append(o.reshape(1, -1))
    want = torch.cat(outs) @ p["wo"].T
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    # the last rank holds no live row: its partial is zero with lse -inf
    from repro_torch.kernels.ops import attention_with_lse
    seg_q, seg_kv, row = tattn.decode_meta(bm, s_loc, (d - 1) * s_loc, "cpu")
    kv = [t[-1].reshape(bm * s_loc, s.n_kv_heads, s.head_dim)
          for t in (blocks_k, blocks_v)]
    out, lse = attention_with_lse(q, *kv, seg_q, seg_kv, pos, row,
                                  window=window)
    assert (d - 1) * s_loc > length
    assert torch.isinf(lse).all() and not out.any()


def test_merge_of_no_live_row_is_zero():
    outs = [torch.ones(2, 1, 4), torch.full((2, 1, 4), 3.0)]
    lses = [torch.tensor([[0.0, -np.inf]]), torch.tensor([[0.0, -np.inf]])]
    got = sp.merge_partials(outs, lses)
    np.testing.assert_allclose(got[0].numpy(), 2.0)
    assert not got[1].any()


# ---------------------------------------------------------------------------
# the reference's dropped attention term

def test_reference_decode_drops_the_attention_term():
    """From the same cache (the port's prefill, which equals the JAX carry:
    ``test_prefill_state_is_the_forward_chunk_carry``), the JAX
    ``decode_step_fn``'s first ids differ from the whole-sequence greedy
    on reduced hymba-1.5b at seed 0; the port's equal it."""
    name = "hymba-1.5b"
    cfg, params, greedy, prompts = family(name)
    jcfg = jget(name).reduced()
    raw = jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.PRNGKey(0)))
    b = ss.DecodeStepBuilder(cfg, params, compute_dtype=torch.float32,
                             device="cpu")
    first, state = b.prefill(prompts, max_new=2)
    g = b.geom
    jgeom = jss.DecodeGeometry(g.batch_per_pod, PROMPT, 1, 1,
                               g.layers_per_stage, 1, jnp.float32)
    S = PROMPT + 1
    jstate = {"tokens": state["tokens"].numpy()}
    for key in ("cache_k", "cache_v"):
        jstate[key] = state[key][0][0][None, :, :, :, :S].numpy().copy()
    for key in ("ssm_h", "conv_tail"):
        jstate[key] = state[key][0][0][None].numpy().copy()
    jids, _ = _jax_decode(jcfg, raw, jgeom, jstate)
    ids = b.step(state)
    seqs = [p + [f] + [0] * (NEW - 2) for p, f in zip(prompts, first)]
    want = np.asarray(greedy(jnp.asarray(np.asarray(seqs, np.int32)
                                         .reshape(-1)))).reshape(
        N_PROMPTS, -1)[:, PROMPT]
    assert ids == list(want)
    assert list(jids.reshape(-1)) != list(want)
