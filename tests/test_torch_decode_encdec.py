"""Port parity: the encoder-decoder's pipelined prefill and decode
(seamless-m4t-v2: ``runtime/serve_step.DecodeStepBuilder`` with frames,
``EncDecLM.cross_decode``, ``runtime/encdec_pipeline.EncDecDecodeStage``)
against the JAX package, on the CPU, float32, inputs from numpy seeds,
weights carried by ``weights.from_jax``.

``generate``'s ids equal the JAX ``EncDecLM.encode`` and ``decode``
greedy over the whole sequence at ``(d_p, d_s)`` (1, 1) and (2, 2), the
prompts also split over chunks: one JAX encode of each request's frames
and one decode of its prompt with the port's ids behind it, whose argmax
at every generated position must be the port's next id. The frames (21 a
request) do not split evenly over two ranks: the padded frame is masked.
The decode layout (``prepare_encdec_decode_params``) holds the decoder
layers over all stages and the encoder on the first.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.models import EncDecLM as JEncDec
from repro.models.layers import rms_norm as jrms_norm
from repro_torch.configs import get_arch
from repro_torch.runtime.encdec_pipeline import prepare_encdec_decode_params
from repro_torch.runtime.serve_step import DecodeStepBuilder
from repro_torch.weights import from_jax
from test_torch_threads import torch_thread_share  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")

NAME = "seamless-m4t-v2"
N_REQ, PROMPT, FRAMES, NEW = 3, 11, 21, 6


@functools.lru_cache(maxsize=None)
def case():
    jcfg, cfg = jget(NAME).reduced(), get_arch(NAME).reduced()
    raw = jax.tree.map(np.asarray, JEncDec(jcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, cfg.spec.vocab, PROMPT)]
               for _ in range(N_REQ)]
    frames = (rng.standard_normal((N_REQ, FRAMES, cfg.spec.d_model))
              * 0.02).astype(np.float32)
    jraw = jax.tree.map(jnp.asarray, raw)
    n = PROMPT + NEW - 1
    seg = jnp.asarray(np.repeat(np.arange(N_REQ, dtype=np.int32), n))
    pos = jnp.asarray(np.tile(np.arange(n, dtype=np.int32), N_REQ))
    seg_e = jnp.asarray(np.repeat(np.arange(N_REQ, dtype=np.int32), FRAMES))
    pos_e = jnp.asarray(np.tile(np.arange(FRAMES, dtype=np.int32), N_REQ))
    model = JEncDec(jcfg)

    @jax.jit
    def greedy(tokens):
        mem = model.encode(jraw, jnp.asarray(frames).reshape(-1, frames.shape[
            -1]), seg_e, pos_e)
        x, _ = model.decode(jraw, tokens, seg, pos, mem, seg_e,
                            compute_dtype=jnp.float32)
        h = jrms_norm(x, jraw["final_norm"], jcfg.rms_eps)
        return jnp.argmax(h @ jraw["embed"].T, axis=-1)
    return cfg, from_jax(cfg, raw, device="cpu"), greedy, prompts, frames


@pytest.mark.parametrize("cap", [None, 4])
@pytest.mark.parametrize("mesh", [(1, 1), (2, 2)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_generate_is_the_jax_encode_decode_greedy(mesh, cap):
    cfg, params, greedy, prompts, frames = case()
    d_p, d_s = mesh
    b = DecodeStepBuilder(cfg, params, d_p=d_p, d_s=d_s,
                          compute_dtype=torch.float32, device="cpu",
                          chunk_cap=cap)
    ids = b.generate(prompts, NEW, frames=[torch.from_numpy(f)
                                           for f in frames])
    seqs = np.asarray([p + i[:-1] for p, i in zip(prompts, ids)], np.int32)
    want = np.asarray(greedy(jnp.asarray(seqs.reshape(-1)))).reshape(
        N_REQ, -1)[:, PROMPT - 1:]
    np.testing.assert_array_equal(np.asarray(ids), want)


def test_decode_layout_and_state():
    cfg, params, *_ = case()
    stages = prepare_encdec_decode_params(cfg, params, 2)
    s = cfg.spec
    assert [sorted(st["layers"]) for st in stages] == [[0, 1], [2, 3]]
    assert len(stages[0]["enc_layers"]) == s.n_encoder_layers
    assert stages[0]["embed"] is params["embed"]
    assert stages[1]["embed"] is params["embed"]
    assert "enc_layers" not in stages[1] and "final_norm" in stages[1]
    b = DecodeStepBuilder(cfg, params, d_p=2, d_s=2,
                          compute_dtype=torch.float32, device="cpu")
    _, state = b.prefill(case()[3], [torch.from_numpy(f)
                                     for f in case()[4]], max_new=2)
    assert state["mem_len"] == FRAMES
    mem = torch.cat(state["memory"], dim=2)
    assert mem.shape[2] == FRAMES + 1 and not mem[:, :, FRAMES:].any()
    with pytest.raises(ValueError, match="frames"):
        b.prefill(case()[3])
