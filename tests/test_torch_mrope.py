"""Port parity: qwen2-vl's M-RoPE and the modality stubs against the JAX
package, on the CPU, inputs from numpy seeds.

* ``mrope_positions_stub``: the port's ``[3, T]`` rows equal the JAX
  function's element for element (image patches at ``(0, h, w)``, text
  from ``max(gh, gw)`` on), and a grid that does not hold the patches
  raises;
* ``mrope_tables`` at text positions (three equal rows) equal
  ``rope_tables`` bit for bit, and ``DecoderLM.rope_tables`` of qwen2-vl
  without ``positions3`` is that table;
* ``apply_mrope`` at 3-D positions equals the JAX ``apply_mrope`` (float32,
  ``1e-5``) at qwen2-vl's sections (16, 24, 24) of 128 channels and the
  reduced config's (4, 2, 2) of 16, and differs from RoPE there;
* the vision and audio stubs: shape, dtype, device, N(0, 0.02) from the
  generator, the same draw for the same seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro.models.frontends import mrope_positions_stub as jax_positions
from repro_torch.configs import get_arch
from repro_torch.models import DecoderLM
from repro_torch.models import layers as tlayers
from repro_torch.models.frontends import (audio_frame_stub,
                                          mrope_positions_stub,
                                          vision_patch_stub)
from test_torch_threads import torch_thread_share  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_text,grid", [(32, (4, 4)), (5, (2, 6)),
                                         (0, (3, 1)), (7, (1, 1)),
                                         (100, (16, 16))])
def test_positions_stub_matches_jax(n_text, grid):
    n_patch = grid[0] * grid[1]
    want = np.asarray(jax_positions(n_text, n_patch, grid))
    got = mrope_positions_stub(n_text, n_patch, grid)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # text continues at max(gh, gw) on all three rows
    if n_text:
        assert (got[:, n_patch] == max(grid)).all()


def test_positions_stub_refuses_a_wrong_grid():
    with pytest.raises(ValueError, match="grid"):
        mrope_positions_stub(4, 10, (3, 3))


@pytest.mark.parametrize("head_dim,theta,sections", [
    (128, 1_000_000.0, (16, 24, 24)), (16, 1_000_000.0, (4, 2, 2))])
def test_text_positions_give_rope_tables_bit_for_bit(head_dim, theta,
                                                     sections):
    rng = np.random.default_rng(head_dim)
    pos = torch.from_numpy(rng.integers(0, 40_000, 300).astype(np.int32))
    got = tlayers.mrope_tables(torch.stack([pos, pos, pos]), head_dim, theta,
                               sections)
    want = tlayers.rope_tables(pos, head_dim, theta)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


def test_model_tables_default_to_text_positions():
    cfg = get_arch("qwen2-vl-7b").reduced()
    model = DecoderLM(cfg)
    pos = torch.arange(50, dtype=torch.int32)
    got = model.rope_tables(pos)
    want = tlayers.rope_tables(pos, cfg.spec.head_dim, cfg.rope_theta)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    pos3 = mrope_positions_stub(34, 16, (4, 4))
    got3 = model.rope_tables(pos3[0], pos3)
    want3 = tlayers.mrope_tables(pos3, cfg.spec.head_dim, cfg.rope_theta,
                                 cfg.mrope_sections)
    assert all(torch.equal(g, w) for g, w in zip(got3, want3))


@pytest.mark.parametrize("head_dim,sections,grid", [
    (128, (16, 24, 24), (6, 5)), (16, (4, 2, 2), (4, 4))])
def test_apply_mrope_matches_jax(head_dim, sections, grid):
    rng = np.random.default_rng(sum(sections))
    n_patch, n_text, H = grid[0] * grid[1], 21, 3
    pos3 = np.asarray(jax_positions(n_text, n_patch, grid))
    x = rng.standard_normal((n_patch + n_text, H, head_dim)).astype(
        np.float32)
    theta = 1_000_000.0
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), theta,
                               sections)
    got = tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                              theta, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the image span's height and width rows move it away from RoPE at the
    # temporal ids
    rope = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos3[0]),
                              theta)
    # (by far less at the reduced sections' low frequencies)
    assert float((rope[:n_patch] - got[:n_patch]).abs().max()) > 1e-3
    torch.testing.assert_close(rope[n_patch:], got[n_patch:], rtol=0,
                               atol=0)


def test_mrope_refuses_sections_that_do_not_fill_the_head():
    pos3 = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="sections"):
        tlayers.mrope_tables(pos3, 16, 1e6, (4, 2, 1))


@pytest.mark.parametrize("stub", [vision_patch_stub, audio_frame_stub])
def test_embedding_stubs(stub):
    cfg = get_arch("qwen2-vl-7b").reduced()
    a = stub(cfg, torch.Generator().manual_seed(3), 4096, device="cpu",
             dtype=torch.float32)
    b = stub(cfg, torch.Generator().manual_seed(3), 4096, device="cpu",
             dtype=torch.float32)
    assert tuple(a.shape) == (4096, cfg.spec.d_model)
    assert a.dtype == torch.float32 and a.device.type == "cpu"
    assert torch.equal(a, b)
    assert abs(float(a.std()) - 0.02) < 1e-3 and abs(float(a.mean())) < 1e-3
    half = stub(cfg, torch.Generator().manual_seed(3), 8, device="cpu")
    assert half.dtype == torch.bfloat16
