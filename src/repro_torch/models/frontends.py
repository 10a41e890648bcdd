"""Modality frontend stubs: the [vlm] and [audio] entries specify the
transformer backbone only, and these stand in for its inputs.

Counterpart of the JAX package's ``models/frontends.py``: random
image-patch and audio-frame embeddings (the ViT tower's and the audio
adaptor's outputs) drawn from an explicit ``torch.Generator`` on the
device the caller names, and qwen2-vl's M-RoPE position rows. The
embedding values differ from ``jax.random``'s; the positions are the
reference's element for element.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .config import ArchConfig

__all__ = ["vision_patch_stub", "audio_frame_stub", "mrope_positions_stub"]


def mrope_positions_stub(n_text: int, n_patches: int, grid: Tuple[int, int],
                         *, device=None) -> torch.Tensor:
    """``[3, T]`` int32 (t, h, w) position ids, ``T = n_patches + n_text``:
    the image patches first at 2-D coordinates ``(0, h, w)`` of the ``gh x
    gw`` grid (row-major), then the text at ``max(gh, gw)`` onwards on all
    three rows."""
    gh, gw = grid
    if gh * gw != n_patches:
        raise ValueError(f"grid {grid} holds {gh * gw} patches, not "
                         f"{n_patches}")
    kw = dict(dtype=torch.int32, device=device)
    t_img = torch.zeros(n_patches, **kw)
    h_img = torch.arange(gh, **kw).repeat_interleave(gw)
    w_img = torch.arange(gw, **kw).repeat(gh)
    t_txt = max(gh, gw) + torch.arange(n_text, **kw)
    return torch.stack([torch.cat([t_img, t_txt]),
                        torch.cat([h_img, t_txt]),
                        torch.cat([w_img, t_txt])])


def vision_patch_stub(cfg: ArchConfig, gen: torch.Generator, n_patches: int,
                      *, device, dtype=torch.bfloat16) -> torch.Tensor:
    """Precomputed image-patch embeddings ``[n_patches, D]``, N(0, 0.02)
    (the real model's ViT tower output after the patch merger)."""
    return (torch.randn((n_patches, cfg.spec.d_model), generator=gen,
                        device=device) * 0.02).to(dtype)


def audio_frame_stub(cfg: ArchConfig, gen: torch.Generator, n_frames: int,
                     *, device, dtype=torch.bfloat16) -> torch.Tensor:
    """Precomputed audio-frame embeddings ``[n_frames, D]``, N(0, 0.02)
    (the real model's feature extractor and adaptor output)."""
    return (torch.randn((n_frames, cfg.spec.d_model), generator=gen,
                        device=device) * 0.02).to(dtype)
