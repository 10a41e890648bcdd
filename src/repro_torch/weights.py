"""Weight bridge: the JAX package's parameters (as numpy arrays) -> the
port's parameter dict.

Two source layouts are accepted:

* the raw ``DecoderLM.init`` layout: ``{"embed", "layers", "final_norm"
  [, "unembed"]}`` with layer leaves ``[L, ...]``;
* the serving engine's stage layout (``prepare_params``): ``{"stages",
  "embed", "final_norm" [, "unembed"]}`` with stage leaves
  ``[d_p, L_s, ...]`` (inert padding layer slots at the end) and the
  vocabulary padded to a multiple of ``d_s``;
* the encoder-decoder's ``EncDecLM.init`` layout: ``{"embed",
  "enc_layers", "enc_norm", "dec_layers", "final_norm"}`` with layer
  leaves ``[L, ...]``, which become per-layer lists
  (``models/encdec.EncDecLM``).

The reference stores dense weights ``[d_in, d_out]``; the port stores
``[d_out, d_in]`` (``F.linear``). This module is the only place that
transposes.

Between the model's layout and a pipeline's stages: :func:`to_stages` /
:func:`from_stages` for parameters, :func:`state_to_stages` /
:func:`state_from_stages` for a trainer's whole state (parameters and
AdamW's master, moments and step: the checkpoint tree, which no depth or
``v`` shapes; the port's counterpart of the reference's
``runtime/sharding.restack_elastic``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.model import layer_params, unstack_layers
from repro_torch.runtime.sharding import encdec_stage_layers, stage_blocks

__all__ = ["DENSE_LEAVES", "from_jax", "to_stages", "from_stages",
           "OPT_KEYS", "state_from_stages", "state_to_stages"]

# leaves stored [d_in, d_out] by the reference (the mamba mixer's conv_w
# [d_conv, d_inner] is not a dense weight and keeps its layout; stacked
# experts [E, d_in, d_out] swap their last two axes as one weight does)
DENSE_LEAVES = frozenset({"wq", "wk", "wv", "wo", "w_dkv", "w_kr", "w_uk",
                          "w_uv", "w_gate", "w_up", "w_down", "router",
                          "in_proj", "x_proj", "dt_proj", "out_proj"})


def _convert(tree: Mapping[str, Any], fn, name: str = ""):
    if isinstance(tree, Mapping):
        return {k: _convert(v, fn, k) for k, v in tree.items()}
    return fn(name, np.asarray(tree))


def from_jax(cfg: ArchConfig, params: Mapping[str, Any], *, device,
             dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Convert reference parameters (numpy arrays, or anything
    ``np.asarray`` takes) in either layout into the port's layout, on
    ``device`` (which the caller names: there is no default)."""
    s = cfg.spec
    if "enc_layers" in params:
        return _encdec_from_jax(params, dtype, device)
    if "layers" in params:
        layers = params["layers"]
        lead = 1
    elif "stages" in params:
        layers = params["stages"]
        lead = 2
    else:
        raise ValueError(f"unrecognized parameter layout: {sorted(params)}")

    def layer_leaf(name, a):
        # [L, ...] or [d_p, L_s, ...] -> [n_layers, ...] (drop pad slots)
        a = a.reshape(-1, *a.shape[lead:])
        if a.shape[0] < s.n_layers:
            raise ValueError(f"{name}: {a.shape[0]} layer slots for "
                             f"{s.n_layers} layers")
        a = a[:s.n_layers]
        if name in DENSE_LEAVES:
            a = np.swapaxes(a, -1, -2)
        return _tensor(a, dtype, device)

    out = {"layers": _convert(layers, layer_leaf),
           "final_norm": _tensor(np.asarray(params["final_norm"])[:s.d_model],
                                 dtype, device)}
    for name in ("embed", "unembed"):
        if name in params:
            # vocab padding rows (stage layout) are dropped
            out[name] = _tensor(np.asarray(params[name])[:s.vocab], dtype,
                                device)
    return out


def _encdec_from_jax(params, dtype, device) -> Dict[str, Any]:
    """``EncDecLM.init``'s tree -> the port's, layers as per-layer lists."""
    def layers(tree) -> List[Dict[str, Any]]:
        n = len(np.asarray(next(iter(_flat(tree)))))
        return [_convert(tree, lambda name, a, i=i: _tensor(
            np.swapaxes(a[i], -1, -2) if name in DENSE_LEAVES else a[i],
            dtype, device)) for i in range(n)]
    out = {k: _tensor(np.asarray(params[k]), dtype, device)
           for k in ("embed", "enc_norm", "final_norm")}
    out["enc_layers"] = layers(params["enc_layers"])
    out["dec_layers"] = layers(params["dec_layers"])
    return out


def _flat(tree):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _flat(v)
    else:
        yield tree


def _tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    # a fresh writable float32 copy: jax hands out read-only buffers
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(
        device=device, dtype=dtype)


def to_stages(cfg: ArchConfig, params: Mapping[str, Any], d_p: int,
              v: int = 1, *, decode: bool = False) -> List[Dict[str, Any]]:
    """The port's parameter dict -> one dict per pipeline stage (the same
    tensors, layers unstacked): ``layers`` maps each global layer id the
    stage runs (``runtime/sharding.stage_blocks``) to its parameters; the
    first stage holds ``embed``, the last ``final_norm`` and the head:
    ``unembed``, or with tied embeddings ``embed`` again (the trainer
    keeps a copy on each of the two stages' devices).

    An encoder-decoder (``v`` 1) takes the encoder/decoder split
    (``runtime/sharding.encdec_stage_layers``): an encoder stage holds
    ``enc_layers`` (id -> parameters), a decoder stage ``dec_layers``;
    the first decoder stage also ``embed`` (the token embedding) and
    ``enc_norm`` (it norms the finished encoder rows), the last
    ``final_norm`` and ``embed`` (the tied head; one copy when the two
    stages are one).

    ``decode``: the pipelined decode's layout (``runtime/serve_step``), the
    counterpart of the reference's ``prepare_encdec_decode_params``. A
    decoder-only model's is the layout above at ``v`` 1. An
    encoder-decoder's decoder layers spread over all ``d_p`` stages as
    ``layers`` (``stage_blocks``), and the first stage also keeps the
    encoder for the prefill (``enc_layers``, a list, and ``enc_norm``)
    with ``embed``; the last holds ``final_norm`` and ``embed`` (the tied
    head)."""
    if decode and v != 1:
        raise ValueError(f"the decode layout has one virtual stage, got "
                         f"v={v}")
    if cfg.spec.is_encoder_decoder and decode:
        return _encdec_decode_stages(cfg, params, d_p)
    if cfg.spec.is_encoder_decoder:
        return _encdec_to_stages(cfg, params, d_p)
    # (the decode layout takes views of stacked layers: no second copy of
    # the weights beside the caller's)
    layers = params["layers"] if not decode or isinstance(
        params["layers"], list) else [layer_params(params, i) for i in
                                      range(cfg.spec.n_layers)]
    if not decode:
        layers = unstack_layers(dict(params))["layers"]
    out = []
    for p, blocks in enumerate(stage_blocks(d_p, cfg.spec.n_layers, v)):
        sp: Dict[str, Any] = {"layers": {i: layers[i] for b in blocks
                                         for i in b}}
        if p == 0:
            sp["embed"] = params["embed"]
        if p == d_p - 1:
            sp["final_norm"] = params["final_norm"]
            head = "unembed" if "unembed" in params else "embed"
            sp[head] = params[head]
        out.append(sp)
    return out


def _encdec_to_stages(cfg: ArchConfig, params: Mapping[str, Any],
                      d_p: int) -> List[Dict[str, Any]]:
    s = cfg.spec
    layout = encdec_stage_layers(s.n_encoder_layers, s.n_layers, d_p)
    first_dec = next(p for p, (role, _) in enumerate(layout)
                     if role == "decoder")
    out = []
    for p, (role, ids) in enumerate(layout):
        key = "enc_layers" if role == "encoder" else "dec_layers"
        sp: Dict[str, Any] = {key: {i: params[key][i] for i in ids}}
        if p == first_dec:
            sp["embed"], sp["enc_norm"] = params["embed"], params["enc_norm"]
        if p == d_p - 1:
            sp["final_norm"], sp["embed"] = params["final_norm"], \
                params["embed"]
        out.append(sp)
    return out


def _encdec_decode_stages(cfg: ArchConfig, params: Mapping[str, Any],
                          d_p: int) -> List[Dict[str, Any]]:
    out = []
    for p, blocks in enumerate(stage_blocks(d_p, cfg.spec.n_layers)):
        sp: Dict[str, Any] = {"layers": {i: params["dec_layers"][i]
                                         for b in blocks for i in b}}
        if p == 0:
            sp.update(embed=params["embed"],
                      enc_layers=list(params["enc_layers"]),
                      enc_norm=params["enc_norm"])
        if p == d_p - 1:
            sp.update(final_norm=params["final_norm"], embed=params["embed"])
        out.append(sp)
    return out


def from_stages(cfg: ArchConfig, stages: Sequence[Mapping[str, Any]]
                ) -> Dict[str, Any]:
    """Per-stage dicts (parameters, or gradients in their structure) ->
    the model's structure, ``layers`` a per-layer list; a tied embedding
    is the first stage's (an encoder-decoder's: the first decoder
    stage's)."""
    if cfg.spec.is_encoder_decoder:
        s = cfg.spec
        merged: Dict[str, Dict[int, Any]] = {"enc_layers": {},
                                             "dec_layers": {}}
        for sp in stages:
            for key in merged:
                merged[key].update(sp.get(key, {}))
        first_dec = next(sp for sp in stages if "enc_norm" in sp)
        return {"embed": first_dec["embed"],
                "enc_layers": [merged["enc_layers"][i]
                               for i in range(s.n_encoder_layers)],
                "enc_norm": first_dec["enc_norm"],
                "dec_layers": [merged["dec_layers"][i]
                               for i in range(s.n_layers)],
                "final_norm": stages[-1]["final_norm"]}
    layers: Dict[int, Any] = {}
    for sp in stages:
        layers.update(sp["layers"])
    out = {"embed": stages[0]["embed"],
           "final_norm": stages[-1]["final_norm"],
           "layers": [layers[i] for i in range(cfg.spec.n_layers)]}
    if "unembed" in stages[-1]:
        out["unembed"] = stages[-1]["unembed"]
    return out


OPT_KEYS = ("master", "m", "v")      # AdamW's per-parameter state


def state_from_stages(cfg: ArchConfig, params: Sequence[Mapping[str, Any]],
                      opts: Sequence[Mapping[str, Any]]) -> Dict[str, Any]:
    """A trainer's state on any number of stages -> the checkpoint tree,
    which no pipeline depth shapes: ``params`` and each of
    :data:`OPT_KEYS` in the model's layout (:func:`from_stages`: layers by
    global id, a tied embedding once, as the first stage's copy), and the
    AdamW ``step``. ``params`` and ``opts``: one entry per stage."""
    steps = {int(o["step"]) for o in opts}
    if len(steps) != 1:
        raise ValueError(f"the stages' AdamW steps differ: {sorted(steps)}")
    out = {"params": from_stages(cfg, params), "step": steps.pop()}
    for key in OPT_KEYS:
        out[key] = from_stages(cfg, [o[key] for o in opts])
    return out


def state_to_stages(cfg: ArchConfig, state: Mapping[str, Any], d_p: int,
                    v: int = 1) -> Tuple[List[Dict[str, Any]],
                                         List[Dict[str, Any]]]:
    """The checkpoint tree -> ``(params, opts)`` per stage for ``d_p``
    stages of ``v`` virtual stages each (:func:`to_stages`; a tied
    embedding's saved copy goes to both of its stages). The tensors are
    the state's own: a caller copies them into its stages'."""
    params = to_stages(cfg, state["params"], d_p, v)
    opts = [{"step": int(state["step"])} for _ in range(d_p)]
    for key in OPT_KEYS:
        for o, sp in zip(opts, to_stages(cfg, state[key], d_p, v)):
            o[key] = sp
    return params, opts
