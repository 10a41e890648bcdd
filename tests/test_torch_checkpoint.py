"""The port's checkpoints (``repro_torch.ckpt``) and the re-staging of a
trainer's state between pipeline depths (``weights.state_from_stages`` /
``state_to_stages``, the trainers' ``state_tree`` / ``load_state``), on
the CPU.

* Protocol (the reference's): a crashed save is invisible, stray
  ``step_*`` directories are skipped, ``gc`` keeps the newest by parsed
  step, a leaf-count, name or shape mismatch raises (``adapt`` may
  convert a shape), bf16 leaves round-trip bit for bit, each leaf lands
  on its template leaf's device.
* Async save: the host copy is taken before ``save`` returns, so an
  in-place update right after it does not reach the saved bits; one
  pending save at most.
* Re-staging: a state saved from 1, 2 or 4 stages (interleaved ``v`` too)
  restores into any other depth bit for bit, for decoder layouts (a tied
  embedding saved once and restored into both copies; an untied head) and
  the encoder-decoder's ``enc_layers`` / ``dec_layers`` split. A resume
  under another ``v`` raises with the reference's message.
"""

import json
import os

import pytest
import torch

from repro_torch.ckpt import CheckpointManager, named_leaves, state_bytes
from repro_torch.configs import get_arch
from repro_torch.models import DecoderLM, EncDecLM
from repro_torch.models.model import tree_leaves, tree_map
from repro_torch.runtime.encdec_pipeline import EncDecGeometry
from repro_torch.runtime.pipeline import PipelineGeometry
from repro_torch.runtime.train_step import (ChunkedTrainer, EncDecTrainer,
                                            PipelineTrainer)
from repro_torch.weights import OPT_KEYS

from test_torch_threads import torch_thread_share  # noqa: F401

CPU = torch.device("cpu")


def _tree(seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return {"b": {"w": torch.randn(3, 4, generator=g).to(dtype),
                  "v": [torch.randn(5, generator=g).to(dtype),
                        torch.randn(2, 2, generator=g).to(dtype)]},
            "a": torch.arange(6, dtype=torch.int64), "step": 7}


def _equal(a, b):
    la, lb = named_leaves(a), named_leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (n, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, n
            assert torch.equal(x.view(torch.uint8) if x.dim() else x,
                               y.view(torch.uint8) if y.dim() else y), n
        else:
            assert x == y, n


# ---------------------------------------------------------------------------
# the protocol

def test_names_are_paths_in_sorted_order():
    names = [n for n, _ in named_leaves(_tree())]
    assert names == ["a", "b/v/0", "b/v/1", "b/w", "step"]
    with pytest.raises(TypeError, match="b/x"):
        named_leaves({"b": {"x": "text"}})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_round_trip_is_bitwise(tmp_path, dtype):
    tree = _tree(1, dtype)
    # every bit pattern of the 16-bit types, NaN payloads included
    if dtype != torch.float32:
        tree["b"]["all"] = torch.arange(-2 ** 15, 2 ** 15,
                                        dtype=torch.int32).to(
            torch.int16).view(dtype)
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, tree, extra={"step": 3})
    got, extra = mgr.restore(tree)
    assert extra == {"step": 3}
    _equal(got, tree)
    meta = json.loads((tmp_path / "step_00000003" / "manifest.json")
                      .read_text())
    assert meta["dtypes"][1] == str(dtype).removeprefix("torch.")
    assert mgr.stats["bytes"] == state_bytes(tree)


def test_crashed_save_and_strays_are_invisible(tmp_path):
    mgr = CheckpointManager(tmp_path)
    assert mgr.latest_step() is None
    mgr.save(7, _tree())
    mgr.wait()
    # a crash between the manifest and the rename, a crash before the
    # manifest, editor backups and scratch directories
    for stray, manifest in (("step_00000009.tmp", True),
                            ("step_00000011", False), ("step_tmp", True),
                            ("step_00000003.bak", True)):
        os.makedirs(tmp_path / stray)
        if manifest:
            (tmp_path / stray / "manifest.json").write_text("{}")
    assert mgr.latest_step() == 7
    _, extra = mgr.restore(_tree())
    mgr._gc()
    assert mgr.latest_step() == 7
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(_tree())


def test_gc_keeps_the_newest_by_parsed_step(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for step in (9, 10, 100, 11):
        mgr.save(step, tree_map(lambda x: x + step if isinstance(
            x, torch.Tensor) else x, _tree()))
    mgr.wait()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000011", "step_00000100"]
    got, _ = mgr.restore(_tree())
    assert torch.equal(got["a"], _tree()["a"] + 100)


def test_mismatches_raise(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(0, _tree())
    fewer = _tree()
    del fewer["step"]
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore(fewer)
    renamed = _tree()
    renamed["c"] = renamed.pop("step")
    with pytest.raises(ValueError, match="'step' in the checkpoint"):
        mgr.restore(renamed)
    wider = _tree()
    wider["b"]["w"] = torch.zeros(3, 5)
    with pytest.raises(ValueError, match="b/w: shape mismatch"):
        mgr.restore(wider)
    # adapt converts a leaf whose shape differs
    got, _ = mgr.restore(wider, adapt=lambda a, t: torch.cat(
        [a, a[:, :1]], dim=1))
    assert torch.equal(got["b"]["w"][:, :4], _tree()["b"]["w"])


def test_restore_follows_the_template_devices(tmp_path):
    """Each leaf lands on its template leaf's device (``meta`` here: no
    data, but the placement is the caller's, not the CPU)."""
    mgr = CheckpointManager(tmp_path)
    mgr.save(0, _tree())
    template = tree_map(lambda x: x.to("meta") if isinstance(
        x, torch.Tensor) else x, _tree())
    got, _ = mgr.restore(template)
    assert {x.device.type for x in tree_leaves(got)
            if isinstance(x, torch.Tensor)} == {"meta"}


def test_async_save_copies_before_it_returns(tmp_path):
    """An in-place update made right after ``save`` returns (the next
    AdamW step) does not reach the saved bits; a second save waits for the
    first."""
    tree = _tree(2)
    want = tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                    else x, tree)
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, tree)
    with torch.no_grad():
        for x in tree_leaves(tree):
            if isinstance(x, torch.Tensor) and x.is_floating_point():
                x.mul_(-3.0).add_(1.0)
    mgr.save(2, tree)                   # waits for step 1's write
    mgr.wait()
    got1, _ = mgr.restore(tree, step=1)
    got2, _ = mgr.restore(tree, step=2)
    _equal(got1, want)
    _equal(got2, tree)
    assert mgr.stats["write_s"] >= 0 and mgr.stats["blocking_s"] >= 0


def test_a_failed_write_is_raised_by_wait(tmp_path):
    mgr = CheckpointManager(tmp_path / "d")
    (tmp_path / "d").rmdir()
    (tmp_path / "d").write_text("not a directory")
    mgr.save(0, _tree())
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        mgr.wait()


# ---------------------------------------------------------------------------
# re-staging between pipeline depths

def _random_state(cfg, params, seed, dtype):
    """A trainer state in the model's layout with random bits everywhere
    (parameters in ``dtype``, the AdamW state float32, step 5)."""
    g = torch.Generator().manual_seed(seed)
    rnd = lambda a, dt: torch.randn(a.shape, generator=g).to(dt)  # noqa: E731
    out = {"params": tree_map(lambda a: rnd(a, dtype), params), "step": 5}
    for k in OPT_KEYS:
        out[k] = tree_map(lambda a: rnd(a, torch.float32), params)
    return out


def _trainer(cfg, params, d_p, v, schedule, dtype):
    if d_p == 1:
        return ChunkedTrainer(cfg, params, device=CPU, compute_dtype=dtype)
    if cfg.spec.is_encoder_decoder:
        return EncDecTrainer(cfg, params, geometry=EncDecGeometry(
            d_p=d_p, schedule=schedule), cards=[CPU], compute_dtype=dtype)
    return PipelineTrainer(cfg, params, geometry=PipelineGeometry(
        d_p=d_p, schedule=schedule, v_stages=v), cards=[CPU],
        compute_dtype=dtype)


# (arch, [(d_p, v, schedule), ...]): each layout saved, then restored into
# the next one
RESTAGE = {
    "gemma3-1b (tied)": ("gemma3-1b", [(1, 1, None),
                                       (2, 1, "zero-bubble-h1"),
                                       (4, 1, "gpipe-1f1b"),
                                       (2, 2, "interleaved-1f1b"),
                                       (4, 2, "interleaved-1f1b"),
                                       (1, 1, None)]),
    "stablelm-12b (untied)": ("stablelm-12b", [(4, 1, "gpipe-1f1b"),
                                               (1, 1, None),
                                               (2, 4, "interleaved-1f1b"),
                                               (2, 1, "gpipe-1f1b")]),
    "seamless-m4t-v2 (encoder-decoder)": ("seamless-m4t-v2", [
        (2, 1, "gpipe-1f1b"), (4, 1, "zero-bubble-h1"),
        (2, 1, "gpipe-1f1b")]),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", sorted(RESTAGE))
def test_state_restages_bit_for_bit(tmp_path, case, dtype):
    arch, layouts = RESTAGE[case]
    cfg = get_arch(arch).reduced(n_layers=8)
    model = EncDecLM(cfg) if cfg.spec.is_encoder_decoder else DecoderLM(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=CPU)
    if not cfg.spec.is_encoder_decoder:
        from repro_torch.models.model import unstack_layers
        params = unstack_layers(params)
    state = _random_state(cfg, params, 1, dtype)
    mgr = CheckpointManager(tmp_path)
    for i, (d_p, v, sched) in enumerate(layouts):
        tr = _trainer(cfg, params, d_p, v, sched, dtype)
        if i == 0:
            tr.load_state(state)
        else:
            restored, extra = mgr.restore(tr.state_tree())
            assert extra == {"from": list(layouts[i - 1])}
            tr.load_state(restored)
        _equal(tr.state_tree(), state)
        if d_p > 1 and tr.tied is not None:
            # both copies of the tied embedding hold the saved one, in the
            # parameters and in each AdamW tensor
            (p0, p1), (i0, i1) = tr.tied_stages, tr.tied
            for a, b in ((tree_leaves(tr.params[p0])[i0],
                          tree_leaves(tr.params[p1])[i1]),
                         *((tree_leaves(tr.opt[p0][k])[i0],
                            tree_leaves(tr.opt[p1][k])[i1])
                           for k in OPT_KEYS)):
                assert a is not b and torch.equal(a, b)
        mgr.save(i, tr.state_tree(), extra={"from": [d_p, v, sched]})
        del tr
    mgr.wait()


def test_resume_under_another_v_raises(tmp_path):
    """The reference's guard: a checkpoint records its ``v_stages``, and a
    run pinned at another ``v`` refuses it (the port could re-stage it,
    but a run keeps its ``v``)."""
    from repro_torch.launch.train import TrainConfig, train
    cfg = get_arch("gemma3-1b").reduced(n_layers=4)
    kw = dict(global_batch=2, context=128, compute_dtype="float32", d_p=2,
              ckpt_dir=str(tmp_path), ckpt_every=1, lint="off")
    train(cfg, TrainConfig(steps=1, schedule="interleaved-1f1b",
                           v_stages=2, **kw), device=CPU, log=lambda s: None)
    meta = json.loads((tmp_path / "step_00000000" / "manifest.json")
                      .read_text())
    assert meta["extra"] == {"step": 0, "schedule": "interleaved-1f1b",
                             "v_stages": 2}
    with pytest.raises(ValueError, match="written with v_stages=2 but this "
                       "run pinned gpipe-1f1b v=1"):
        train(cfg, TrainConfig(steps=2, schedule="gpipe-1f1b", resume=True,
                               **kw), device=CPU, log=lambda s: None)
