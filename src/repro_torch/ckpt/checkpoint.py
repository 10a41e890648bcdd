"""Checkpoints of the port: the JAX package's ``ckpt/checkpoint.py``
protocol over named torch state.

Layout (one directory per step):

    step_00001230/
      manifest.json       <- written LAST: its presence marks the commit
      leaf_000000.npy ... <- one file per leaf, in the tree's name order

* A tree is nested dicts and lists of tensors and Python ints (the
  trainers' ``state_tree``: parameters, AdamW ``master``, ``m``, ``v`` in
  the model's layout, and the AdamW ``step``). Leaves are named by their
  path (``params/layers/3/attn/wq``) in :func:`named_leaves`' fixed order:
  dict keys sorted, list items in order. The manifest records each leaf's
  name, shape and torch dtype.
* numpy has no bfloat16: a bf16 leaf is written as its raw bits
  (``view(torch.int16)``) and viewed back on load, so every leaf
  round-trips bit for bit.
* ``save`` copies every leaf to the host before it returns (the trainers
  update their state in place, so a copy still in flight when the next
  step starts would save the wrong bits; :func:`host_copies`: pinned
  buffers, which the next save reuses from torch's pinned-memory cache);
  the file writes go to a
  background thread, at most one pending save (a second save waits for
  the first). The leaves go to ``step_N.tmp/``, ``manifest.json`` last,
  then the directory is renamed to ``step_N``: a crash mid-save leaves no
  manifest, and :meth:`latest_step` skips it.
* ``restore`` puts each leaf on its template leaf's device (the caller's
  state on the card: nothing lands on the CPU unless the template is
  there) and raises on a leaf-count, name or shape mismatch (``adapt``
  may convert a leaf whose shape differs).
* ``gc`` keeps the newest ``keep`` committed steps, ordered by parsed step.
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["CheckpointManager", "host_copies", "named_leaves",
           "state_bytes"]

_RAW = {torch.bfloat16: torch.int16}     # dtypes numpy lacks: stored as bits


def named_leaves(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(name, leaf)`` pairs of a tree of dicts and lists in a fixed order
    (dict keys sorted, list items in order); a leaf is a tensor or an
    int."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in named_leaves(v, f"{prefix}{i}/")]
    if not isinstance(tree, (torch.Tensor, int)):
        raise TypeError(f"checkpoint leaf {prefix[:-1]!r} is a "
                        f"{type(tree).__name__}, not a tensor or an int")
    return [(prefix[:-1], tree)]


def _unflatten(template: Any, leaves) -> Any:
    if isinstance(template, dict):
        built = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: built[k] for k in template}
    if isinstance(template, list):
        return [_unflatten(v, leaves) for v in template]
    return next(leaves)


def state_bytes(tree: Any) -> int:
    """Bytes of a tree's tensor leaves."""
    return sum(x.numel() * x.element_size() for _, x in named_leaves(tree)
               if isinstance(x, torch.Tensor))


def host_copies(leaves) -> List[Any]:
    """Host copies of ``leaves`` (tensors or ints) that later in-place
    updates cannot reach: a card's tensor is copied into a pinned buffer
    (non-blocking, then one synchronize per card: a pageable copy runs at
    a tenth of the rate), a host tensor is cloned."""
    out, cards = [], set()
    for x in leaves:
        if not isinstance(x, torch.Tensor):
            out.append(int(x))
            continue
        x = x.detach()
        if x.device.type == "cuda":
            buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            buf.copy_(x, non_blocking=True)
            cards.add(x.device)
        else:
            buf = x.clone(memory_format=torch.contiguous_format)
        out.append(buf)
    for d in cards:
        torch.cuda.synchronize(d)
    return out


def _dtype_name(x) -> str:
    return str(x.dtype).removeprefix("torch.") if isinstance(
        x, torch.Tensor) else "int"


def _to_numpy(x) -> np.ndarray:
    if not isinstance(x, torch.Tensor):
        return np.asarray(x, dtype=np.int64)
    raw = _RAW.get(x.dtype)
    return (x.view(raw) if raw is not None else x).numpy()


def _from_numpy(a: np.ndarray, dtype: str):
    if dtype == "int":
        return int(a)
    t = torch.from_numpy(np.ascontiguousarray(a))
    want = getattr(torch, dtype)
    return t.view(want) if want in _RAW else t.to(want)


class CheckpointManager:
    def __init__(self, directory, *, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # the last save's bytes, the seconds it blocked its caller (the
        # host copy), and, once written, the write's seconds (a new dict
        # each save: a caller may keep one)
        self.stats: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}"

    @staticmethod
    def _parse_step(name: str) -> Optional[int]:
        """``step_00000042`` -> 42; None for anything unparseable (editor
        backups, ``step_tmp`` scratch dirs, a crashed save's
        ``step_*.tmp``): stray directories never crash discovery."""
        tail = name[len("step_"):]
        return int(tail) if tail.isdigit() else None

    def _committed(self) -> List[Tuple[int, Path]]:
        out = []
        for p in self.dir.glob("step_*"):
            step = self._parse_step(p.name)
            if step is not None and (p / "manifest.json").exists():
                out.append((step, p))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self._committed()
        return steps[-1][0] if steps else None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, *,
             extra: Optional[Dict] = None) -> None:
        """Copy every leaf to the host now; write on the background
        thread (:meth:`wait` blocks until it is on disk)."""
        self.wait()
        t0 = time.perf_counter()
        named = named_leaves(tree)
        host = host_copies(x for _, x in named)
        blocking = time.perf_counter() - t0
        meta = {"step": step, "n_leaves": len(host),
                "names": [n for n, _ in named],
                "shapes": [list(x.shape) if isinstance(x, torch.Tensor)
                           else [] for x in host],
                "dtypes": [_dtype_name(x) for x in host],
                "extra": extra or {}, "wall_time": time.time()}
        stats = self.stats = {"step": step, "bytes": sum(
            x.numel() * x.element_size() for x in host
            if isinstance(x, torch.Tensor)), "blocking_s": blocking}

        def write():
            t1 = time.perf_counter()
            d = self._step_dir(step)
            tmp = d.with_suffix(".tmp")
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            for i, x in enumerate(host):
                np.save(tmp / f"leaf_{i:06d}.npy", _to_numpy(x))
            (tmp / "manifest.json").write_text(json.dumps(meta))
            if d.exists():
                shutil.rmtree(d)
            tmp.rename(d)
            self._gc()
            stats["write_s"] = time.perf_counter() - t1

        def run():
            try:
                write()
            except BaseException as e:  # noqa: BLE001
                self._error = e         # re-raised by wait()
        self._pending = threading.Thread(target=run, daemon=True,
                                         name="ckpt-writer")
        self._pending.start()

    def wait(self) -> None:
        """Block until the pending save is on disk; re-raise its error."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def _gc(self) -> None:
        # ordered by parsed step number, not by name: a stray step_*.tmp
        # never displaces a committed step from the keep window
        for _, p in self._committed()[:-self.keep]:
            shutil.rmtree(p, ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, template: Any, *, step: Optional[int] = None,
                adapt: Optional[Callable] = None) -> Tuple[Any, Dict]:
        """The checkpoint at ``step`` (default: the latest committed) in
        ``template``'s structure, each leaf on its template leaf's device;
        returns ``(tree, extra)``. ``adapt(saved, template_leaf) -> tensor
        | None`` may convert a leaf whose shape differs; any other
        mismatch raises ``ValueError``."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        d = self._step_dir(step)
        meta = json.loads((d / "manifest.json").read_text())
        named = named_leaves(template)
        if meta["n_leaves"] != len(named):
            raise ValueError(
                f"checkpoint has {meta['n_leaves']} leaves, template "
                f"{len(named)} — incompatible trees")
        names = [n for n, _ in named]
        if meta["names"] != names:
            bad = next(i for i, (a, b) in enumerate(zip(meta["names"], names))
                       if a != b)
            raise ValueError(f"leaf {bad} is {meta['names'][bad]!r} in the "
                             f"checkpoint, {names[bad]!r} in the template")
        out = []
        for i, (name, t) in enumerate(named):
            a = _from_numpy(np.load(d / f"leaf_{i:06d}.npy"),
                            meta["dtypes"][i])
            if not isinstance(t, torch.Tensor):
                out.append(int(a))
                continue
            if tuple(a.shape) != tuple(t.shape):
                conv = adapt(a, t) if adapt is not None else None
                if conv is None or tuple(conv.shape) != tuple(t.shape):
                    raise ValueError(f"{name}: shape mismatch "
                                     f"{tuple(a.shape)} vs {tuple(t.shape)}")
                a = conv
            out.append(a.to(t.device))
        return _unflatten(template, iter(out)), meta["extra"]
