"""The port stands alone: no module under ``src/repro_torch`` (nor
``chip_smoke.py``) imports jax or the JAX package, every module imports
with jax made unimportable, and the serving and training CLIs refuse to
run without a card unless the CPU is asked for.
"""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_JAX_IMPORT = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
_REPRO_REF = re.compile(r"\brepro\.|^\s*(import|from)\s+repro\b", re.M)


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.update(extra)
    return env


def _modules():
    out = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "repro_torch.serve.engine" in mods and len(mods) > 20
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None          # any `import jax` now fails
        for m in {mods!r}:
            importlib.import_module(m)
        bad = sorted(m for m in sys.modules
                     if m == "repro" or m.startswith("repro."))
        assert not bad, bad
        print("imported", len({mods!r}))
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=_env(), timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "imported" in r.stdout


def test_sources_name_neither_jax_nor_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert (ROOT / "chip_smoke.py").exists()
    for path in files:
        text = path.read_text()
        assert not _JAX_IMPORT.search(text), f"{path} imports jax"
        m = _REPRO_REF.search(text)
        assert m is None, f"{path} names the JAX package: {m.group(0)!r}"


def test_model_builders_name_their_device():
    """The builders have no default device, so nothing in the port builds
    on the CPU unless its caller asks for it."""
    import inspect

    from repro_torch.models import DecoderLM, attention, layers
    from repro_torch.weights import from_jax
    for fn in (DecoderLM.init, DecoderLM.init_ctx, from_jax,
               attention.init_attention, layers.dense_init,
               layers.embed_init, layers.swiglu_init, layers.rope_freqs):
        param = inspect.signature(fn).parameters["device"]
        assert param.default is inspect.Parameter.empty, fn.__qualname__


def test_cli_without_card_exits_nonzero():
    """No --device means cuda; with no usable card the CLI says so and
    exits non-zero instead of running on the CPU."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--requests", "2"],
        capture_output=True, text=True, timeout=120,
        env=_env(CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert "cuda" in r.stderr.lower()
    assert "serve OK" not in r.stdout


def test_cli_on_cpu_when_asked(tmp_path):
    """On the CPU the CLI serves and verifies; under ``--profile`` it says
    that no device time was measured (there are no device events)."""
    prof = tmp_path / "profile.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "llama3.2-3b", "--reduced", "--requests", "2",
         "--max-new", "2", "--verify", "1", "--profile", str(prof)],
        capture_output=True, text=True, timeout=120, env=_env())
    assert r.returncode == 0, r.stderr[-3000:]
    assert "serve OK" in r.stdout and "[verify]" in r.stdout
    assert "not measured" in prof.read_text()


def test_training_modules_are_in_the_import_sweep():
    """The training slice's modules are among those the sweep above
    imports with jax unimportable."""
    mods = set(_modules())
    for m in ("repro_torch.core.planner", "repro_torch.core.checkpointing",
              "repro_torch.core.ilp", "repro_torch.core.schedule",
              "repro_torch.core.grouping", "repro_torch.data.batching",
              "repro_torch.kernels.cross_entropy", "repro_torch.kernels.build",
              "repro_torch.optim.adamw", "repro_torch.runtime.train_step",
              "repro_torch.launch.train"):
        assert m in mods, m


def test_train_cli_without_card_exits_nonzero():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--steps", "1"],
        capture_output=True, text=True, timeout=120,
        env=_env(CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert "cuda" in r.stderr.lower()
    assert "train OK" not in r.stdout


def test_train_cli_on_cpu_when_asked(tmp_path):
    """Two reduced float32 steps on the CPU: one line per step with loss,
    tokens, wall time, tokens/s and memory; under ``--profile`` the summary
    says that no device time was measured."""
    prof = tmp_path / "profile.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "gemma3-1b", "--reduced", "--steps", "2", "--batch", "4",
         "--context", "256", "--profile", str(prof)],
        capture_output=True, text=True, timeout=300, env=_env())
    assert r.returncode == 0, r.stderr[-3000:]
    assert "train OK" in r.stdout
    steps = [ln for ln in r.stdout.splitlines() if ln.startswith("step ")]
    assert [ln.split()[1] for ln in steps] == ["0", "1"]
    for ln in steps:
        for word in ("loss", "tokens", "wall", "tok/s", "peak_mem",
                     "plan estimate"):
            assert word in ln, ln
    assert "not measured" in prof.read_text()
