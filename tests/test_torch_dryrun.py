"""Port parity: the dry-run (``repro_torch.launch.dryrun``) against the JAX
package's ``launch/dryrun.py``.

The reference's ``run_cell`` lowers and compiles each cell on 512
placeholder CPU devices; it runs in a subprocess (its module sets the
placeholder-device flag itself), once per test module, with its abstract
structures' bytes (``abstract_params``, ``init_opt_state``,
``decode_state_struct``) beside each record. The port runs the same cells
on the meta device at the reference's ``ClusterSpec`` numbers (TPU v5e:
197e12 flop/s, 16e9 bytes, 819e9 bytes/s, ``link_bw`` 50e9, ``net_bw``
25e9/8), and:

* ``plan`` (but the solver's wall time), ``geometry``, the skip reason and
  ``n_devices`` are equal;
* ``analytic_collectives`` agree within 1e-9 relative;
* summed over every rank, the port's parameter and AdamW bytes (train) and
  decode-state bytes (decode) equal the reference's structures once the
  reference's inert layer slots are taken out (padded slots; an
  encoder stage's decoder-only leaves) and the vocabulary's padding rows
  dropped, the port holding the tied embedding on two stages;
* the CLI exits 0 with no card visible and never initialises CUDA.

This module takes the training cells and the skipped one;
``test_torch_dryrun_serve.py`` the prefill and decode cells.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from test_torch_threads import torch_thread_share  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

CELLS = [("gemma3-1b", "train_4k", False),
         ("seamless-m4t-v2", "train_4k", False),
         ("llama3.2-3b", "long_500k", False)]

# the reference's run_cell, then its structures' bytes: each "stages" leaf
# [d_p, L_s, ...] counted for its active slots only (an encoder-decoder's
# encoder slots hold no cross-attention or ln_x), the vocabulary tables at
# their unpadded rows
REF_SCRIPT = textwrap.dedent(r"""
    import json, sys, tempfile
    from pathlib import Path
    from repro.launch import dryrun as d
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.configs import SHAPES, get_arch
    from repro.launch.mesh import make_production_mesh
    from repro.models import DecoderLM, EncDecLM
    from repro.optim import init_opt_state
    from repro.runtime.train_step import prepare_params
    from repro.runtime.encdec_pipeline import (make_encdec_geometry,
                                               prepare_encdec_params)
    from repro.runtime.serve_step import (decode_state_struct,
                                          make_decode_geometry)

    def nbytes(x):
        return int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize

    def active(tree, cfg, d_p):
        s = cfg.spec
        total = 0
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            keys = [getattr(k, "key", getattr(k, "idx", None))
                    for k in path]
            n = nbytes(leaf)
            if keys[0] == "stages":
                slots = leaf.shape[0] * leaf.shape[1]
                used = s.n_layers
                if s.is_encoder_decoder and not (
                        "cross" in keys or "ln_x" in keys):
                    used += s.n_encoder_layers
                n = n * used // slots
            elif keys[0] in ("embed", "unembed"):
                n = n * s.vocab // leaf.shape[0]
            total += n
        return total

    out = {}
    cells = json.loads(sys.argv[1])
    for arch, shape, mp in cells:
        with tempfile.TemporaryDirectory() as tmp:
            rec = d.run_cell(arch, shape, mp, Path(tmp))
        keep = {k: rec.get(k) for k in ("status", "reason", "plan",
                                        "geometry", "analytic_collectives",
                                        "n_devices")}
        if rec["status"] == "ok":
            cfg, sh = get_arch(arch), SHAPES[shape]
            mesh = make_production_mesh(multi_pod=mp)
            d_p, d_s = mesh.shape["data"], mesh.shape["model"]
            key = jax.random.PRNGKey(0)
            if sh.kind == "decode":
                n_pods = 2 if mp else 1
                geom = make_decode_geometry(
                    cfg, mesh, batch_per_pod=max(1, sh.global_batch
                                                 // n_pods),
                    cache_len=sh.seq_len)
                st = decode_state_struct(cfg, geom, n_pods)
                keep["decode_state_bytes"] = sum(nbytes(x)
                                                 for x in st.values())
            if cfg.spec.is_encoder_decoder and sh.kind != "decode":
                geom = make_encdec_geometry(cfg, mesh, n_chunks=1, cap=d_s,
                                            cap_enc=d_s, ctx_cap=2 * d_s)
                ps = jax.eval_shape(lambda k: prepare_encdec_params(
                    cfg, EncDecLM(cfg).init(k, jnp.float32), geom), key)
            elif not cfg.spec.is_encoder_decoder:
                ps = jax.eval_shape(lambda k: prepare_params(
                    cfg, DecoderLM(cfg).init(k, jnp.float32), mesh,
                    jnp.bfloat16,
                    v_stages=rec["plan"].get("v_stages", 1)), key)
            if not (cfg.spec.is_encoder_decoder and sh.kind == "decode"):
                opt = jax.eval_shape(init_opt_state, ps)
                keep["param_bytes"] = active(ps, cfg, d_p)
                keep["adamw_bytes"] = sum(active(opt[k], cfg, d_p)
                                          for k in ("master", "m", "v"))
                keep["embed_bytes"] = cfg.spec.vocab * cfg.spec.d_model * 2
                keep["tied"] = bool(cfg.tie_embeddings)
        out["|".join(map(str, (arch, shape, mp)))] = keep
    print("REF=" + json.dumps(out))
""")


def reference_records(cells):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, json.dumps(cells)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    line = next(ln for ln in r.stdout.splitlines() if ln.startswith("REF="))
    return json.loads(line[4:])


def reference_cluster():
    from repro_torch.core import ClusterSpec
    return ClusterSpec(flops_per_chip=197e12, hbm_bytes=16e9, hbm_bw=819e9,
                       link_bw=50e9, net_bw=25e9 / 8)


def port_record(arch, shape, mp):
    from repro_torch.launch.dryrun import run_cell
    return run_cell(arch, shape, mp, cluster=reference_cluster())


def check_cell(ref, rec, arch, shape, mp):
    """Everything the port's record shares with the reference's."""
    assert rec["status"] == ref["status"], (rec.get("reason"), ref)
    if ref["status"] == "skipped":
        assert rec["reason"] == ref["reason"]
        return
    assert rec["n_devices"] == ref["n_devices"] == (512 if mp else 256)
    want = dict(ref["plan"])
    got = dict(rec["plan"])
    want.pop("solve_time_s", None)
    got.pop("solve_time_s", None)
    assert got == want
    assert rec["geometry"] == ref["geometry"]
    for k, v in ref["analytic_collectives"].items():
        assert rec["analytic_collectives"][k] == pytest.approx(v, rel=1e-9)
    tot = rec["memory"]["totals"]
    if "decode_state_bytes" in ref:
        assert tot["decode_state"] == ref["decode_state_bytes"]
    # the port keeps the tied embedding on its first (decoder) stage and
    # its last, the reference one copy replicated over the stages
    extra = ref["embed_bytes"] if ref["tied"] else 0
    assert tot["params"] == ref["param_bytes"] + extra
    if shape.startswith("train"):
        assert tot["adamw"] == ref["adamw_bytes"] + 6 * extra
        assert tot["grad_sums"] == 2 * tot["params"]


@pytest.fixture(scope="module")
def ref():
    return reference_records(CELLS)


@pytest.mark.parametrize("arch,shape,mp", CELLS)
def test_cell_matches_the_reference(ref, arch, shape, mp):
    rec = port_record(arch, shape, mp)
    check_cell(ref["|".join(map(str, (arch, shape, mp)))], rec, arch, shape,
               mp)
    if rec["status"] == "ok":
        # a rank's holding: every stage sized, the largest the record's
        mem = rec["memory"]
        assert len(mem["argument_bytes_per_stage"]) == 16
        assert mem["argument_bytes"] == max(mem["argument_bytes_per_stage"])


def test_cli_runs_without_a_card(tmp_path):
    """The CLI on one decode cell, no card visible: exit 0, the record
    written under the reference's name, CUDA never initialised."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    code = textwrap.dedent(f"""
        import sys, torch
        from repro_torch.launch import dryrun
        try:
            dryrun.main(["--arch", "gemma3-1b", "--shape", "decode_32k",
                         "--multipod", "--out", {str(tmp_path)!r}])
        except SystemExit as e:
            print("EXIT", e.code, torch.cuda.is_initialized())
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "EXIT 0 False" in r.stdout, r.stdout[-2000:]
    rec = json.loads((tmp_path / "gemma3-1b__decode_32k__2x16x16.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "2x16x16"
    unit, = rec["units"]
    assert unit["ranks"] == 16 and unit["trace_peak_bytes"] > 0
    assert rec["kernel_ops"]["flash_fwd_mma_kernel"]["calls"] == 32
    # (a cell already written is skipped, as the reference's sweep does)
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "gemma3-1b", "--shape", "decode_32k",
                        "--multipod", "--out", str(tmp_path)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0 and "[skip-cached]" in r.stdout


@pytest.mark.parametrize("flag", ["--cache-dir=x", "--lint=warn"])
def test_cli_refuses_what_is_not_ported(flag, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "gemma3-1b", "--shape", "decode_32k",
                        "--out", str(tmp_path), flag],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 2
    assert ("item 8" if "cache" in flag else "item 10") in r.stderr
