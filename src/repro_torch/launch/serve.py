"""Continuous-batching serving driver of the port: runs
:class:`repro_torch.serve.engine.ServeEngine` over a synthetic
Poisson/lognormal request trace (``data/synth.sample_request_trace``).

On the card (the default device), in bfloat16:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
      --requests 16 --context-limit 4096 --max-new 32 --cap-t 512 --verify 2

On the CPU, at a reduced size:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch gemma3-1b --reduced --requests 6 --verify 2

``--mesh PxS`` (default ``1x1``, the one-card layout; the reference's
default is ``2x2`` on four fake devices) serves on ``P`` pipeline stages of
``S`` sequence-parallel ranks, stage ``p`` on card ``p mod --cards``, a
stage's ranks on its card (``runtime/sharding.stage_devices``; SP ranks
across cards are refused: they need the per-rank driver):

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch gemma3-1b --reduced --mesh 2x2 --verify 2

``--telemetry-dir DIR`` spills the engine's timeline (one ``engine`` event
per drained trace: TTFT and TPOT percentiles, occupancy) to
``DIR/timeline-serve.jsonl``.

``--profile PATH`` serves the trace under ``torch.profiler`` (after a
one-request warm-up) and writes a JSON summary: device time by kernel and
kernel group per engine step, kernel launches per step, the host's
busiest operators, and the device's busy share of the run's wall time (a
lower bound: the profiler's own overhead inflates the wall time).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default="1x1",
                    help="PxS: P pipeline stages of S sequence-parallel "
                         "ranks (default 1x1)")
    ap.add_argument("--cards", type=int, default=1,
                    help="cards the stages are placed on (stage p on "
                         "card p mod cards)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back")
    ap.add_argument("--dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="compute and parameter dtype (default: bfloat16 "
                         "on cuda, float32 on cpu)")
    # trace
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--trace", default="github",
                    help="length preset (github/commoncrawl/uniform)")
    ap.add_argument("--context-limit", type=int, default=96,
                    help="max prompt length the trace samples")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--arrival-rate", type=float, default=2.0,
                    help="Poisson arrivals per simulated second")
    ap.add_argument("--seed", type=int, default=0)
    # engine geometry
    ap.add_argument("--items", type=int, default=4,
                    help="packed chunk items per engine step")
    ap.add_argument("--cap-t", type=int, default=32,
                    help="tokens per item (= max prefill chunk)")
    ap.add_argument("--pages", type=int, default=0,
                    help="KV pages; 0 = auto (6 concurrent max-context "
                         "requests)")
    ap.add_argument("--page-sz", type=int, default=16)
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--system-prompt", type=int, default=0,
                    help="prepend a shared system prompt of this many "
                         "tokens to every request (0 = off)")
    ap.add_argument("--k", type=int, default=1,
                    help="decode tokens per stream per step (speculative "
                         "draft width; k=1 is plain greedy)")
    ap.add_argument("--prefill-mode", default="interleaved",
                    choices=["interleaved", "serial"])
    ap.add_argument("--decode-budget", type=int, default=0,
                    help="decode tokens per step (0 = auto)")
    ap.add_argument("--prefill-budget", type=int, default=0,
                    help="prefill tokens per step (0 = auto)")
    ap.add_argument("--stats-json", default="",
                    help="write the engine stats and output ids here")
    ap.add_argument("--verify", type=int, default=0,
                    help="cross-check the first N requests' ids against "
                         "the one-shot reference path")
    ap.add_argument("--profile", default="",
                    help="serve under torch.profiler and write its summary "
                         "here as JSON")
    ap.add_argument("--telemetry-dir", default="",
                    help="spill the telemetry timeline (the engine's "
                         "TTFT/TPOT/occupancy event) to this directory as "
                         "JSONL")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import sample_request_trace
    from repro_torch.device import (DeviceUnavailableError, dtype_of,
                                    resolve_device)
    from repro_torch.launch.train import parse_mesh
    from repro_torch.runtime.sharding import stage_devices
    from repro_torch.serve.engine import (EngineConfig, Request,
                                          ServeEngine,
                                          verify_against_one_shot)
    from repro_torch.telemetry import StepTimeline

    try:
        device = resolve_device(args.device)
        dp, ds = parse_mesh(args.mesh)
        cards = ([torch.device(device.type, i) for i in range(args.cards)]
                 if device.type == "cuda" else [device] * args.cards)
        stage_devices(dp, cards, ds)
    except (DeviceUnavailableError, ValueError, NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    dtype = dtype_of(args.dtype or ("bfloat16" if device.type == "cuda"
                                    else "float32"))
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    page_sz = args.page_sz
    pages_per_seq = -(-(args.context_limit + args.max_new) // page_sz)
    # auto: room for 6 concurrent max-context requests, rounded up to a
    # multiple of the ranks (the pool is sharded page-blockwise)
    n_pages = args.pages or -(-(6 * pages_per_seq) // ds) * ds
    trace = sample_request_trace(args.trace, args.requests,
                                 args.context_limit, cfg.spec.vocab,
                                 seed=args.seed,
                                 arrival_rate=args.arrival_rate,
                                 max_new_tokens=args.max_new,
                                 system_prompt_len=args.system_prompt)
    longest = max(len(t["prompt"]) for t in trace)
    if longest + args.max_new > pages_per_seq * page_sz:
        print(f"error: longest prompt ({longest}) + --max-new "
              f"({args.max_new}) exceeds the per-request page budget",
              file=sys.stderr)
        return 2
    econf = EngineConfig(
        n_items=args.items, cap_t=args.cap_t, n_pages=n_pages,
        page_sz=page_sz, pages_per_seq=pages_per_seq, k=args.k,
        prefix_cache=not args.no_prefix_cache,
        decode_token_budget=args.decode_budget or None,
        prefill_token_budget=args.prefill_budget or None,
        prefill_mode=args.prefill_mode)
    timeline = StepTimeline(spill_dir=args.telemetry_dir or None,
                            name="serve")
    mesh = dict(d_p=dp, d_s=ds, cards=cards)
    try:
        engine = ServeEngine(cfg, econf, param_dtype=dtype,
                             compute_dtype=dtype, device=device,
                             seed=args.seed, timeline=timeline, **mesh)
    except NotImplementedError as e:
        print(f"error: arch {args.arch!r} is not servable: {e}",
              file=sys.stderr)
        return 5
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    requests = [Request(req_id=i, prompt=t["prompt"],
                        max_new_tokens=t["max_new_tokens"],
                        arrival=t["arrival"]) for i, t in enumerate(trace)]
    if args.profile:
        # first launches (kernel build, cuBLAS handles) stay out of the trace
        warm = ServeEngine(cfg, econf, params=engine.params,
                           compute_dtype=dtype, device=device, **mesh)
        warm.run([Request(req_id=0, prompt=trace[0]["prompt"],
                          max_new_tokens=2)])
        del warm
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.runtime.profile import profile_summary
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            results = engine.run(requests)
        summary = profile_summary(prof, engine.stats()["wall_s"],
                                  engine.step_count)
        with open(args.profile, "w") as f:
            json.dump(summary, f, indent=1)
        print(f"[profile] {json.dumps(summary)}")
    else:
        results = engine.run(requests)
    st = engine.stats()
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"[serve] device={name} dtype={args.dtype or dtype} "
          f"mesh={st['mesh']} completed={st['completed']}/{len(trace)} "
          f"steps={st['steps']} tok/s={st['tokens_per_s']} "
          f"ttft_p95={st['ttft_s_p95']}s "
          f"prefill_fed={st['prefill_tokens_fed']} "
          f"accept={st['speculative']['acceptance_rate']} "
          f"pool_bytes_per_rank={st['pool_bytes_per_rank']} "
          f"collective_bytes_per_step={st['collective_bytes_per_step']:.0f}")
    timeline.close()
    rc, error = 0, None
    if args.verify:
        n_v = min(args.verify, len(trace))
        ok, lines = verify_against_one_shot(
            cfg, engine.params, [t["prompt"] for t in trace[:n_v]],
            [results[i].output_ids for i in range(n_v)], args.max_new,
            compute_dtype=dtype, device=device)
        for line in lines:
            print(f"[verify] {line}")
        if not ok:
            rc, error = 4, "engine ids differ from the one-shot path"
    if args.stats_json:
        st["device"] = name
        st["outputs"] = {int(r): results[r].output_ids
                         for r in sorted(results)}
        with open(args.stats_json, "w") as f:
            json.dump(st, f, indent=1)
    if error:
        print(f"error: {error}", file=sys.stderr)
        return rc
    print("serve OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
