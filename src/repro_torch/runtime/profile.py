"""Summary of a finished ``torch.profiler`` run, shared by the serving
and training launchers: device time by kernel and by kernel group, kernel
launches and the device's busy share of the wall time; and what is live
at the peak of a recorded allocation history
(``torch.cuda.memory._record_memory_history``)."""

from __future__ import annotations

__all__ = ["profile_summary", "memory_peak_summary"]


def profile_summary(prof, wall_s: float, steps: int) -> dict:
    """Device time by kernel and kernel group per step (an engine step or
    a training step), kernel launches per step, the host's busiest
    operators and the device's busy share of ``wall_s``, from a finished
    ``torch.profiler`` run."""
    from torch.autograd import DeviceType
    kernels, host, launches = {}, {}, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total
        else:
            host[e.key] = e.self_cpu_time_total
            if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                         "cuLaunchKernel", "cuLaunchKernelEx"):
                launches += e.count
    total_us = sum(kernels.values())
    if total_us == 0:
        return {"device_time": "not measured (no device events)"}

    def group(name):
        n = name.lower()
        if "flash_fwd" in n or "flash_combine" in n or "flash_bwd" in n:
            return "attention kernels"
        if "ce_fwd" in n or "ce_bwd" in n:
            return "cross-entropy kernels"
        if "mamba_scan" in n:
            return "mamba scan kernels"
        if any(s in n for s in ("gemm", "xmma", "cutlass", "cublas",
                                "nvjet")):
            return "matmul"
        if "copy" in n or "index" in n or "cat" in n or "gather" in n:
            return "copy/index/cat"
        return "other"
    groups = {}
    for name, us in kernels.items():
        groups[group(name)] = groups.get(group(name), 0.0) + us
    steps = max(steps, 1)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    top_host = sorted(host.items(), key=lambda kv: -kv[1])[:6]
    return {"steps": steps, "wall_s": wall_s,
            "device_ms": total_us / 1e3, "busy_share": total_us / 1e6 / wall_s,
            "device_ms_per_step": total_us / 1e3 / steps,
            "wall_ms_per_step": wall_s * 1e3 / steps,
            "kernel_launches_per_step": launches / steps,
            "groups_ms_per_step": {g: us / 1e3 / steps for g, us in sorted(
                groups.items(), key=lambda kv: -kv[1])},
            "top_kernels_ms_per_step": [(n[:60], us / 1e3 / steps)
                                        for n, us in top],
            "top_host_ops_ms": [(n[:60], us / 1e3) for n, us in top_host]}


def _site(frames) -> str:
    """The innermost frame of the port (else of any Python file) of an
    allocation's stack: ``file:line name``."""
    frames = frames or []
    own = [f for f in frames if "repro_torch" in f.get("filename", "")]
    f = (own or [f for f in frames if f.get("filename", "").endswith(".py")]
         or [None])[0]
    if f is None:
        return "no Python frame (autograd engine or C++)"
    name = f["filename"].split("repro_torch/")[-1]
    return f"{name}:{f['line']} {f['name']}"


def memory_peak_summary(snapshot: dict, baseline_bytes: int,
                        top: int = 30) -> dict:
    """What is allocated at the peak of a recorded allocation history.

    ``snapshot``: ``torch.cuda.memory._snapshot()`` taken after the
    recorded window; ``baseline_bytes``: ``torch.cuda.memory_allocated()``
    when recording started (blocks allocated before it have no event).
    Replays the device's trace (``alloc`` adds a block, ``free_completed``
    removes it, as the allocator's own count does) and returns the peak
    (GB), the baseline, and the blocks live at the peak that were
    allocated in the window, grouped by their allocation site (the
    innermost frame of the port) and by size, largest first."""
    trace = [e for dev in snapshot.get("device_traces", []) for e in dev]
    live, cur, peak, at_peak = {}, baseline_bytes, baseline_bytes, {}
    for e in trace:
        act, addr, size = e.get("action"), e.get("addr"), e.get("size", 0)
        if act == "alloc":
            live[addr] = (size, _site(e.get("frames")))
            cur += size
            if cur > peak:
                peak, at_peak = cur, dict(live)
        elif act == "free_completed":
            if addr in live:
                cur -= live.pop(addr)[0]
            else:                       # allocated before the window
                cur -= size
    groups = {}
    for size, site in at_peak.values():
        key = (site, size)
        n, total = groups.get(key, (0, 0))
        groups[key] = (n + 1, total + size)
    rows = sorted(groups.items(), key=lambda kv: -kv[1][1])[:top]
    return {"peak_gb": peak / 1e9, "baseline_gb": baseline_bytes / 1e9,
            "window_live_at_peak_gb": sum(s for s, _ in at_peak.values())
            / 1e9,
            "events": len(trace),
            "live_at_peak": [{"site": site, "block_mb": size / 1e6,
                              "count": n, "total_gb": total / 1e9}
                             for (site, size), (n, total) in rows]}
