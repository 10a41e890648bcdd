"""Summary of a finished ``torch.profiler`` run, shared by the serving
and training launchers: device time by kernel and by kernel group, kernel
launches and the device's busy share of the wall time."""

from __future__ import annotations

__all__ = ["profile_summary"]


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
