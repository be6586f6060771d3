"""The device trace of one episode: torch.profiler with device activity
only, read from the profiler's raw events (the slow conversion into
``key_averages`` is never made).

Only the device is traced: host operator events and ``record_function``
spans (CPU activity) cost the host more time still.  Even so the traced
call runs longer than a plain one (on an H100, CUDA-graph launches take
milliseconds each under the profiler), so the call is also run once
without the profiler, and the idle share is read against that plain
length.  Device activity brings the CUDA runtime calls the host made
(``cudaGraphLaunch``, ``cudaStreamSynchronize``, ...), and those label
the idle gaps.

From the trace: the kernels by name (calls and device seconds), the device's
busy seconds (the union of every device operation's interval), the longest
device operations by name, and the longest idle gaps, each labelled by the
runtime call that covered the gap's middle ("in <call>") or, where none
did, by the calls the host made last before it and first after it
("<call> -> <call>": host code between two calls).
"""
from __future__ import annotations

import bisect
import time


def kernel_base(name):
    """A profiler kernel name without its return type, namespaces,
    template arguments and parameter list:
    "(anonymous namespace)::f(P, float*)" and "void ns::g<4>(float*)" ->
    "f" and "g"."""
    name = name.replace("(anonymous namespace)::", "")
    words = name.split("(")[0].split("<")[0].split()
    return (words[-1] if words else name).split("::")[-1]


# host events the profiler records about itself
PROFILER_OWN = ("Activity Buffer Request", "Buffer Flush")


def profile_call(fn, sync):
    """Run ``fn()`` three times: once plain, for its host-clock length
    ``plain_s``, then twice under torch.profiler (device activity), the
    first as the profiler's warm-up (dropped), the second traced.  Returns
    the trace dict of the traced call: kernels {name: [calls, seconds]},
    busy_s, window_s (its host-clock length), plain_s, device_ops,
    idle_gaps."""
    from torch.profiler import ProfilerActivity, profile, schedule
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    plain_s = time.perf_counter() - t0
    dev, host = [], []

    def ready(prof):
        for ev in prof.profiler.kineto_results.events():
            if ev.name() in PROFILER_OWN or ev.is_user_annotation():
                continue    # the profiler's own, and spans such as ProfilerStep
            kind = str(ev.device_type()).rsplit(".", 1)[-1]
            rec = (ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                   ev.name())
            (dev if kind == "CUDA" else host).append(rec)

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=ready) as prof:
        fn()
        sync()
        prof.step()
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
        prof.step()
    out = summarize(dev, host, window_s)
    out["plain_s"] = plain_s
    return out


def gap_label(host, starts, a, b):
    """What the host did in the idle gap (a, b): the shortest runtime call
    covering its middle, else the calls that ended last before the gap's
    middle and started first after it."""
    mid = (a + b) // 2
    i = bisect.bisect_right(starts, mid)
    cover = [h for h in host[:i] if h[1] >= mid]
    if cover:
        return "in " + min(cover, key=lambda h: h[1] - h[0])[2]
    before = max(host[:i], default=None, key=lambda h: h[1])
    after = host[i] if i < len(host) else None
    return (f"{before[2] if before else 'start'} -> "
            f"{after[2] if after else 'end'}")


def summarize(dev, host, window_s, top=10):
    """The trace dict of device intervals ``dev`` and host runtime calls
    ``host``, each [(start_ns, end_ns, name)]."""
    kernels = {}
    for s, e, name in dev:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (e - s) * 1e-9
    dev = sorted(dev)
    busy_ns, gaps, end = 0, [], None
    for s, e, _ in dev:
        if end is None or s > end:
            if end is not None:
                gaps.append((s - end, end, s))
            busy_ns += e - s
            end = e
        elif e > end:
            busy_ns += e - end
            end = e
    host = sorted(host)
    starts = [h[0] for h in host]
    labelled = [[gap_label(host, starts, a, b), length * 1e-9]
                for length, a, b in sorted(gaps, reverse=True)[:top]]
    ops = sorted(([n, v[1]] for n, v in kernels.items()),
                 key=lambda x: -x[1])[:top]
    return {"kernels": kernels, "busy_s": busy_ns * 1e-9,
            "window_s": window_s, "device_ops": ops, "idle_gaps": labelled}
