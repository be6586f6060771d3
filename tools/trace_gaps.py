"""Where the device idles in one cell of the benchmark, told by the
program's own spans (``safeincave_torch.tracing``).

    python3 tools/trace_gaps.py --workload <cell> [--seed N] [--episodes K]
                                [--out DIR] [--onoff P]

Sets the cell up as ``benchmark/run.py`` does (``benchmark/episodes.py``:
build, warm stages, saved state, one episode outside the window), then:

1. ``K`` plain episodes, each printed with its host seconds and its run
   record's gap total (by cause), replay and read totals;
2. the clock check: twenty small kernels under torch.profiler, each
   launched right after a ``perf_counter_ns`` stamp; the profiler's start
   of each, less the stamp shifted by the tracer's offset (and unshifted),
   says which host clock the profiler's device timestamps follow;
3. one episode under torch.profiler (device activity only, after one
   warm-up episode): every device idle gap longer than 1 ms, the share of
   it that the program's ``gap`` and ``replay`` spans cover after the
   offset conversion, and the ten longest with the span that covers most
   of each and the innermost span the host was in at its middle; and all of the episode's idle time split into what program
   gaps cover, what replays cover beyond them, and the rest, the rest by
   the innermost program span the host was in.

``--onoff P`` instead runs ``P`` pairs of episodes after the set-up, one
with tracing off (``tracing.enable(False)``) and one on in each, the order
swapped from pair to pair, and prints each side's host seconds: the
tracer's cost within one process.

``DIR`` (default ``trace_out/<cell>`` in the checkout) receives
``spans.json`` (``tracing.write_chrome`` of the profiled episode) and
``device.json`` (its device-busy intervals on the same clock, merged
across idle stretches under 20 us), to open together in Perfetto, and
``summary.json``.  Needs a CUDA device.
"""
import argparse
import bisect
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
sys.path[:0] = [BENCH, ROOT]

import torch  # noqa: E402

from safeincave_torch import tracing  # noqa: E402
from safeincave_torch.tracing import GAP, NAMES, REPLAY  # noqa: E402

GAP_MS = 1.0                   # device idle gaps longer than this count
MERGE_NS = 20_000              # device.json merges busy intervals closer


def episode_row(ep, rec):
    """One episode's host seconds and its run record's totals (ms)."""
    ms = lambda ns: round(1e-6 * ns, 3)  # noqa: E731
    spans = rec["spans"]
    return {"seconds": round(ep["seconds"], 4), "steps": rec["steps"],
            "gap_ms": ms(sum(rec["gaps"].values())),
            "gaps_ms": {k: ms(v) for k, v in sorted(
                rec["gaps"].items(), key=lambda kv: -kv[1])},
            "replay_ms": ms(spans.get("replay", {}).get("total_ns", 0)),
            "replays": spans.get("replay", {}).get("count", 0),
            "read_ms": ms(spans.get("read", {}).get("total_ns", 0)),
            "reads": spans.get("read", {}).get("count", 0),
            "captures": rec["counters"].get("captures", 0)}


def device_events(prof):
    """[(start_ns, end_ns, name)] of the profiler's device activity."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if str(ev.device_type()).rsplit(".", 1)[-1] == "CUDA":
            out.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                        ev.name()))
    return sorted(out)


def clock_check():
    """Median of (profiler start of a kernel) - (host stamp + offset), and
    the same without the offset, over twenty launches, in microseconds."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    stamps = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter_ns())
            x.fill_(1.0)
        torch.cuda.synchronize()
    starts = [s for s, _, n in device_events(prof) if "fill" in n.lower()]
    if len(starts) != len(stamps):
        return {"kernels": len(starts), "stamps": len(stamps)}
    off = tracing.TRACER.offset_ns
    return {"kernels": len(starts),
            "with_offset_us": statistics.median(
                (k - s - off) / 1e3 for k, s in zip(starts, stamps)),
            "without_offset_us": statistics.median(
                (k - s) / 1e3 for k, s in zip(starts, stamps))}


def busy_intervals(dev, slack=0):
    merged = []
    for s, e, _ in dev:
        if merged and s <= merged[-1][1] + slack:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def innermost(ring, off):
    """``at(t)``: the innermost program span (name) open at profiler time
    ``t``, from the ring's spans other than gaps."""
    spans = sorted(((s + off, e + off, NAMES[n]) for n, s, e, _, _ in ring
                    if n != GAP), key=lambda x: (x[0], -x[1]))
    starts = [x[0] for x in spans]

    def at(t):
        # spans nest: the latest-starting span that holds t is innermost
        for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            if spans[i][1] >= t:
                return spans[i][2]
        return "none"
    return at


def idle_split(busy, ring, t0, t1):
    """The episode's device idle (ms) covered by program gaps, by replays
    beyond them, and neither; the last by the innermost program span at
    each idle stretch's middle."""
    off = tracing.TRACER.offset_ns
    kinds = {n: sorted((s + off, e + off) for k, s, e, _, _ in ring
                       if k == n) for n in (GAP, REPLAY)}

    def cover(a, b, ivs):
        i = max(bisect.bisect_right(ivs, (a, a)) - 2, 0)
        got = []
        while i < len(ivs) and ivs[i][0] < b:
            lo, hi = max(ivs[i][0], a), min(ivs[i][1], b)
            if hi > lo:
                got.append((lo, hi))
            i += 1
        return got

    at = innermost(ring, off)
    split = {"gap": 0.0, "replay": 0.0, "neither": 0.0}
    rest = {}
    for (_, a), (b, _) in zip(busy, busy[1:]):
        if a < t0 or b > t1:
            continue
        in_gap = cover(a, b, kinds[GAP])
        g = sum(hi - lo for lo, hi in in_gap)
        # replay cover outside the gap cover
        r = 0
        for lo, hi in cover(a, b, kinds[REPLAY]):
            r += (hi - lo) - sum(max(0, min(hi, gh) - max(lo, gl))
                                 for gl, gh in in_gap)
        n = (b - a) - g - r
        split["gap"] += g / 1e6
        split["replay"] += r / 1e6
        split["neither"] += n / 1e6
        if n > 0:
            name = at((a + b) // 2)
            rest[name] = rest.get(name, 0.0) + n / 1e6
    split["neither_by_span"] = dict(sorted(rest.items(),
                                           key=lambda kv: -kv[1]))
    return split


def covered(a, b, spans, starts):
    """The length of [a, b] that the union of ``spans`` (sorted by start)
    covers, and the span covering most of it."""
    # a gap's last piece overlaps the replay that ends it: start two
    # spans back
    i = max(bisect.bisect_right(starts, a) - 3, 0)
    got, cur, best = 0, a, (0, None)
    while i < len(spans) and spans[i][0] < b:
        s, e, label = spans[i]
        lo, hi = max(s, cur), min(e, b)
        if hi > lo:
            got += hi - lo
            cur = hi
        over = min(e, b) - max(s, a)
        if over > best[0]:
            best = (over, label)
        i += 1
    return got, best[1]


def coverage(dev, ring, t0, t1):
    """Device idle gaps over GAP_MS in the episode [t0, t1] (profiler
    clock), each with the share the program's gap and replay spans cover."""
    busy = [iv for iv in busy_intervals(dev) if iv[1] >= t0 and iv[0] <= t1]
    off = tracing.TRACER.offset_ns
    spans = sorted((s + off, e + off,
                    f"gap ({NAMES[rel] if rel < len(NAMES) else 'none'}, "
                    f"step {step})" if n == GAP else f"replay (step {step})")
                   for n, s, e, rel, step in ring if n in (GAP, REPLAY))
    starts = [s for s, _, _ in spans]
    at = innermost(ring, off)
    gaps = []
    for (_, a), (b, _) in zip(busy, busy[1:]):
        if (b - a) / 1e6 > GAP_MS:
            got, label = covered(a, b, spans, starts)
            gaps.append({"ms": (b - a) / 1e6, "covered": got / (b - a),
                         "by": label, "host_in": at((a + b) // 2),
                         "at_ms": (a - t0) / 1e6})
    idle = sum(b - a for (_, a), (b, _) in zip(busy, busy[1:]))
    return gaps, idle / 1e6, busy


def on_off(c, rec, pairs, out):
    """Host seconds of ``pairs`` pairs of episodes, tracing off and on in
    turns; printed to ``out`` as one JSON line."""
    secs = {"off": [], "on": []}
    for i in range(pairs):
        for mode in (("off", "on") if i % 2 == 0 else ("on", "off")):
            tracing.enable(mode == "on")
            secs[mode].append(c.episode(rec)["seconds"])
    tracing.enable(True)
    med = {k: statistics.median(v) for k, v in secs.items()}
    print(json.dumps({"card": torch.cuda.get_device_name(0), **secs,
                      "median": med,
                      "cost": med["on"] / med["off"] - 1.0,
                      "pairs_on_slower": sum(a > b for a, b in zip(
                          secs["on"], secs["off"]))}), file=out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1510000001)
    ap.add_argument("--episodes", type=int, default=8)
    ap.add_argument("--out", default=None)
    ap.add_argument("--onoff", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("trace_gaps: needs a CUDA device")
    import episodes
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = next(w for w in json.load(f)["workloads"]
                    if w["name"] == args.workload)
    out_dir = args.out or os.path.join(ROOT, "trace_out", args.workload)
    os.makedirs(out_dir, exist_ok=True)
    work = tempfile.mkdtemp(prefix="trace_gaps_")
    c = episodes.Cell(cell, args.seed, "cuda", ROOT, work)
    with open(os.devnull, "w") as quiet, episodes.Recorder(c.sync) as rec:
        keep, sys.stdout = sys.stdout, quiet
        try:
            c.setup()
            c.episode(rec)
            if args.onoff:
                return on_off(c, rec, args.onoff, keep)
            rows = [episode_row(c.episode(rec), tracing.runs[-1])
                    for _ in range(args.episodes)]
            check = clock_check()
            from torch.profiler import ProfilerActivity, profile, schedule
            plain = c.episode(rec)
            with profile(activities=[ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1,
                                           repeat=1)) as prof:
                c.episode(rec)
                c.sync()
                prof.step()
                traced = c.episode(rec)
                c.sync()
                prof.step()
        finally:
            sys.stdout = keep
    rec_t = tracing.runs[-1]
    off = tracing.TRACER.offset_ns
    t0, t1 = rec_t["start_ns"] + off, rec_t["end_ns"] + off
    ring = [s for s in tracing.TRACER.spans() if s[1] >= rec_t["start_ns"]]
    dev = device_events(prof)
    gaps, idle_ms, busy = coverage(dev, ring, t0, t1)
    top = sorted(gaps, key=lambda g: -g["ms"])[:10]
    split = idle_split(busy, ring, t0, t1)
    tracing.write_chrome(os.path.join(out_dir, "spans.json"),
                         since_ns=rec_t["start_ns"])
    pid = os.getpid()
    with open(os.path.join(out_dir, "device.json"), "w") as f:
        json.dump({"traceEvents": [
            {"ph": "X", "pid": pid, "tid": 3, "name": "device busy",
             "ts": s / 1e3, "dur": (e - s) / 1e3}
            for s, e in busy_intervals(dev, MERGE_NS)
            if e >= t0 and s <= t1]}, f)
    summary = {
        "workload": args.workload, "seed": args.seed,
        "card": torch.cuda.get_device_name(0), "clock": check,
        "episodes": rows, "plain_s": plain["seconds"],
        "profiled": {"seconds": traced["seconds"],
                     "record": episode_row(traced, rec_t),
                     "device_idle_ms": idle_ms,
                     "idle_split_ms": split,
                     "gaps_over_1ms": len(gaps),
                     "covered_90": sum(g["covered"] >= 0.9 for g in gaps),
                     "least_covered": min((g["covered"] for g in gaps),
                                          default=None),
                     "longest": top}}
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
