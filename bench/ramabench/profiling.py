"""Device time from a ``torch.profiler`` trace, and host syncs.

:func:`reduce_trace` reads the raw events of one profiled window. The
arithmetic is a copy of the port's chip smoke (``profile_call``): the
device is busy while a kernel, copy or set runs on it, and a phase's
busy time is the device time of what was launched inside its range
(``device_busy_ms``), not the range's span on the device, which also
covers idle gaps. Here the busy time is the union of the device events'
intervals (one stream: their sum), a launch is tied to its range by the
host time of its CUDA runtime call, and the window is the harness's own
``bench.window`` range.

:func:`count_syncs` is the chip smoke's ``count_syncs``: synchronising
CUDA calls during ``fn``, as torch's sync debug mode reports them.
"""
from __future__ import annotations

import warnings
from collections import defaultdict

import numpy as np

WINDOW = "bench.window"
RANGE_PREFIXES = ("repro.", "bench.")
TOP = 10
NAME_CHARS = 200


def short_name(name: str) -> str:
    """A kernel's name without ``void `` and namespaces of ``at::native``,
    at most 200 characters: the template arguments that tell two
    instantiations apart sit at its end."""
    name = name.removeprefix("void ").replace("at::native::", "")
    return name.replace("(anonymous namespace)::", "")[:NAME_CHARS]


def count_syncs(fn) -> int:
    import torch
    n = [0]

    def note(message, *_):
        if "synchroniz" in str(message):
            n[0] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return n[0]


def _merge(iv: np.ndarray) -> np.ndarray:
    """Union of [start, end) intervals, sorted, as disjoint rows."""
    if not len(iv):
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.r_[np.nonzero(new)[0][1:] - 1, len(iv) - 1]
    return np.stack([starts, ends[last]], axis=1)


def _innermost(ranges: dict, t: np.ndarray, names) -> np.ndarray:
    """For each time in ``t``, the index into ``names`` of the range with
    the latest start that contains it, or -1. Ranges of one name never
    overlap one another."""
    best = np.full(len(t), -1, dtype=np.int64)
    best_start = np.full(len(t), -np.inf)
    for k, name in enumerate(names):
        iv = ranges[name]
        i = np.searchsorted(iv[:, 0], t, side="right") - 1
        ok = i >= 0
        inside = np.zeros(len(t), dtype=bool)
        inside[ok] = t[ok] < iv[i[ok], 1]
        s = np.where(inside, iv[np.clip(i, 0, None), 0], -np.inf)
        take = inside & (s > best_start)
        best[take] = k
        best_start[take] = s[take]
    return best


def reduce_events(device, cpu_ranges, launches) -> dict:
    """The reduction proper, on plain data (the tests feed it by hand).

    ``device``: (start_ns, end_ns, name, correlation) of each device
    kernel, copy or set; ``cpu_ranges``: name -> list of (start_ns,
    end_ns) of the ``repro.*`` and ``bench.*`` ranges on the host;
    ``launches``: correlation -> host ns of the runtime call that
    launched it. Times are clipped to the one ``bench.window`` range."""
    (w0, w1), = cpu_ranges[WINDOW]
    ranges = {k: np.asarray(sorted(v), dtype=np.float64).reshape(-1, 2)
              for k, v in cpu_ranges.items()}
    names = sorted(k for k in ranges if k != WINDOW)
    dev = [d for d in device if d[1] > w0 and d[0] < w1]
    iv = np.array([[max(d[0], w0), min(d[1], w1)] for d in dev],
                  dtype=np.float64).reshape(-1, 2)
    dur = iv[:, 1] - iv[:, 0]
    busy = _merge(iv)
    busy_ns = float((busy[:, 1] - busy[:, 0]).sum())

    by_name = defaultdict(lambda: [0, 0.0])
    for d, t in zip(dev, dur):
        by_name[d[2]][0] += 1
        by_name[d[2]][1] += t
    launch_t = np.array([launches.get(d[3], np.nan) for d in dev],
                        dtype=np.float64)
    matched = ~np.isnan(launch_t)
    owner = np.full(len(dev), -1, dtype=np.int64)
    owner[matched] = _innermost(ranges, launch_t[matched], names)
    phase = {}
    for k, name in enumerate(names):
        iv_k = ranges[name]
        inside = (iv_k[:, 1] > w0) & (iv_k[:, 0] < w1)
        host = np.minimum(iv_k[inside, 1], w1) - np.maximum(iv_k[inside, 0],
                                                             w0)
        phase[name] = dict(host_s=float(host.sum()) / 1e9,
                           count=int(inside.sum()),
                           busy_s=float(dur[owner == k].sum()) / 1e9)

    edges = np.r_[w0, busy.reshape(-1), w1].reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    label = _innermost(ranges, gaps[:, 0], names) if len(gaps) else \
        np.zeros(0, dtype=np.int64)
    idle = defaultdict(float)
    for (g0, g1), k in zip(gaps, label):
        idle[names[k] if k >= 0 else "host outside the ranges"] += \
            (g1 - g0) / 1e9
    top = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)
    return dict(
        window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9,
        device_events=len(dev), unmatched_launches=int((~matched).sum()),
        phases=phase,
        kernels={k: dict(count=c, s=t / 1e9) for k, (c, t) in
                 by_name.items()},
        device_ops=[[short_name(k), t / 1e9] for k, (_, t) in top[:TOP]],
        idle_gaps=sorted(([k, s] for k, s in idle.items()),
                         key=lambda kv: kv[1], reverse=True)[:TOP])


def reduce_trace(prof) -> dict:
    """:func:`reduce_events` of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    device, launches = [], {}
    cpu_ranges = defaultdict(list)
    cuda = DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            if name.startswith(RANGE_PREFIXES):
                continue        # a range's projection onto the device
            start = e.start_ns()
            device.append((start, start + e.duration_ns(), name,
                           e.correlation_id()))
        elif name.startswith(RANGE_PREFIXES):
            start = e.start_ns()
            cpu_ranges[name].append((start, start + e.duration_ns()))
        elif name.startswith("cu"):     # a CUDA runtime or driver call
            launches[e.correlation_id()] = e.start_ns()
    return reduce_events(device, cpu_ranges, launches)
