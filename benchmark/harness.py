"""One run of one cell: set-up, the timed window, the traced stretch, the
per-layer readers and the comparison with the plain reference.

The entry (``entries/<entry>.py``) supplies a ``Session``:

* ``Session(cell, seed, device)`` builds the program's objects, loads the
  benchmark's weights, makes the traffic and warms up every shape it will
  use;
* ``call(i)`` is one unit of timed work on input batch ``i`` (cycled),
  ending when its result is on the host; ``rows`` counts the images a
  call completes;
* ``flops_per_call`` (:mod:`benchmark.flops`), ``k3_bound_ms`` (or None)
  and ``launches_per_call`` (the kernel wrappers' expected counts);
* ``check(control)`` frees the program's state and returns its readings
  against the reference by name; with ``control`` the reference itself,
  at that precision, stands in the program's place.  The readings that
  the cell's ``limits`` name are compared (:func:`compared`).
"""

from __future__ import annotations

import dataclasses
import math
import os
import statistics
import sys
import time
from typing import Dict, List, Optional

import torch

from benchmark import spec, trace as tr

# The lower precision whose reference is a cell's control, by the
# configuration's precision: fp8 below bf16; below f32 whose convolutions
# run as cuDNN leaves them (TF32 allowed), bf16.
CONTROL = {"bf16": "fp8", "f32": "bf16"}


@dataclasses.dataclass
class Check:
    """One number compared, with its limit; it passes at or under it."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


IMPORTED = time.time()


def process_start() -> float:
    """``time.time()`` at which this process started (from
    /proc/self/stat; the harness's import time where that is missing)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return IMPORTED


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Reading:
    """What the per-layer readers read (``metrics/<name>.py``'s
    ``read(name, r)``, which returns the metric or None where it finds
    nothing to read): the cell, the session, the untraced window
    (``calls`` in ``seconds``) and the traced stretch."""

    cell: spec.Cell
    session: object
    calls: int
    seconds: float
    trace: Optional[tr.Trace]


def e2e_value(name: str, session, calls: int, seconds: float,
              latencies: List[float], setup_s: float) -> float:
    """An end-to-end metric by its name's last part: ``setup_s``,
    ``..._images_per_s`` (images over the window) or ``..._p95_ms`` (95th
    percentile of the calls' latency)."""
    if name == "setup_s":
        return setup_s
    if name.endswith("_images_per_s"):
        return session.rows * calls / seconds
    if name.endswith("_p95_ms"):
        return statistics.quantiles(latencies, n=100,
                                    method="inclusive")[94] * 1e3
    raise spec.SpecError(f"no end-to-end reading named {name!r}")


def compared(cell: spec.Cell, readings: Dict[str, float]) -> List[Check]:
    """The readings that the cell's limits name, as checks; the others are
    printed and not compared."""
    unknown = set(cell.limits) - set(readings)
    if unknown:
        raise spec.SpecError(f"workload {cell.name!r} sets limits for "
                             f"{sorted(unknown)}, which its entry does not "
                             "read")
    for name, value in readings.items():
        if name not in cell.limits:
            print(f"reading {name}: {value!r} (not compared)",
                  file=sys.stderr, flush=True)
    return [Check(n, float(v), float(cell.limits[n]))
            for n, v in readings.items() if n in cell.limits]


def launch_check(session, calls: int, launches: Dict[str, int],
                 device: torch.device) -> Check:
    """The kernel wrappers' launches over ``calls`` calls against what the
    entry expects a call (none on the CPU, where they run plain)."""
    want = {k: (v * calls if device.type == "cuda" else 0)
            for k, v in session.launches_per_call.items()}
    gap = sum(abs(launches.get(k, 0) - v) for k, v in want.items())
    gap += sum(v for k, v in launches.items() if k not in want)
    print(f"kernel launches over {calls} calls: {dict(launches)}, "
          f"expected {want}", file=sys.stderr, flush=True)
    return Check("launch_gap", float(gap), 0.0)


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool,
        device: torch.device, started: float,
        control: Optional[str] = None) -> dict:
    """One run; returns the result line's object (``checks`` last)."""
    print(f"set-up to the harness (interpreter, torch): "
          f"{time.time() - started:.2f} s", file=sys.stderr, flush=True)
    from t2igan_torch.ops.kernels import LAUNCHES

    entry = spec.load_module(cell.root / "entries" / f"{cell.entry}.py",
                             f"benchmark_entry_{cell.entry}")
    session = entry.Session(cell, seed, device)
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    LAUNCHES.clear()
    setup_s = time.time() - started
    latencies: List[float] = []
    t_start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        session.call(session.first_call + i)
        latencies.append(time.perf_counter() - t0)
        i += 1
        if time.perf_counter() - t_start >= seconds:
            break
    sync(device)
    window_s = time.perf_counter() - t_start
    calls = i
    launches = dict(LAUNCHES)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    print(f"window: {calls} calls in {window_s:.3f} s, set-up "
          f"{setup_s:.3f} s; calls a second in each third of the window: "
          f"{thirds(latencies)}", file=sys.stderr, flush=True)

    metrics: Dict[str, dict] = {}
    breakdown = None
    dev: Dict[str, object] = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": cell.chips, "memory_peak_bytes": int(peak)}
    if traced:
        n = max(3, min(40, round(2.0 * calls / window_s)))
        t0 = time.perf_counter()
        t = tr.profile(session.call, session.first_call + calls, n,
                       lambda: sync(device))
        print(f"traced {n} calls, read in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
        reading = Reading(cell, session, calls, window_s, t)
        for m in cell.per_layer:
            reader = spec.load_module(spec.reader_path(cell.root, m.name),
                                      f"benchmark_metric_{m.name}")
            value = reader.read(m.name, reading)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
        dev["busy_s"] = t.busy_s
        dev["window_s"] = t.window_s
        breakdown = {"device_ops": top_families(t),
                     "idle_gaps": [[k, v] for k, v in t.idle_gaps()[:10]]}
        print(f"per-layer readings done in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    else:
        for m in cell.end_to_end:
            metrics[m.name] = {"value": e2e_value(
                m.name, session, calls, window_s, latencies, setup_s),
                "unit": m.unit}

    t0 = time.perf_counter()
    readings = session.check(control)
    print(f"reference check in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr, flush=True)
    checks = [launch_check(session, calls, launches, device)] + compared(
        cell, readings)
    correct = all(c.ok for c in checks)
    for c in checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r})"
              f"{'' if c.ok else ' FAILED'}", file=sys.stderr, flush=True)
    out = {"correct": correct, "attempted": calls, "failed": 0,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in checks}
    return out


def thirds(latencies: List[float]) -> List[float]:
    """Calls a second over each third of the calls' summed time: how far
    the rate moves inside one run, beside how far it moves between runs
    (printed only)."""
    total = sum(latencies)
    if total <= 0:
        return []
    counts, at = [0.0, 0.0, 0.0], 0.0
    for dt in latencies:
        counts[min(2, int(3 * at / total))] += 1
        at += dt
    return [round(3 * n / total, 3) for n in counts]


def top_families(t: tr.Trace) -> List[list]:
    """The device's time by kernel family over the traced stretch, in
    seconds, the 10 largest."""
    fam = t.ms_by_family()
    return [[k, v * t.calls / 1e3] for k, v in fam.most_common(10)]


FORBIDDEN = ("jax", "jaxlib", "flax", "t2igan")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
