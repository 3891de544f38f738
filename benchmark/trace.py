"""Reading the profiler's trace: device busy time as the union of the
device's operations, idle gaps labelled by the host op then running,
kernel families, and the kernels launched under a span.

``FAMILIES`` and :func:`family` are copied from
``t2igan_torch/profile_step.py`` at commit c2e05f1 (the families by a
substring of the kernel name, first match wins; K3 by launch kind), and so
is the trace's reading (``trace_kernels``: the Chrome trace of
``torch.profiler``, refused when it holds no kernel).  Unlike
``profile_step``, busy time here is the union of the intervals in which
an operation ran on the device, not the sum of their durations.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import torch

FAMILIES = (
    ("memory_read_fwd (K1)", ("memory_read_fwd",)),
    ("memory_read_bwd (K2)", ("memory_read_bwd",)),
    # K3 by launch kind: the bf16 kernels (conv_tc<mode, ...>, rgb_head_tc)
    # and the f32 ones (conv_tf32<mode, ...>, rgb_head_tf32), names
    # demangled or not.
    ("K3 conv C->2C + GLU", ("conv_tc<0", "conv_tcili0e",
                             "conv_tf32<0", "conv_tf32ili0e")),
    ("K3 conv C->C + residual", ("conv_tc<1", "conv_tcili1e",
                                 "conv_tf32<1", "conv_tf32ili1e")),
    ("K3 upsample phases + GLU", ("conv_tc<2", "conv_tcili2e",
                                  "conv_tf32<2", "conv_tf32ili2e")),
    ("K3 RGB head", ("rgb_head_tc", "rgb_head_tf32")),
    ("nearest upsample", ("upsample",)),
    ("batch norm", ("batch_norm", "bn_fw", "bn_bw")),
    ("layer norm", ("layer_norm",)),
    ("convolution", ("fprop", "dgrad", "wgrad", "conv", "cudnn")),
    ("matmul (CLIP, dense)", ("gemm", "cutlass", "cublas", "nvjet")),
    ("optimizer (foreach)", ("multi_tensor", "foreach")),
    ("softmax", ("softmax",)),
    ("reduction", ("reduce",)),
    ("concatenation", ("catarray",)),
    ("GLU", ("glu",)),
    ("elementwise (gates, residuals, casts, BN stats)", ("elementwise",)),
)

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL_SPAN = "bench.call"


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged (start, end) intervals, sorted."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclasses.dataclass
class Trace:
    """One traced stretch of ``calls`` calls, times in microseconds."""

    calls: int
    window: Tuple[float, float]
    device_ops: List[dict]      # kernels, copies and sets on the device
    host_ops: List[dict]        # the host's ops and the benchmark's spans
    launch_ts: Dict[int, float]  # correlation id -> host launch time

    @property
    def kernels(self) -> List[dict]:
        return [e for e in self.device_ops if e.get("cat") == "kernel"]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        return union([(max(lo, e["ts"]), min(hi, e["ts"] + e["dur"]))
                      for e in self.device_ops
                      if e["ts"] < hi and e["ts"] + e["dur"] > lo])

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def spans(self, name: str) -> List[Tuple[float, float]]:
        return [(e["ts"], e["ts"] + e["dur"]) for e in self.host_ops
                if e["name"] == name]

    def kernels_under(self, span: str) -> List[dict]:
        """Kernels whose launch lies inside a host span named ``span``."""
        spans = sorted(self.spans(span))
        starts = [s for s, _ in spans]
        out = []
        for k in self.kernels:
            t = self.launch_ts.get(k.get("args", {}).get("correlation"))
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                out.append(k)
        return out

    def ms_by_family(self, kernels: Optional[List[dict]] = None
                     ) -> collections.Counter:
        """Device ms a call by :func:`family`."""
        out: collections.Counter = collections.Counter()
        for e in self.kernels if kernels is None else kernels:
            out[family(e["name"])] += e["dur"] / 1e3 / self.calls
        return out

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Seconds of device idle in the window by the innermost host op
        running at each gap's start (the latest-started one over the
        host's threads; "no host op" where none runs), longest first."""
        lo, hi = self.window
        gaps, at = [], lo
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if hi > at:
            gaps.append((at, hi))
        threads: Dict[object, List[dict]] = collections.defaultdict(list)
        for op in self.host_ops:
            threads[op.get("tid")].append(op)
        for ops in threads.values():
            ops.sort(key=lambda e: (e["ts"], -e["dur"]))
        stacks = {t: [] for t in threads}
        nxt = dict.fromkeys(threads, 0)
        by_label: collections.Counter = collections.Counter()
        for s, e in gaps:  # in time order
            best = None
            for t, ops in threads.items():
                stack, i = stacks[t], nxt[t]
                while i < len(ops) and ops[i]["ts"] <= s:
                    while stack and _end(stack[-1]) <= ops[i]["ts"]:
                        stack.pop()
                    stack.append(ops[i])
                    i += 1
                nxt[t] = i
                while stack and _end(stack[-1]) <= s:
                    stack.pop()
                if stack and (best is None or stack[-1]["ts"] > best["ts"]):
                    best = stack[-1]
            by_label["no host op" if best is None else best["name"]] += \
                (e - s) / 1e6
        return by_label.most_common()


def _end(op: dict) -> float:
    return op["ts"] + op["dur"]


def profile(call: Callable[[int], None], first: int, calls: int,
            sync: Callable[[], None]) -> Trace:
    """``calls`` calls of ``call`` (indices from ``first``) under
    torch.profiler, each inside a ``bench.call`` span ending in ``sync``;
    the window runs from the first span's start to the last one's end.
    Raises where the trace holds no kernel: the profiler did not trace
    the card."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(first, first + calls):
            with torch.profiler.record_function(CALL_SPAN):
                call(i)
                sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    events = [e for e in events if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not any(e.get("cat") == "kernel" for e in device):
        raise RuntimeError("the trace holds no CUDA kernel: the profiler "
                           "did not trace the card")
    host = [e for e in events if e.get("cat") in ("cpu_op",
                                                  "user_annotation")]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})}
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in host
             if e["name"] == CALL_SPAN]
    window = (min(s for s, _ in spans), max(e for _, e in spans))
    return Trace(calls=calls, window=window, device_ops=device,
                 host_ops=host, launch_ts=launch)
