"""Structured metrics logging (port of :mod:`t2igan.utils.logging`).

:class:`MetricsLogger` appends one JSON row a logged step to
``<log_dir>/metrics.jsonl`` with the JAX package's keys (``step``,
``time``, ``prefix``, each metric as a float, and ``sec_per_step`` from the
second row on) and prints a console line every ``print_every`` steps.

A step's metrics may be 0-dim tensors on the card.  ``log`` keeps them as
they are, with the step's host time, and converts the rows held so far in
one ``torch.stack(...).tolist()`` when a console line is due, when
``print_every`` rows are held, and at :meth:`flush` (an epoch's end, a
stop, :meth:`close`): logging adds no card synchronisation to the other
steps.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Tuple

import torch


class MetricsLogger:
    def __init__(self, log_dir: str, print_every: int = 50,
                 console: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a", buffering=1)
        self.print_every = print_every
        self.console = console
        self._last_time: Optional[float] = None
        self._last_step: Optional[int] = None
        # (record with the host values, [(key, tensor)]) of unwritten rows.
        self._held: List[Tuple[Dict, List[Tuple[str, torch.Tensor]]]] = []

    def log(self, step: int, metrics: Dict, prefix: str = "train") -> None:
        """Hold one row: ``metrics``' 0-dim tensors as they are, other
        values as floats (a value that is neither is left out, as the JAX
        logger leaves it out)."""
        now = time.time()
        record: Dict = {"step": int(step), "time": now, "prefix": prefix}
        tensors = []
        for k, v in metrics.items():
            if isinstance(v, torch.Tensor):
                if v.numel() == 1:
                    record[k] = None  # keeps the key's place in the row
                    tensors.append((k, v.detach().reshape(())))
                continue
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                continue
        if self._last_time is not None and step != self._last_step:
            record["sec_per_step"] = ((now - self._last_time) /
                                      max(1, step - (self._last_step or 0)))
        self._held.append((record, tensors))
        self._last_time, self._last_step = now, step
        due = self.console and step % self.print_every == 0
        if due or len(self._held) >= self.print_every:
            self.flush()
        if due:
            parts = " ".join(f"{k}: {record[k]:.4f}" for k in record
                             if isinstance(record[k], float)
                             and k != "time")
            print(f"[{prefix} step {step}] {parts}", flush=True)

    def flush(self) -> None:
        """Convert the held rows (one device-to-host copy) and write
        them."""
        if not self._held:
            return
        tensors = [t for _, ts in self._held for _, t in ts]
        values = iter(torch.stack([t.float() for t in tensors]).tolist()
                      if tensors else [])
        for record, ts in self._held:
            for k, _ in ts:
                record[k] = next(values)
            self._f.write(json.dumps(record) + "\n")
        self._held.clear()

    def close(self) -> None:
        self.flush()
        self._f.close()


class StepTimer:
    """Rolling images/s and ms/step over the host times of the last
    ``window`` steps."""

    def __init__(self, batch_size: int, window: int = 20):
        self.batch_size = batch_size
        self.window = window
        self.times: List[float] = []

    def tick(self) -> None:
        self.times.append(time.time())
        if len(self.times) > self.window + 1:
            self.times.pop(0)

    @property
    def ms_per_step(self) -> float:
        if len(self.times) < 2:
            return float("nan")
        return 1000.0 * (self.times[-1] - self.times[0]) / (len(self.times)
                                                            - 1)

    @property
    def images_per_sec(self) -> float:
        ms = self.ms_per_step
        return (self.batch_size / (ms / 1000.0) if ms == ms and ms > 0
                else float("nan"))
