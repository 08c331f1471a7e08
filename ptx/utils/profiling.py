"""Observability: structured progress logs, throughput counters, and JAX
profiler hooks.

The reference's only signals are ``cout`` block logs and a dot spinner
(``/root/reference/src/test.cpp:704,718,1083-1091``).  Here:

- :class:`Meter` — rays/s, samples-completed, tiles-done counters with
  periodic structured (JSON-line) emission;
- :func:`trace` — context manager around ``jax.profiler`` for on-device
  kernel timelines;
- :func:`log` — timestamped JSON-line structured logging.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time


def log(event: str, **fields) -> None:
    rec = {"t": round(time.time(), 3), "event": event}
    rec.update(fields)
    print(json.dumps(rec), file=sys.stderr, flush=True)


class Meter:
    """Throughput meter with periodic emission."""

    def __init__(self, name: str = "render", every_s: float = 5.0):
        self.name = name
        self.every_s = every_s
        self.t0 = time.perf_counter()
        self.last_emit = self.t0
        self.rays = 0
        self.samples = 0
        self.tiles = 0

    def add(self, rays: int = 0, samples: int = 0, tiles: int = 0) -> None:
        self.rays += rays
        self.samples += samples
        self.tiles += tiles
        now = time.perf_counter()
        if now - self.last_emit >= self.every_s:
            self.emit()
            self.last_emit = now

    def emit(self) -> None:
        dt = max(time.perf_counter() - self.t0, 1e-9)
        log(self.name, rays=self.rays, rays_per_sec=round(self.rays / dt, 1),
            samples=self.samples, tiles=self.tiles, elapsed_s=round(dt, 2))


@contextlib.contextmanager
def trace(logdir: str = "/tmp/ptx-trace"):
    """Capture a JAX profiler trace (view with tensorboard / xprof)."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timed(label: str):
    t0 = time.perf_counter()
    yield
    log("timed", label=label, seconds=round(time.perf_counter() - t0, 4))
