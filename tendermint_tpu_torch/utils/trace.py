"""Tracing/profiling hooks: thread-stack dumps + device traces.

The reference exposes pprof-style debug endpoints (`rpc/core` net/http
pprof wiring); the analogs here are:

  * `thread_stacks()` — every live thread's Python stack (the goroutine
    dump analog; invaluable for gossip/consensus deadlock triage),
  * `start_device_trace` / `stop_device_trace` — a `torch.profiler`
    capture of the card's activity (kernels and copies, CUDA activity
    through CUPTI) beside the host's, exported as Chrome trace-event
    JSON (`DEVICE_TRACE_FILE` in the directory given) for Perfetto or
    chrome://tracing.

Both are served by the `debug_*` RPC routes (`rpc/routes.py`).

Copy of `tendermint_tpu/utils/trace.py` with `torch.profiler` in place
of `jax.profiler`.  A profiler belongs to the thread that starts it,
while the RPC server answers each request on a thread of its own, so the
capture runs on a thread this module owns: `start_device_trace` starts
it and `stop_device_trace` ends it and waits for the export, from
whichever threads call them.  The card's activity of every thread of the
process is in the trace (CUPTI sees the whole process); the host's
operator events are those of the capture's thread.  One capture runs at
a time: `start_device_trace` returns False while this module's capture
runs or the calling thread is under a `torch.profiler` capture of its
own; a capture that another thread holds makes the profiler fail, and
that error is raised, not swallowed.
"""

from __future__ import annotations

import os
import sys
import threading
import traceback

import torch

from tendermint_tpu_torch.utils.log import get_logger

log = get_logger("trace")

DEVICE_TRACE_FILE = "device.pt.trace.json"

_trace_lock = threading.Lock()
_capture: "_Capture | None" = None


def thread_stacks() -> dict[str, list[str]]:
    """Name -> formatted stack for every live Python thread."""
    frames = sys._current_frames()
    out = {}
    for t in threading.enumerate():
        f = frames.get(t.ident)
        name = f"{t.name}{'(daemon)' if t.daemon else ''}"
        out[name] = traceback.format_stack(f) if f is not None else []
    return out


class _Capture:
    """One `torch.profiler` capture on its own thread, from `start` until
    `stop`, exported into `trace_dir`."""

    def __init__(self, trace_dir: str):
        self.trace_dir = trace_dir
        self.path = os.path.join(trace_dir, DEVICE_TRACE_FILE)
        self.error: BaseException | None = None
        self._running = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="device-trace")

    def _run(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        try:
            with profile(activities=acts) as prof:
                self._running.set()
                self._stop.wait()
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
            os.makedirs(self.trace_dir, exist_ok=True)
            prof.export_chrome_trace(self.path)
        except BaseException as e:      # handed to the caller, re-raised
            self.error = e
        finally:
            self._running.set()

    def start(self) -> None:
        self._thread.start()
        self._running.wait()
        if self.error is not None:
            raise self.error

    def stop(self) -> str:
        self._stop.set()
        self._thread.join()
        if self.error is not None:
            raise self.error
        return self.path


def start_device_trace(trace_dir: str) -> bool:
    """Begin a device capture; False if one is already running (this
    module's, or a `torch.profiler` capture of the calling thread)."""
    global _capture
    with _trace_lock:
        if _capture is not None or torch.autograd._profiler_enabled():
            return False
        cap = _Capture(trace_dir)
        cap.start()
        _capture = cap
        log.info("device trace started", dir=trace_dir)
        return True


def stop_device_trace() -> str | None:
    """Stop the capture and export it; returns the trace dir (None if
    none running).  The trace is `DEVICE_TRACE_FILE` in it."""
    global _capture
    with _trace_lock:
        if _capture is None:
            return None
        cap, _capture = _capture, None
        cap.stop()
        log.info("device trace stopped", dir=cap.trace_dir)
        return cap.trace_dir
