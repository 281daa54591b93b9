"""Span tracer: structured events on the monotonic clock (port of
``repro.obs.trace``).

Events are recorded directly in Chrome ``trace_event`` form so the JSONL
dump and the ``{"traceEvents": [...]}`` export are the same dicts:

* ``ph="X"`` complete spans from :meth:`Tracer.span` (a context
  manager): ``ts``/``dur`` in microseconds of ``time.monotonic_ns``,
  real ``pid``/``tid``, nesting ``depth``, free-form ``args``;
* ``ph="b"``/``ph="e"`` async spans from :meth:`Tracer.begin_async` /
  :meth:`Tracer.end_async`, keyed by ``(cat, id, name)`` -- request
  lifecycles that overlap arbitrarily across loop iterations;
* ``ph="i"`` instants from :meth:`Tracer.instant`.

The clock and the event schema are the reference's, so either
package's :func:`validate_trace` accepts the other's JSONL.

Open sync spans live on a module-level *thread-local* stack shared by
every tracer, which is what lets :func:`attribute_energy` (called by
``repro_torch.power.EnergyMeter`` on exit) add a reading's joules to the
innermost enclosing span without the meter ever holding a tracer
reference -- the trace answers "which phase burned the joules".

Spans read the host clock only and never synchronise the device: a
span around asynchronous CUDA work measures the host's enqueue time
unless the work inside it ends in a copy to the host (the serving
loop's decode step does; its prefill chunk does not).  Where a caller
wants the device's side of a span it records a pair of CUDA events
around the work and writes their elapsed time into the span's args
(the serving loop's ``device_ms``), reading it only after a
synchronisation it makes anyway.

:meth:`Tracer.wall_offset_ns` is the offset from the tracer's clock to
``time.time_ns``, the clock ``torch.profiler`` stamps the device's
events with; :meth:`Tracer.to_chrome` records it under ``otherData``
(the Chrome format's metadata), so a span trace lines up with a
profiler trace of the same run.

A disabled tracer's ``span()`` returns a shared no-op context manager
and records nothing.

CLI (JSONL -> Chrome trace JSON, schema-validated)::

    python -m repro_torch.obs.trace serve-trace.jsonl -o trace.json --validate

Load the output in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any

__all__ = ["Tracer", "trace_span", "default_tracer", "set_default_tracer",
           "attribute_energy", "validate_trace", "load_events"]

# thread-local stack of open sync-span records (mutable event dicts):
# shared across tracers so cross-module helpers (EnergyMeter) can reach
# the innermost open span of *this thread* without plumbing a tracer
_OPEN = threading.local()


def _open_stack() -> list[dict]:
    st = getattr(_OPEN, "stack", None)
    if st is None:
        st = _OPEN.stack = []
    return st


def attribute_energy(joules: float, seconds: float = 0.0) -> bool:
    """Attach a metered energy reading to the innermost open span of the
    calling thread (accumulating: several meters inside one span sum).
    Returns False (and costs one thread-local read) when no span is
    open."""
    st = getattr(_OPEN, "stack", None)
    if not st:
        return False
    args = st[-1]["args"]
    args["joules"] = args.get("joules", 0.0) + float(joules)
    args["metered_s"] = args.get("metered_s", 0.0) + float(seconds)
    return True


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One open sync span: pushes its event dict on the thread-local
    stack at enter, stamps ``dur`` and appends to the tracer at exit."""

    __slots__ = ("_tracer", "_ev", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self._ev = {"ph": "X", "name": name, "cat": "span",
                    "ts": 0.0, "dur": 0.0, "pid": tracer.pid,
                    "tid": threading.get_ident(), "args": args}

    def __enter__(self):
        st = _open_stack()
        self._ev["depth"] = len(st)
        self._t0 = time.monotonic_ns()
        self._ev["ts"] = self._t0 / 1e3
        st.append(self._ev)
        return self._ev["args"]

    def __exit__(self, exc_type, exc, tb):
        self._ev["dur"] = (time.monotonic_ns() - self._t0) / 1e3
        st = _open_stack()
        if st and st[-1] is self._ev:
            st.pop()
        else:  # misnested exit: drop without corrupting siblings
            with contextlib.suppress(ValueError):
                st.remove(self._ev)
        self._tracer.events.append(self._ev)
        return False


class Tracer:
    """Collects trace events; ``enabled=False`` records nothing."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self.events: list[dict] = []
        self.pid = os.getpid()
        self._wall_offset: int | None = None

    @staticmethod
    def now_us() -> float:
        """Microseconds on the same monotonic clock every event uses."""
        return time.monotonic_ns() / 1e3

    def wall_offset_ns(self) -> int:
        """Nanoseconds from the events' monotonic clock to
        ``time.time_ns``: an event starts at ``ts * 1e3 + offset`` on
        the wall clock.  Read once per tracer, from the tightest of a
        few (monotonic, wall, monotonic) brackets."""
        if self._wall_offset is None:
            best = None
            for _ in range(8):
                m0 = time.monotonic_ns()
                w = time.time_ns()
                m1 = time.monotonic_ns()
                if best is None or m1 - m0 < best[0]:
                    best = (m1 - m0, w - (m0 + m1) // 2)
            self._wall_offset = best[1]
        return self._wall_offset

    # ------------------------------------------------------------- spans --
    def span(self, name: str, **args):
        """Context manager for a synchronous span.  Yields the span's
        mutable ``args`` dict (add attributes mid-span); the event is
        recorded at exit with monotonic ``ts``/``dur``."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args)

    def begin_async(self, name: str, id: Any, *, cat: str = "request",
                    ts: float | None = None, **args) -> None:
        """Open an async span keyed by ``(cat, id, name)`` -- lifecycles
        that overlap across threads/loop iterations.  ``ts`` overrides
        the event time (microseconds from :meth:`now_us`; e.g. a
        request's arrival timestamp recorded before the loop ran)."""
        if not self.enabled:
            return
        self.events.append(
            {"ph": "b", "name": name, "cat": cat, "id": str(id),
             "ts": self.now_us() if ts is None else float(ts),
             "pid": self.pid, "tid": threading.get_ident(),
             "args": args})

    def end_async(self, name: str, id: Any, *, cat: str = "request",
                  ts: float | None = None, **args) -> None:
        if not self.enabled:
            return
        self.events.append(
            {"ph": "e", "name": name, "cat": cat, "id": str(id),
             "ts": self.now_us() if ts is None else float(ts),
             "pid": self.pid, "tid": threading.get_ident(),
             "args": args})

    def instant(self, name: str, **args) -> None:
        if not self.enabled:
            return
        self.events.append(
            {"ph": "i", "name": name, "cat": "span", "s": "t",
             "ts": self.now_us(), "pid": self.pid,
             "tid": threading.get_ident(), "args": args})

    # ----------------------------------------------------------- exports --
    def to_chrome(self) -> dict:
        """Chrome ``trace_event`` document (Perfetto / chrome://tracing);
        its ``otherData`` holds :meth:`wall_offset_ns`."""
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms",
                "otherData": {"wall_offset_ns": self.wall_offset_ns()}}

    def write_jsonl(self, path: str) -> None:
        """One event per line -- the streaming-friendly raw form the
        ``python -m repro_torch.obs.trace`` CLI converts and validates."""
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev, sort_keys=True) + "\n")

    def write_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1, sort_keys=True)


# ------------------------------------------------------- default tracer ---
_DEFAULT_TRACER = Tracer(enabled=False)


def default_tracer() -> Tracer:
    """Process-default tracer (disabled until a caller installs one):
    library layers trace through :func:`trace_span` unconditionally and
    pay one flag check when no one is listening."""
    return _DEFAULT_TRACER


def set_default_tracer(tracer: Tracer) -> Tracer:
    global _DEFAULT_TRACER
    prev, _DEFAULT_TRACER = _DEFAULT_TRACER, tracer
    return prev


def trace_span(name: str, **args):
    """``with trace_span("steps.build_serve_step", shape=...):`` --
    a span on the process-default tracer."""
    return _DEFAULT_TRACER.span(name, **args)


# ------------------------------------------------------------ validation --
_PHASES = ("X", "b", "e", "i")


def validate_trace(d: Any, *, strict: bool = False) -> list[str]:
    """Schema-check a Chrome trace document; returns problems ([] when
    valid), ``strict`` raises.  Beyond per-event shape it checks the
    async discipline: every ``b`` has a matching later ``e`` on the
    same ``(cat, id, name)`` key."""
    errors: list[str] = []
    if not isinstance(d, dict) or not isinstance(d.get("traceEvents"),
                                                 list):
        errors.append("document must be {'traceEvents': [...]}")
        if strict:
            raise ValueError("invalid trace: " + "; ".join(errors))
        return errors
    open_async: dict[tuple, list[float]] = {}
    for i, ev in enumerate(d["traceEvents"]):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        if not isinstance(ev.get("name"), str) or not ev.get("name"):
            errors.append(f"{where}.name: expected non-empty string")
        ph = ev.get("ph")
        if ph not in _PHASES:
            errors.append(f"{where}.ph: expected one of {_PHASES}, "
                          f"got {ph!r}")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"{where}.ts: expected non-negative number, "
                          f"got {ts!r}")
            continue
        if "args" in ev and not isinstance(ev["args"], dict):
            errors.append(f"{where}.args: expected object")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where}.dur: expected non-negative "
                              f"number, got {dur!r}")
        elif ph in ("b", "e"):
            if not isinstance(ev.get("id"), str):
                errors.append(f"{where}.id: expected string")
                continue
            if not isinstance(ev.get("cat"), str):
                errors.append(f"{where}.cat: expected string")
                continue
            key = (ev["cat"], ev["id"], ev["name"])
            if ph == "b":
                open_async.setdefault(key, []).append(float(ts))
            else:
                opened = open_async.get(key)
                if not opened:
                    errors.append(f"{where}: end_async without begin "
                                  f"for {key}")
                elif float(ts) < opened[-1]:
                    errors.append(f"{where}: async end precedes its "
                                  f"begin for {key}")
                else:
                    opened.pop()
    for key, opened in open_async.items():
        if opened:
            errors.append(f"unclosed async span {key} "
                          f"(x{len(opened)})")
    if errors and strict:
        raise ValueError("invalid trace: " + "; ".join(errors))
    return errors


# -------------------------------------------------------------------- CLI --
def load_events(path: str) -> dict:
    """Read a trace from ``path``: JSONL of events, or an already
    converted Chrome document (idempotent)."""
    with open(path) as f:
        text = f.read()
    try:
        d = json.loads(text)
        if isinstance(d, dict) and "traceEvents" in d:
            return d
        events = [d] if isinstance(d, dict) else list(d)
    except json.JSONDecodeError:
        events = [json.loads(line) for line in text.splitlines()
                  if line.strip()]
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="convert a repro_torch.obs JSONL trace to Chrome "
                    "trace_event JSON (Perfetto-loadable) and/or "
                    "validate its schema")
    ap.add_argument("path", help="JSONL trace (or Chrome JSON) to read")
    ap.add_argument("-o", "--out", default=None, metavar="PATH",
                    help="write the Chrome trace document here")
    ap.add_argument("--validate", action="store_true",
                    help="schema-check the trace; non-zero exit on "
                         "problems")
    args = ap.parse_args(argv)
    d = load_events(args.path)
    errors = validate_trace(d) if args.validate else []
    for e in errors:
        print(f"INVALID {args.path}: {e}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(d, f, indent=1, sort_keys=True)
        print(f"wrote {args.out} ({len(d['traceEvents'])} events)")
    if args.validate and not errors:
        print(f"OK {args.path}")
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
