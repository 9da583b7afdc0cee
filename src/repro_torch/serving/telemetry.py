"""The serving layer's telemetry hook: the null registry only (the port's
copy of ``_NullTelemetry``/``NULL_TELEMETRY`` of
``repro/serving/telemetry.py``).

The engine and the scheduler call these methods at their telemetry points;
the null registry answers each with nothing, and ``enabled`` is False, so
the hot paths skip their aggregation work.  The registry that records
counters, histograms and spans is not ported yet: the scheduler refuses a
``telemetry`` other than None.
"""

from __future__ import annotations

__all__ = ["NULL_TELEMETRY"]


class _NullTelemetry:
    """The disabled default: every method is a no-op and ``enabled`` is
    False.  One shared instance, never mutated."""

    enabled = False

    def bind_clock(self, clock):
        pass

    def count(self, name, n=1):
        pass

    def gauge(self, name, value):
        pass

    def observe(self, name, value, edges=None):
        pass

    def add_provider(self, prefix, fn):
        pass

    def span(self, track, tid, name, t0, t1):
        pass

    def open_span(self, track, tid, name):
        pass

    def close_span(self, track, tid, name):
        pass

    def instant(self, track, tid, name):
        pass

    def counter(self, name, value):
        pass

    def attach_engine(self, engine):
        pass

    def attach_kernel_counters(self):
        pass

    def scoped(self, scope):
        return self

    def snapshot(self):
        return {}

    def event_log(self):
        return []

    def summary(self):
        return "[telemetry] disabled"


NULL_TELEMETRY = _NullTelemetry()
