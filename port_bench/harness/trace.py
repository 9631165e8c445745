"""The profiled sub-window of a traced run, read from ``torch.profiler``'s
trace.

The run wraps the sub-window in the annotation ``profiled_window`` and each
call into the program in a span of its own (``record_function``), so device
activity and the host's spans share one clock. ``Trace`` keeps the device's
kernels, copies and sets inside the window and the host's spans. The window
runs from the first call's span to the end of the annotation, which drains
the device; it runs under the profiler, which adds host time to every call,
so its idle share is an upper bound of the unprofiled window's.
"""

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "profiled_window"


class Trace:
    def __init__(self, events, steps):
        spans = [e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
        window = [e for e in spans if e["name"] == WINDOW]
        if not window:
            raise ValueError("the trace has no profiled window")
        self.spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                      for e in spans if e["name"] != WINDOW]
        # From the first call into the program (the profiler's own start-up
        # before it is not the program's) to the drained device.
        self.start = min([a for _, a, _ in self.spans] or [float(window[0]["ts"])])
        self.end = float(window[0]["ts"]) + float(window[0]["dur"])
        self.steps = steps  # calls into the program inside the window
        self.device = sorted(
            (e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
            for e in events
            if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"
            and self.start <= float(e["ts"]) < self.end
        )
        self.device.sort(key=lambda e: e[1])

    @classmethod
    def from_profiler(cls, prof, steps):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return cls(events, steps)

    @property
    def window_s(self):
        return (self.end - self.start) / 1e6

    def busy_intervals(self):
        """The union of device activity, clipped to the window (us)."""
        merged = []
        for _, a, b in self.device:
            a, b = max(a, self.start), min(b, self.end)
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            elif b > a:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self):
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernels(self, pattern):
        """[(name, seconds)] of device activities whose name matches the
        compiled regex ``pattern``."""
        return [(n, (b - a) / 1e6) for n, a, b in self.device if pattern.search(n)]

    def top_ops(self, n=10):
        totals = {}
        for name, a, b in self.device:
            totals[name] = totals.get(name, 0.0) + (b - a) / 1e6
        return sorted(([k[:160], v] for k, v in totals.items()), key=lambda x: -x[1])[:n]

    def _span_at(self, t):
        inside = [(b - a, name) for name, a, b in self.spans if a <= t < b]
        return min(inside)[1] if inside else "between spans"

    def idle_gaps(self, n=10):
        """The longest stretches with nothing on the device, each named by
        the innermost span the host was in when it began."""
        gaps, t = [], self.start
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end))
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._span_at(a), (b - a) / 1e6] for a, b in gaps[:n]]
