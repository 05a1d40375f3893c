"""The traced stretch: ``torch.profiler`` over a few steady steps, reduced in memory.

:class:`Stretch` starts the profiler from a forward pre-hook on the model at call ``warm``
and stops it (after a device sync) at call ``warm + steps``, so the stretch holds ``steps``
whole steps from inside a running loop. :class:`PosConvRange` opens and closes a
``record_function`` range around one module's forward, so a reader can find that module's
forward ops and, by their autograd sequence numbers, its backward. :func:`summarise` keeps
what the readers and the result line need: the device activities, the busy time (the union
of their intervals), the stretch's span, the top device operations and the idle gaps by
what the host was doing. No trace is written to disk.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.autograd import DeviceType
from torch.autograd.profiler import record_function

TOP = 10
NAME_CHARS = 160             # a device op's name in the breakdown: before its arguments, cut
SCAN = 4096                  # host ops looked at back from a gap for the one that holds it


def _is_device_work(e, ranges: tuple[str, ...]) -> bool:
    """A kernel, copy or fill on the device, not the device-side shadow of a range (a user
    annotation, or one of ``ranges`` by name)."""
    return not e.is_user_annotation() and e.name() not in ranges


class Stretch:
    """Profile model calls ``warm .. warm + steps - 1`` (each with everything the loop runs
    until the next call); ``ranges`` names the ``record_function`` ranges opened in it."""

    def __init__(self, model: torch.nn.Module, warm: int, steps: int, device,
                 ranges: tuple[str, ...] = ()):
        self.warm, self.steps, self.device = warm, steps, torch.device(device)
        self.ranges = ranges
        self.calls, self.prof = 0, None
        self._hook = model.register_forward_pre_hook(self._pre)

    def _activities(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _pre(self, module, args):
        if self.calls == self.warm:
            self._sync()
            self.prof = torch.profiler.profile(activities=self._activities())
            self.prof.start()
        elif self.calls == self.warm + self.steps and self.prof is not None:
            self._sync()
            self.prof.stop()
            self._hook.remove()
        self.calls += 1


class PosConvRange:
    """A ``record_function`` range named ``name`` around every forward of ``module``."""

    def __init__(self, module: torch.nn.Module, name: str):
        self.name, self._open = name, []
        self._hooks = [module.register_forward_pre_hook(self._enter),
                       module.register_forward_hook(self._exit)]

    def _enter(self, module, args):
        rf = record_function(self.name)
        rf.__enter__()
        self._open.append(rf)

    def _exit(self, module, args, out):
        self._open.pop().__exit__(None, None, None)

    def remove(self):
        for h in self._hooks:
            h.remove()


@dataclass
class Summary:
    steps: int
    window_s: float
    busy_s: float
    device: list[tuple[str, int, int]]              # (name, start ns, end ns)
    device_ops: list[list]                          # [name, seconds], the top ones
    idle_gaps: list[list]                           # [host activity, seconds]
    prof: object = field(repr=False, default=None)  # the profiler, for readers of its tree


def short_name(name: str) -> str:
    """A device op's name without its trailing argument list, cut to ``NAME_CHARS``."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                if i and name[i - 1] != " ":          # a signature's arguments, not a note
                    name = name[:i]
                break
    return name[:NAME_CHARS]


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(s, e) for s, e in merged]


def _innermost(host: list[tuple[str, int, int]], starts: list[int], t: int) -> str:
    """The host op that holds time ``t`` and started last (the innermost one)."""
    i = bisect.bisect_right(starts, t)
    for name, s, e in reversed(host[max(0, i - SCAN):i]):
        if e > t:
            return name
    return "host outside any op"


def summarise(stretch: Stretch) -> Summary:
    prof = stretch.prof
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        span = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() == DeviceType.CPU:
            host.append(span)
        elif e.duration_ns() > 0 and _is_device_work(e, stretch.ranges):
            device.append(span)
    ends = [e for _, _, e in device + host]
    t0 = min(s for _, s, _ in device + host) if ends else 0
    t1 = max(ends) if ends else 0
    busy = _union([(s, e) for _, s, e in device])

    by_op: dict[str, int] = defaultdict(int)
    for name, s, e in device:
        by_op[short_name(name)] += e - s
    device_ops = [[name, ns / 1e9] for name, ns in sorted(by_op.items(), key=lambda kv: -kv[1])]

    host.sort(key=lambda h: h[1])
    host_starts = [s for _, s, _ in host]
    by_host: dict[str, int] = defaultdict(int)
    edge = t0
    for s, e in busy + [(t1, t1)]:
        if s > edge:
            by_host[_innermost(host, host_starts, (edge + s) // 2)] += s - edge
        edge = max(edge, e)
    idle = [[name, ns / 1e9] for name, ns in sorted(by_host.items(), key=lambda kv: -kv[1])]
    return Summary(steps=stretch.steps, window_s=(t1 - t0) / 1e9,
                   busy_s=sum(e - s for s, e in busy) / 1e9, device=device,
                   device_ops=device_ops[:TOP], idle_gaps=idle[:TOP], prof=prof)
