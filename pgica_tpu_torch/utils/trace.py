"""Totals of a ``torch.profiler`` trace, read off its raw events.

``profile.key_averages()`` and ``profile.events()`` build a Python object for
every event and a tree over them: tens of seconds for the few hundred
thousand events of a 128-step beam request, a few training steps or a
Poisson run of the server, far longer than the traced work. These functions
take the same totals from the raw (Kineto) events in one pass each: device
time and launches by kernel name, and host self time by operator name (an
event's span less its direct children's on its thread, as ``key_averages``
counts it, with the CUDA runtime calls on the thread of the operator that
made them).
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional

from torch.autograd import DeviceType

# the utility events key_averages leaves out (torch.autograd.profiler_util._filter_name)
_SKIPPED = frozenset(("[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
                      "profiler::_record_function_enter_new", "profiler::_record_function_exit",
                      "aten::is_leaf", "aten::output_nr", "aten::_version"))


def _hidden(event) -> bool:
    return getattr(event, "is_hidden_event", lambda: False)()


def raw_events(prof) -> list:
    """The raw events of a finished ``torch.profiler.profile`` (or ``torch.autograd.profiler.profile``)."""
    results = getattr(prof, "profiler", prof).kineto_results
    return list(results.events()) if results is not None else []


def device_totals(events) -> Dict[str, List[float]]:
    """name -> [microseconds, count] of the device's events: kernels, memory copies and sets (and, on
    the card, the spans of user annotations, which callers leave out by name)."""
    out: Dict[str, List[float]] = {}
    for e in events:
        if e.device_type() == DeviceType.CUDA and not _hidden(e):
            total = out.setdefault(e.name(), [0.0, 0])
            total[0] += e.duration_ns() / 1e3
            total[1] += 1
    return out


def host_self_times(events, within: Optional[str] = None) -> Dict[str, List[float]]:
    """name -> [self microseconds, count] of the host's synchronous events.

    With ``within``, only events of any thread that start and end inside one
    span of a host event of that name count, and those spans do not.
    """
    cpu = DeviceType.CPU
    host = []  # (name, thread, start, end, correlation id, linked correlation id)
    for e in events:
        if e.device_type() != cpu or e.is_async() or _hidden(e):
            continue
        name, thread = e.name(), e.start_thread_id()
        if name not in _SKIPPED and thread == e.end_thread_id():
            host.append((name, thread, e.start_ns(), e.end_ns(), e.correlation_id(), e.linked_correlation_id()))
    # a CUDA runtime call belongs to the thread of the operator it was made for
    thread_of = {corr: thread for _, thread, _, _, corr, linked in host if linked == 0}
    rows = [(thread_of.get(linked, thread) if linked > 0 else thread, start, -end, name)
            for name, thread, start, end, _, linked in host]
    rows.sort()
    self_ns, parent, children = [0] * len(rows), [-1] * len(rows), [0] * len(rows)
    stack: List[int] = []  # indices of the open parents, innermost last
    for i, (thread, start, neg_end, _) in enumerate(rows):
        end = -neg_end
        self_ns[i] += end - start
        while stack and (rows[stack[-1]][0] != thread or start >= -rows[stack[-1]][2] or end > -rows[stack[-1]][2]):
            stack.pop()
        if stack:
            parent[i] = stack[-1]
            self_ns[parent[i]] -= end - start
            children[parent[i]] += 1
        stack.append(i)
    # an operator's only child of the same name (a re-dispatch) is folded into it, as key_averages does
    owner = list(range(len(rows)))
    for i, p in enumerate(parent):
        if p >= 0 and children[p] == 1 and rows[p][3] == rows[i][3]:
            owner[i] = owner[p]
    spans = sorted((start, -neg_end) for _, start, neg_end, name in rows if name == within) if within else None
    out: Dict[str, List[float]] = {}
    for i, (_, start, neg_end, name) in enumerate(rows):
        j = owner[i]
        if spans is not None:
            k = bisect.bisect_right(spans, (rows[j][1], float("inf"))) - 1
            if name == within or k < 0 or -rows[j][2] > spans[k][1]:
                continue
        total = out.setdefault(name, [0.0, 0])
        total[0] += self_ns[i] / 1e3
        total[1] += j == i
    return out


def largest(totals: Dict[str, List[float]], n: int) -> List[tuple]:
    """The ``n`` largest of ``totals`` as (name, microseconds, count), largest first."""
    return sorted(((name, us, count) for name, (us, count) in totals.items()), key=lambda t: t[1], reverse=True)[:n]
