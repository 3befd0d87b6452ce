"""``pgica_tpu_torch/utils/trace.py`` against ``torch.profiler``'s own ``key_averages``, on the CPU.

The totals read off the raw events must be the ones ``key_averages`` gives:
host self time by operator name within 1e-3 us (the same nanoseconds, summed
in another order) and the same call counts, including operators that
re-dispatch to themselves; with ``within``, only the events inside the named
ranges, as the trainer's ``profiles`` count them.
"""

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from pgica_tpu_torch.utils import trace

RANGE = "train_step"


def _workload(kind: str):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.GELU(), torch.nn.LayerNorm(32),
                                torch.nn.Linear(32, 4))
    opt = torch.optim.AdamW(model.parameters())
    x = torch.randn(8, 16)

    def step():
        loss = model(x).square().mean()  # mean re-dispatches to itself
        loss.backward()
        opt.step()
        opt.zero_grad()

    def run():
        for _ in range(5):
            if kind == "ranges":
                with record_function(RANGE):
                    step()
                torch.randn(4).sum()  # outside every range
            else:
                step()
    return run


def _reference(prof, within):
    """name -> (self us, count) from key_averages, or of the host events inside ``within``'s ranges."""
    if within is None:
        return {e.key: (e.self_cpu_time_total, e.count) for e in prof.key_averages() if e.device_type == DeviceType.CPU}
    host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    spans = [(e.time_range.start, e.time_range.end) for e in host if e.name == within]
    out = {}
    for e in host:
        if e.name != within and any(s <= e.time_range.start and e.time_range.end <= t for s, t in spans):
            us, n = out.get(e.name, (0.0, 0))
            out[e.name] = (us + e.self_cpu_time_total, n + 1)
    return out


@pytest.mark.parametrize("kind,within", [("plain", None), ("ranges", None), ("ranges", RANGE)])
def test_host_self_times_equal_key_averages(kind, within):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _workload(kind)()
    got = trace.host_self_times(trace.raw_events(prof), within=within)
    want = _reference(prof, within)
    assert want and got.keys() == want.keys()
    for name, (us, n) in want.items():
        assert got[name][1] == n, name
        assert got[name][0] == pytest.approx(us, abs=1e-3), name
    if within is not None:
        assert RANGE not in got and "aten::randn" not in got


def test_largest_and_device_totals():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _workload("plain")()
    events = trace.raw_events(prof)
    assert trace.device_totals(events) == {}  # no device here
    host = trace.host_self_times(events)
    top = trace.largest(host, 3)
    assert len(top) == 3 and [t[1] for t in top] == sorted((us for us, _ in host.values()), reverse=True)[:3]
