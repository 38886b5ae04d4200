"""Device time per call from the profiler, read only from whole windows.

The one rule by which ``chip_smoke.py`` and ``step_kernels`` read device
time: the calls queue behind a spin kernel of about 5 ms (not counted) at
both ends of the profiler's window, so no call sits at the edge of its
trace. The profiler on the card still drops a launch from a window now and
then, so a window is read only when whole (every device operation ran a
whole multiple of the calls); one that is not is logged and discarded, and
after ten such windows the call fails.

A process's first profiler session on the card can record no device
activity: on an H100 the first window of ``chip_smoke.py`` read empty in
two runs, and one run failed when none of the five windows of its first
row was whole. So before its first window a process waits until a short
session records every kernel it launched (``profiler_ready``), and a
window in which the profiler recorded nothing, not even the spin kernels,
is a session that failed, not a window: it is logged and tried again after
a pause, ten times at most, without counting as one of the ten.

A session can also miss its start: on an H100 the windows of a row lost,
window after window until the row failed, every device operation up to and
including the first kernel of the first call (the SDPA windows lost the
first kernel of their first call, not their last). A short spin, a
synchronize and a pause ahead of the session's first call did not help:
the pause's spin was lost too. So each session opens with ``LEAD_CALLS``
calls that are not counted (on the warm-up's inputs), and the window is
what ran between the session's last two spin kernels.
"""
from __future__ import annotations

import time

import torch

SPIN_CYCLES = 10_000_000                # torch.cuda._sleep: about 5 ms
WINDOWS = 10                            # windows that are not whole, then fail
SESSIONS = 10                           # sessions that record nothing, then fail
PAUSE_S = 0.5
LEAD_CALLS = 3                          # calls ahead of the window, not counted
_ready = False


def _device_events(prof):
    """(spin kernels, {name: [us, ...]} of every other device operation
    that ran between the last two spin kernels; of all of them if fewer
    than two spins were recorded)."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spins = sorted((e.time_range.start, e.time_range.end) for e in events
                   if "spin_kernel" in e.name)
    lo, hi = (spins[-2][1], spins[-1][0]) if len(spins) >= 2 else (-1, float("inf"))
    us = {}
    for e in events:
        if "spin_kernel" not in e.name and lo <= e.time_range.start < hi:
            us.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return len(spins), us


def profiler_ready(log=print):
    """Return once a profiler session of four small kernels between two
    short spins records all of them; log each session that does not,
    pausing after it, and fail after ``SESSIONS`` of them. Once per process."""
    global _ready
    from torch.profiler import ProfilerActivity, profile

    if _ready:
        return
    x, launches = torch.zeros(1, device="cuda"), 4
    for n in range(1, SESSIONS + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SPIN_CYCLES // 100)
            for _ in range(launches):
                x.add_(1)
            torch.cuda._sleep(SPIN_CYCLES // 100)
            torch.cuda.synchronize()
        spins, us = _device_events(prof)
        if spins == 2 and sum(map(len, us.values())) == launches:
            _ready = True
            log(f"  profiler ready after {n} session(s)")
            return
        log(f"  profiler not ready: {spins} spins and "
            f"{ {name[:60]: len(t) for name, t in us.items()} } of {launches} launches "
            "recorded")
        time.sleep(PAUSE_S)
    raise AssertionError(f"the profiler missed device activity in {SESSIONS} sessions")


def device_ms(fn, sets, iters: int, log=print):
    """Device time in ms of one call of ``fn(*s)``: the duration of every
    device operation in a window of ``iters`` calls on the rotated input
    sets, summed and divided by ``iters``; and by name, (launches in the
    window, ms per call). Each try starts where the last one stopped in the
    rotation, and the warm-up and each session's ``LEAD_CALLS`` take the
    last three sets, so a try on fewer calls than there are sets finds its
    inputs as cold as the first."""
    from torch.profiler import ProfilerActivity, profile

    profiler_ready(log)
    for s in sets[-3:]:
        fn(*s)
    torch.cuda.synchronize()
    windows = sessions = attempt = 0
    while True:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(LEAD_CALLS):
                fn(*sets[-3:][i % len(sets[-3:])])
            torch.cuda._sleep(SPIN_CYCLES)
            for i in range(iters):
                fn(*sets[(attempt * iters + i) % len(sets)])
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        attempt += 1
        spins, us = _device_events(prof)
        if us and all(len(t) % iters == 0 for t in us.values()):
            return (sum(map(sum, us.values())) / iters / 1e3,
                    {n: (len(t), sum(t) / iters / 1e3) for n, t in us.items()})
        if not spins and not us:
            sessions += 1
            log(f"  profiler session of {iters} calls recorded nothing, not read")
            if sessions == SESSIONS:
                raise AssertionError(f"the profiler recorded nothing in {SESSIONS} sessions")
            time.sleep(PAUSE_S)
            continue
        windows += 1
        log(f"  profiler window of {iters} calls not whole, not read: {spins} spins, "
            f"{ {n[:60]: len(t) for n, t in us.items()} }")
        if windows == WINDOWS:
            raise AssertionError(
                f"the profiler gave no whole window of {iters} calls in {WINDOWS}")
