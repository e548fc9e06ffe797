"""Timing helpers shared by the measuring tools and `chip_smoke.py`, for
one CUDA card: a call's time by CUDA events, the device time of each
function a call launches by torch.profiler, and an L2 flush for cold
runs."""

from __future__ import annotations

import statistics

import torch

# bytes read to flush the card's 50 MB L2 before a cold run
L2_FLUSH_BYTES = 256 << 20


def call_ms(fn, reps: int = 5, before=None) -> float:
    """Median of `reps` timed calls of `fn` (CUDA events around the call,
    its host work included), after one warm-up; `before` (untimed) runs
    before each."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        if before is not None:
            before()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def short_name(name: str) -> str:
    """A device function's name as the profiler gives it -> its bare name
    (copies and fills by their kind)."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split(" (")[0]
    name = name.replace("(anonymous namespace)::", "")
    head = name.split("<")[0].split("(")[0].split("::")[-1].split()
    return head[-1] if head else name


def device_ms(fn, reps: int = 5) -> dict:
    """Device ms a call of `fn`, by device function, from torch.profiler:
    a warm-up step, then `reps` calls in the active step; the card idles
    first (the profiler drops device events it places before its
    start)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            for _ in range(4):
                torch.cuda._sleep(1 << 20)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    by: dict = {}
    events: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        nm = short_name(e.name)
        if "spin_kernel" in nm or "sleep" in nm:
            continue
        by[nm] = by.get(nm, 0.0) + e.time_range.elapsed_us() / 1e3
        events[nm] = events.get(nm, 0) + 1
    return dict(device_ms=round(sum(by.values()) / reps, 4),
                device_ms_by_function={k: round(v / reps, 4)
                                       for k, v in sorted(
                                           by.items(), key=lambda kv: -kv[1])},
                events_by_function=events, reps=reps)


def l2_flusher(dev):
    """A function that flushes the card's L2 by reading a 256 MB buffer (a
    max over it: clean lines, so no write-back falls in the next run) and
    waits for it, so the next call starts from an idle card."""
    buf = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)

    def flush():
        buf.max()
        torch.cuda.synchronize(dev)

    return flush
