"""Device timing for the measurement scripts: CUDA-event milliseconds of
a call behind a spin kernel, and the SM clock that ``nvidia-smi`` reads
while the card is busy."""

from __future__ import annotations

import subprocess

import torch

# event_ms's spin before the timed calls: 10^8 cycles, about 50 ms at a
# 1980 MHz SM clock, longer than the host takes to queue 200 calls
SPIN_CYCLES = 10 ** 8


def event_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean device milliseconds per call of fn over reps calls, after one
    call that is not timed unless warm is False.  A spin kernel holds the
    stream while the host queues the calls, so a call whose kernel is
    shorter than its Python launch path is timed by the card, not by the
    host's launch rate."""
    if warm:
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def timed_output(fn, reps: int):
    """(event_ms(fn, reps), the output of fn's last timed call), so that
    what is checked is what was timed."""
    last = [None]

    def call():
        last[0] = fn()

    ms = event_ms(call, reps)
    return ms, last[0]


def sm_clock_mhz() -> float:
    """The first card's current SM clock as nvidia-smi reports it."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                        "--format=csv,noheader,nounits"], capture_output=True,
                       text=True, check=True)
    return float(r.stdout.strip().splitlines()[0])


def clock_under_load(fn, target_ms: float = 500.0) -> float:
    """The SM clock read while fn keeps the card busy: fn is queued for
    about target_ms of device time, the clock read, then the card
    synchronised."""
    per = event_ms(fn, 3)
    for _ in range(max(1, int(target_ms / per))):
        fn()
    mhz = sm_clock_mhz()
    torch.cuda.synchronize()
    return mhz
