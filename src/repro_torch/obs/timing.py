"""Device time of a run of launches, by CUDA events, without the host's gaps.

The port's wrappers are host-paced at small batches: a launch costs 16–35 µs
of Python while a block kernel at 4096 tiles runs for ~10 µs. Events around
back-to-back calls would then time the host. :func:`device_time_ms` first
parks the stream behind a spinning kernel (``torch.cuda._sleep``), queues
the launches while the device spins, and times them between two events
recorded around them: the device then runs them back to back. If the spin
ended before the host had queued the last launch (the start event already
complete), the window may hold host gaps, so it retries with a spin four
times longer, and raises after the last try; it never returns a host-paced
time.
"""
from __future__ import annotations

import torch

SPIN_CYCLES = 1 << 22  # first spin: ~2.5 ms at the card's ~1.7 GHz
SPIN_TRIES = 5


def device_time_ms(fn, n: int = 50) -> float:
    """Mean device time (ms) of one ``fn()`` over ``n`` calls queued back to
    back on the current stream. ``fn`` must launch on the current CUDA stream
    and never synchronize. Calls ``fn`` once first (a build, a first-use
    allocation) outside the window."""
    fn()
    torch.cuda.synchronize()
    cycles = SPIN_CYCLES
    for _ in range(SPIN_TRIES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        queued_ahead = not start.query()  # the device still spinning
        end.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / n
        cycles *= 4
    raise RuntimeError(f"device_time_ms: the host could not queue {n} calls within a "
                       f"spin of {cycles // 4} cycles; the time would include host gaps")
