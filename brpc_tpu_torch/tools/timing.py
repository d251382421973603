"""timing — the device-time harnesses that ``chip_smoke.py``,
``profile_launch`` and ``sweeps/sweep_p2p_copy.py`` share, so that their
numbers compare.

- single launch (:func:`event_ms`, :func:`time_in_turns`): CUDA events
  around one call, the 50 MB L2 flushed before each, a spin ahead so the
  host's launch cost stays out; median of ``TIMED_RUNS``, two rounds in
  turns (the second in reverse order), each key keeping the better
  median;
- back to back (:class:`Rotation`, :func:`b2b_in_turns`): up to
  ``B2B_MAX_WINDOW`` calls between one pair of events, divided by the
  count, over source and destination slices of two pools past the L2, so
  each call finds its source cold; :func:`empty_kernel` run through the
  same loop gives the method's floor;
- host cost (:func:`host_us`): perf_counter over many enqueues.

Every function here needs a CUDA card; nothing runs at import.
"""
from __future__ import annotations

import statistics
import subprocess
import time

import torch

from ..ici.cuda_kernel import BUILD_DIR, CudaKernel

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet
TIMED_RUNS = 25
B2B_POOL_BYTES = 128 << 20         # each side of the rotation, past the L2
B2B_MAX_WINDOW = 256               # launches between one pair of events
B2B_WINDOWS = 5
SPIN_CYCLES = 200_000              # ~100 µs of GPU spin ahead of each timing

_EMPTY_SOURCE = r"""// An empty kernel: the floor of a timing loop of launches.
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def nvidia_smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def empty_kernel() -> CudaKernel:
    """An empty kernel, built and launched like the port's kernels (nvcc at
    first use, ctypes, the current stream): ``k.launch(k.record(index))``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    source = BUILD_DIR / "empty_kernel.cu"
    if not source.exists() or source.read_text() != _EMPTY_SOURCE:
        source.write_text(_EMPTY_SOURCE)
    return CudaKernel(source, "empty_launch", [])


def event_ms(fn, flush: torch.Tensor, runs: int = TIMED_RUNS,
             warm: int = 3) -> float:
    """Device time of ``fn``: the median over ``runs`` single calls, each
    between two CUDA events, with the 50 MB L2 cache flushed (``flush``
    rewritten) before each.  A spin kernel ahead of the start event keeps
    the stream busy while the host enqueues ``fn``, so the host's launch
    cost stays out of the interval."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _turns(keys) -> list:
    """Two rounds over ``keys``, the second in reverse order (a, b, c,
    c, b, a), so that no key is always timed first."""
    keys = list(keys)
    return keys + keys[::-1]


def time_in_turns(timed: dict, flush: torch.Tensor,
                  runs: int = TIMED_RUNS) -> dict:
    """Two rounds of ``event_ms`` over ``timed`` (key -> fn) in turns,
    each key keeping the better of its two medians."""
    best = dict.fromkeys(timed, float("inf"))
    for key in _turns(timed):
        best[key] = min(best[key], event_ms(timed[key], flush, runs=runs))
    return best


def host_us(fn, runs: int = 500) -> float:
    """Host cost of enqueueing ``fn`` once (µs), over ``runs`` calls."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / runs * 1e6


class Rotation:
    """Source and destination slices of ``n`` bytes (at offsets ``so`` and
    ``do``) cut from two pools of at least B2B_POOL_BYTES each, handed out
    in windows that cycle through the pools: a slice comes round again only
    after more than the 50 MB L2 of other bytes, so every launch finds its
    source cold."""

    def __init__(self, n: int, so: int, do: int, dev, gen):
        stride = (n + 16 + 511) // 512 * 512
        slots = max(2, -(-B2B_POOL_BYTES // stride))
        self.src_pool = torch.randint(0, 256, (slots * stride,),
                                      dtype=torch.uint8, device=dev,
                                      generator=gen)
        self.dst_pool = torch.empty(slots * stride, dtype=torch.uint8,
                                    device=dev)
        self.pairs = [(self.src_pool[i * stride + so:i * stride + so + n],
                       self.dst_pool[i * stride + do:i * stride + do + n])
                      for i in range(slots)]
        self.window = min(B2B_MAX_WINDOW, max(8, slots))
        self.cursor = 0

    def next_window(self) -> list:
        out = [self.pairs[(self.cursor + i) % len(self.pairs)]
               for i in range(self.window)]
        self.cursor = (self.cursor + self.window) % len(self.pairs)
        return out


def spin_cycles_per_us() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per microsecond on this card."""
    torch.cuda._sleep(1_000_000)            # warm
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    b.synchronize()
    return 10_000_000 / (a.elapsed_time(b) * 1e3)


def b2b_window_ms(call, pairs, cycles_per_us: float) -> float:
    """Device time per launch of ``call(src, dst)`` over ``pairs``: all the
    launches back to back between one pair of CUDA events.  A spin ahead of
    the start event lasts until the host has enqueued every launch (the
    window is re-run with a longer spin if the host was slower), so host
    gaps stay out of the interval."""
    host_us_each = 30.0
    while True:
        spin_us = len(pairs) * host_us_each + 200.0
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_us * cycles_per_us))
        t0 = time.perf_counter()
        a.record()
        for src, dst in pairs:
            call(src, dst)
        b.record()
        enqueue_us = (time.perf_counter() - t0) * 1e6
        b.synchronize()
        if enqueue_us < 0.8 * spin_us:
            return a.elapsed_time(b) / len(pairs)
        host_us_each *= 2


def b2b_in_turns(timed: dict, rot: Rotation, cycles_per_us: float) -> dict:
    """Two rounds over ``timed`` (key -> call(src, dst)) in turns, each the
    median of B2B_WINDOWS windows of ``rot``; each key keeps the better."""
    best = dict.fromkeys(timed, float("inf"))
    for key in _turns(timed):
        call = timed[key]
        call(*rot.pairs[0])                                  # warm
        runs = [b2b_window_ms(call, rot.next_window(), cycles_per_us)
                for _ in range(B2B_WINDOWS)]
        best[key] = min(best[key], statistics.median(runs))
    return best
