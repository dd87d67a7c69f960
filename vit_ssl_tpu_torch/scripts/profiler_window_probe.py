"""Probe: when does a ``torch.profiler`` session lose a short window's
device events, and does padding the window with device work keep them?

Kineto keeps a device activity only if it falls inside the recorded
cycle's capture window, on the host clock. If the card's timestamps sit
off the host clock by more than the gap between the window's edge and
the first (or last) kernel, those kernels are dropped, and a window of
five short calls loses all of them. The probe profiles five bf16
3072 x 3072 products (about half a millisecond of device work) the way
``chip_smoke.py::profile_window`` does, in sessions that take turns:

- ``bare``: the recorded cycle holds the calls alone;
- ``padded``: the recorded cycle holds a spin kernel (``torch.cuda._sleep``)
  of ``--pad-ms`` before the calls and one after.

Per session it counts the products recorded, and it reads the offset of
the card's clock from the host's as the time from the cycle's first
kernel launch on the host to the first device activity's start (a few
microseconds on a clock without skew).
Run on a machine with an NVIDIA GPU, from the root of a checkout:

    python -m vit_ssl_tpu_torch.scripts.profiler_window_probe [--sessions 60]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

CALLS = 5
SIZE = 3072


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def spin_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` a device millisecond, from
    CUDA events around a 10-million-cycle spin."""
    torch.cuda._sleep(1_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def session(fn, pad_cycles: int) -> dict:
    """One profiler session as ``chip_smoke.py::profile_window`` runs it
    (a warm-up cycle, then the recorded one), with spin pads of
    ``pad_cycles`` around ``fn`` in the recorded cycle when nonzero."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        if pad_cycles:
            torch.cuda._sleep(pad_cycles)
        fn()
        if pad_cycles:
            torch.cuda._sleep(pad_cycles)
        torch.cuda.synchronize()
        prof.step()
    events = prof.events()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    products = [e for e in device if "spin_kernel" not in e.name]
    spins = sorted((e for e in device if "spin_kernel" in e.name),
                   key=lambda e: e.time_range.start)
    launches = sorted((e for e in events if "LaunchKernel" in e.name
                       and e.device_type == torch.autograd.DeviceType.CPU),
                      key=lambda e: e.time_range.start)
    first = min(device, key=lambda e: e.time_range.start, default=None)
    offset_us = (first.time_range.start - launches[0].time_range.start
                 if first is not None and launches else None)
    return {"device_events": len(device), "products": len(products),
            "spin_names": sorted({e.name for e in spins}), "offset_us": offset_us}


def probe(sessions: int, pad_ms: float) -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    a, b = (torch.randn(SIZE, SIZE, generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(2))

    def fn():
        for _ in range(CALLS):
            torch.mm(a, b)

    pad_cycles = int(pad_ms * spin_cycles_per_ms())
    results = {"bare": [], "padded": []}
    for _ in range(sessions):
        results["bare"].append(session(fn, 0))
        results["padded"].append(session(fn, pad_cycles))
    summary = {"torch": torch.__version__, "calls": CALLS, "size": SIZE,
               "pad_ms": pad_ms, "pad_cycles": pad_cycles, "sessions": sessions}
    for mode, rows in results.items():
        offsets = [r["offset_us"] for r in rows if r["offset_us"] is not None]
        summary[mode] = {
            "lost_all": sum(r["device_events"] == 0 for r in rows),
            "lost_some": sum(0 < r["products"] < CALLS for r in rows),
            "products_recorded": [r["products"] for r in rows],
            "spin_names": sorted({n for r in rows for n in r["spin_names"]}),
            "offset_us_min": min(offsets, default=None),
            "offset_us_median": statistics.median(offsets) if offsets else None,
            "offset_us_max": max(offsets, default=None),
        }
    return summary


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sessions", type=int, default=60)
    parser.add_argument("--pad-ms", type=float, default=2.0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiler_window_probe needs a CUDA card")
    print(card_line(), flush=True)
    print(json.dumps(probe(args.sessions, args.pad_ms)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
