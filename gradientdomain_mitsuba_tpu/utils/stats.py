"""Render statistics and observability.

Replacement for Mitsuba's StatsCounter/Statistics registry +
phase timers (src/libcore/statistics.cpp, timer.cpp): phase wall-clocks,
derived ray counts (the wavefront design makes ray counts a closed-form
function of resolution/spp/depth per integrator — no atomic counters on
the hot path), and a printStats()-style table.
"""
from __future__ import annotations

import time
from collections import OrderedDict


class RenderStats:
    def __init__(self):
        self.phases = OrderedDict()
        self.counters = OrderedDict()
        self._t0 = {}

    def start(self, phase: str):
        self._t0[phase] = time.time()

    def stop(self, phase: str):
        dt = time.time() - self._t0.pop(phase)
        self.phases[phase] = self.phases.get(phase, 0.0) + dt
        return dt

    def add(self, counter: str, value):
        self.counters[counter] = self.counters.get(counter, 0) + value

    def set(self, counter: str, value):
        self.counters[counter] = value

    # -- derived ray counts (per the BASELINE.md protocol) ----------------
    @staticmethod
    def rays_path(width, height, spp, max_depth):
        bounces = max(max_depth, 1)
        return width * height * spp * (1 + 2 * (bounces - 1))

    @staticmethod
    def rays_gpt(width, height, spp, max_depth):
        bounces = max(max_depth - 1, 1)
        return width * height * spp * (5 + bounces * 10)

    @staticmethod
    def rays_bdpt(width, height, spp, max_depth):
        d = max_depth
        n_strat = sum(1 for t in range(1, d + 2) for s in range(0, d + 1)
                      if 2 <= s + t and s + t - 1 <= d)
        return width * height * spp * (2 * d + n_strat)

    def table(self) -> str:
        lines = ["  Render statistics:"]
        for k, v in self.phases.items():
            lines.append(f"    {k:<28s} {v:9.2f} s")
        for k, v in self.counters.items():
            if isinstance(v, float):
                lines.append(f"    {k:<28s} {v:12.3f}")
            else:
                lines.append(f"    {k:<28s} {v:>12,}")
        return "\n".join(lines)
