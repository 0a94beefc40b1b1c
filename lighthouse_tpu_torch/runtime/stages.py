"""Per-stage wall time of an engine call, as rows.

The port's counterpart of ``lighthouse_tpu/runtime/engine.py``'s
``StageTimer``.  The port has no metrics registry, so the rows are the
record: an engine keeps the rows of its last call (for example the epoch
engine's ``last_stage_rows()``) and ``chip_smoke.py`` prints them.  Stages
are timed one after another, so they sum to less than the wall time of
the call around them.
"""
from __future__ import annotations

import time
from typing import List


class StageTimer:
    """``with timer.stage("name"): ...`` appends ``{"stage", "ms"}``."""

    def __init__(self):
        self._rows: List[dict] = []

    class _Span:
        __slots__ = ("timer", "stage", "t0")

        def __init__(self, timer, stage):
            self.timer = timer
            self.stage = stage

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.timer._rows.append(
                {"stage": self.stage,
                 "ms": (time.perf_counter() - self.t0) * 1e3})
            return False

    def stage(self, name: str) -> "StageTimer._Span":
        return StageTimer._Span(self, name)

    def rows(self) -> List[dict]:
        return list(self._rows)
