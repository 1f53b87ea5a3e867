"""The shipped scenario specs: what each mode id runs after the spine.

Every scenario runs the shared spine (``primitives.SPINE``), then its
switch stages (filter-only work, with their params), then its gated
stages (``primitives.GATED``). ``host_stage`` names the per-frame host
bookkeeping the localizer replays from the step's outputs. The table is
``repro``'s five registered specs in mode-id order; their per-scenario
knobs (window, IMU rate, BA cadence) and registering new scenarios are
not ported: every scenario runs at the localizer's config.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional, Tuple

from repro_torch.core.environment import Mode


@dataclass(frozen=True)
class ScenarioSpec:
    name: str
    switch: Tuple[Tuple[str, Mapping], ...] = ()   # (stage, params)
    gated: Tuple[str, ...] = ()
    host_stage: Optional[str] = None


# indexed by mode id (``environment.MODE_TO_ID``)
SPECS = (
    ScenarioSpec(name=Mode.VIO.value, switch=(("gps_fusion", {}),)),
    ScenarioSpec(name=Mode.SLAM.value,
                 gated=("bow_histogram", "ba_marginalize"),
                 host_stage="slam"),
    ScenarioSpec(name=Mode.REGISTRATION.value, host_stage="registration"),
    ScenarioSpec(name=Mode.DRONE_VIO.value),
    ScenarioSpec(name=Mode.VIO_DEGRADED.value,
                 switch=(("gps_fusion", {"sigma_gps": 0.25}),)),
)
