"""Operating-environment taxonomy (paper Fig. 2, generalized).

The port's copy of ``repro.core.environment`` plus the environment ->
scenario rule table of the five shipped scenario specs
(``repro.core.scenarios``: each spec's ``EnvRule``). Rules resolve
lowest priority first, so the highest-priority matching rule wins; the
priority-0 unconditional rule (``slam``) is the fallback.

The port runs the ``vio`` scenario only so far; ``require_ported``
raises for every other scenario instead of running it as ``vio``.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Tuple


class Mode(enum.Enum):
    REGISTRATION = "registration"
    VIO = "vio"
    SLAM = "slam"
    DRONE_VIO = "drone_vio"
    VIO_DEGRADED = "vio_degraded"


# integer mode ids: the shipped scenarios' registration order
MODE_VIO = 0
MODE_SLAM = 1
MODE_REGISTRATION = 2
MODE_DRONE_VIO = 3
MODE_VIO_DEGRADED = 4

MODE_TO_ID = {Mode.VIO: MODE_VIO, Mode.SLAM: MODE_SLAM,
              Mode.REGISTRATION: MODE_REGISTRATION,
              Mode.DRONE_VIO: MODE_DRONE_VIO,
              Mode.VIO_DEGRADED: MODE_VIO_DEGRADED}

# scenarios whose pipeline this package runs
PORTED = frozenset({Mode.VIO})


def mode_id(mode: Mode) -> int:
    return MODE_TO_ID[mode]


@dataclass(frozen=True)
class Environment:
    gps_available: bool
    map_available: bool
    # extended Fig. 2 axes (defaults reproduce the paper's 2x2 grid)
    gps_degraded: bool = False   # intermittent/low-quality GPS reception
    airborne: bool = False       # drone platform (the paper's 2nd prototype)

    @property
    def name(self) -> str:
        a = "outdoor" if self.gps_available else "indoor"
        b = "known" if self.map_available else "unknown"
        tags = (["degraded"] if self.gps_degraded else []) \
            + (["airborne"] if self.airborne else [])
        return "-".join([a, b] + tags)


@dataclass(frozen=True)
class EnvRule:
    """A conjunction of the environment booleans a scenario claims
    (None = don't care) and its priority."""
    gps: Optional[bool] = None
    map: Optional[bool] = None
    degraded: Optional[bool] = None
    airborne: Optional[bool] = None
    priority: int = 0

    def conditions(self) -> Tuple[Tuple[str, bool], ...]:
        return tuple((k, v) for k, v in (
            ("gps", self.gps), ("map", self.map),
            ("degraded", self.degraded), ("airborne", self.airborne))
            if v is not None)


# the shipped specs' rules, in registration (mode id) order
RULES = {
    Mode.VIO: EnvRule(gps=True, priority=20),
    Mode.SLAM: EnvRule(priority=0),
    Mode.REGISTRATION: EnvRule(gps=False, map=True, priority=10),
    Mode.DRONE_VIO: EnvRule(gps=False, airborne=True, priority=40),
    Mode.VIO_DEGRADED: EnvRule(gps=True, degraded=True, priority=30),
}


def select_mode(env: Environment) -> Mode:
    """Resolve the environment to its scenario: the highest-priority
    rule whose conditions all hold."""
    flags = {"gps": env.gps_available, "map": env.map_available,
             "degraded": env.gps_degraded, "airborne": env.airborne}
    chosen = None
    for mode, rule in sorted(RULES.items(), key=lambda kv: kv[1].priority):
        if all(bool(flags[k]) == v for k, v in rule.conditions()):
            chosen = mode
    return chosen


def require_ported(env: Environment) -> Mode:
    """``select_mode``, raising for a scenario this package does not run
    yet (it is never run as another scenario)."""
    mode = select_mode(env)
    if mode not in PORTED:
        raise ValueError(
            f"environment {env.name!r} resolves to scenario "
            f"{mode.value!r}, which is not yet ported to repro_torch "
            f"(ported: {sorted(m.value for m in PORTED)})")
    return mode
