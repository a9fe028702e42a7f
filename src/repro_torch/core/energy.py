"""Energy accounting — phase-integrated power model (paper Tab. II).

The robot's measured on-board power draw by state:
    inference  13.35 W   (full CPU/GPU utilization)
    comm        4.25 W   (radio active, talking to the GPU server)
    standby     4.04 W   (idle wait)

Per-inference energy is the integral of power over phase durations — exactly
the paper's methodology (1 s-interval power log integrated over the inference
window), applied to the simulated timeline instead of a physical power rail.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


STATE_INFERENCE = "inference"
STATE_COMM = "comm"
STATE_STANDBY = "standby"
# partial-load compute (CPU-side control, framework bookkeeping while the GPU
# server does the heavy lifting) — between comm and full inference draw
STATE_CONTROL = "control"


@dataclasses.dataclass(frozen=True)
class PowerModel:
    """Power draw (W) per device state."""

    inference_w: float = 13.35
    comm_w: float = 4.25
    standby_w: float = 4.04
    control_w: float = 5.6

    def power(self, state: str) -> float:
        return {
            STATE_INFERENCE: self.inference_w,
            STATE_COMM: self.comm_w,
            STATE_STANDBY: self.standby_w,
            STATE_CONTROL: self.control_w,
        }[state]


@dataclasses.dataclass
class EnergyMeter:
    """Accumulates (state, duration) segments along the simulated timeline."""

    power_model: PowerModel = dataclasses.field(default_factory=PowerModel)
    seconds_by_state: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, state: str, seconds: float) -> None:
        if seconds < 0:
            raise ValueError(f"negative duration: {seconds}")
        self.seconds_by_state[state] = self.seconds_by_state.get(state, 0.0) + seconds

    @property
    def total_seconds(self) -> float:
        return sum(self.seconds_by_state.values())

    @property
    def joules(self) -> float:
        return sum(
            self.power_model.power(s) * d for s, d in self.seconds_by_state.items()
        )

    @property
    def mean_watts(self) -> float:
        t = self.total_seconds
        return self.joules / t if t > 0 else 0.0

    def snapshot(self) -> "EnergyMeter":
        return EnergyMeter(self.power_model, dict(self.seconds_by_state))

    def since(self, earlier: "EnergyMeter") -> "EnergyMeter":
        delta = {
            s: d - earlier.seconds_by_state.get(s, 0.0)
            for s, d in self.seconds_by_state.items()
            if d - earlier.seconds_by_state.get(s, 0.0) > 1e-15
        }
        return EnergyMeter(self.power_model, delta)
