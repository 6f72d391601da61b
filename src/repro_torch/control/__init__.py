"""Adaptive runtime control plane (DESIGN.md §10).

The optimizer's cost constants, the batcher's deadline, the router's
chunking and the admission bounds are all *guesses* at deploy time; this
package closes the loop around them with three layers over the existing
versioned-handle machinery:

* :mod:`repro_torch.control.telemetry` — ``MetricsCollector``: bounded
  ring-buffer time series over engine/cache/handle/batcher/admission
  counters, sampled as interval deltas (monotonic snapshots, no racing
  of mutating fields).
* :mod:`repro_torch.control.calibrate` — ``CostCalibrator``: least-squares
  re-fit of the optimizer's per-element cost weights against measured
  execution time, per access class (scan / preagg / join, per-table).
* :mod:`repro_torch.control.knobs` — ``KnobController``: AIMD,
  hysteresis-bounded adaptation of ``max_delay_s`` / ``dispatch_rows``
  / admission bounds; every decision goes into a replayable log.
* :mod:`repro_torch.control.replan` — ``Replanner``: when calibrated costs
  flip an optimizer decision, rebuild through ``build_version`` →
  pre-warm → ``publish_version`` and auto-roll back if post-swap p99
  regresses.
* :mod:`repro_torch.control.plane` — ``ControlPlane``: one ``tick()`` =
  sample → calibrate → (maybe) replan → tune knobs → health-check.
"""
from repro_torch.control.calibrate import (CostCalibrator, CostObservation,
                                           differs_materially,
                                           plan_element_profile)
from repro_torch.control.knobs import (KnobConfig, KnobController,
                                       KnobDecision, LoadObservation)
from repro_torch.control.plane import ControlPlane
from repro_torch.control.replan import Replanner
from repro_torch.control.telemetry import MetricsCollector, RingSeries

__all__ = [
    "RingSeries", "MetricsCollector",
    "CostObservation", "CostCalibrator", "plan_element_profile",
    "differs_materially",
    "LoadObservation", "KnobConfig", "KnobDecision", "KnobController",
    "Replanner", "ControlPlane",
]
