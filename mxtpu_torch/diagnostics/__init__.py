"""mxtpu_torch.diagnostics — the flight recorder.

Counterpart of ``mxtpu/diagnostics``' ``flight`` module: a lock-free ring
of recent runtime events (telemetry span starts and ends, engine pushes,
fault firings) readable without taking any lock a stuck thread might
hold. mxtpu's device-memory ledger, program cost table, hang watchdog
and postmortems are the observability slice (ROADMAP A.10) and are not
here yet.
"""
from __future__ import annotations

from . import flight
from .flight import (FlightRecorder, flight_enabled, record, recorder,
                     set_flight_enabled)

__all__ = ["flight", "FlightRecorder", "recorder", "record",
           "flight_enabled", "set_flight_enabled"]
