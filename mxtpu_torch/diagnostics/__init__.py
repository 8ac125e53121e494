"""mxtpu_torch.diagnostics — the flight recorder and the program table.

Counterpart of ``mxtpu/diagnostics``' ``flight`` and ``programs``
modules: a lock-free ring of recent runtime events (telemetry span
starts and ends, engine pushes, fault firings, sanitizer trips) readable
without taking any lock a stuck thread might hold, the postmortem built
from it, and the cost record of every program the build seam captures.
mxtpu's device-memory ledger and hang watchdog are the observability
slice (ROADMAP A.10) and are not here yet.
"""
from __future__ import annotations

from . import flight
from .flight import (FlightRecorder, flight_enabled, last_postmortem,
                     postmortem, record, recorder, set_flight_enabled)
from .programs import (ProgramRecord, cost_enabled, latest_record,
                       program_table, programs, record_program,
                       set_cost_enabled)

__all__ = ["flight", "FlightRecorder", "recorder", "record",
           "flight_enabled", "set_flight_enabled", "postmortem",
           "last_postmortem", "ProgramRecord", "programs", "program_table",
           "record_program", "latest_record", "cost_enabled",
           "set_cost_enabled"]
