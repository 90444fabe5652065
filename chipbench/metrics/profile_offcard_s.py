"""profile_offcard_s: seconds the planner's profiling spent measuring on
lanes off the card (the port's planner.measure_s.cpu counter)."""
from chipbench import port_spans


def read(rec: dict):
    return (port_spans.port_counters() or {}).get("planner.measure_s.cpu")
