"""Fault tolerance (port of ``repro.ft``)."""
from repro_torch.ft.failures import FleetMonitor, Heartbeat

__all__ = ["Heartbeat", "FleetMonitor"]
