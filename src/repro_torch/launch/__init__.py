"""Drivers (port of ``repro.launch``)."""
