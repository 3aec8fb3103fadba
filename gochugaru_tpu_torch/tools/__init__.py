"""Measurement scripts for the port (run on a card; the engine imports none)."""
