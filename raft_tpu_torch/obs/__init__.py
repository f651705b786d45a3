"""Observability: the flight recorder (`recorder.py`)."""
