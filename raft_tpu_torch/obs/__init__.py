"""Observability: the flight recorder (`recorder.py`), divergence triage
and the oracle differential (`triage.py`), and `config_hash`
(`manifest.py`)."""
