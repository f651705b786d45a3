"""Scheduled exactly-once client traffic: `state.py` (the per-(group,
sid) client state riding `State.clients`) and `workload.py` (its
elementwise transition, the submit payloads and the endpoint
exactly-once report). The replicated dedup tables are
`PerNode.session_seq`; the per-tick exactly-once clause is
`verify/invariants.py` `client_safety`."""
