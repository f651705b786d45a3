"""Observability over the plain tick and the CUDA kernel:

- `recorder.py`: the flight recorder, a ring of per-tick per-group
  aggregates that both engines write;
- `triage.py`: divergence bisection of two engines and the differential
  against the CPU oracle;
- `manifest.py`: run manifests, one JSONL provenance record per measured
  run (config hash, versions, card and power limit, roofline stamp), and
  the key registries every record carries;
- `roofline.py`: the least time one H100 could take for a run, by bytes
  (from `analysis.bytemodel`) and by the run's own integer operations
  (`run_ops`), and the share of it a measured run attains;
- `trace.py`: Chrome trace-event spans (one per kernel launch, device
  time included) and the JSONL heartbeat of long runs;
- `history.py`: the manifest's rates as one trajectory with a regression
  gate (`scripts/torch_bench_history.py`).

The modules are imported by name (`from raft_tpu_torch.obs import
trace`); this package imports none of them itself.
"""
