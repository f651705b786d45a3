"""Launch drivers beyond one resident launch: `mesh.py` and `kmesh.py`
shard the groups axis over a mesh of devices (`groups.py` cuts and
joins it), `cohort.py` pages the fleet's wire between host memory and
one card or every device of a mesh (`stream_sched.py` moves a window's
slices)."""
