"""Nemesis programs: declarative gray-failure and storage-pressure
clauses (`program`), and the coverage-guided search with its shrinker
and reproducer artifacts (`search`; it imports the engines, so it is not
imported here: `sim.step -> nemesis.program` must not become a cycle)."""

from raft_tpu_torch.nemesis.program import (KIND_NAMES, Clause, clock_skew,
                                            compaction_pressure, crash_storm,
                                            describe, disk_full_follower,
                                            flaky_link, from_json, gray_mix,
                                            partition_wave, pressure_mix,
                                            program, program_hash,
                                            slow_follower, to_json,
                                            wan_delay)

__all__ = ["KIND_NAMES", "Clause", "clock_skew", "compaction_pressure",
           "crash_storm", "describe", "disk_full_follower", "flaky_link", "from_json",
           "gray_mix", "partition_wave", "pressure_mix", "program",
           "program_hash", "slow_follower", "to_json", "wan_delay"]
