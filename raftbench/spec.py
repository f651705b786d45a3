"""`BENCHMARK.json` and the data files it names, resolved by name.

A cell (an entry of `workloads`) names a configuration and a traffic mix.
The configuration's file (its `BENCHMARK.json` entry's `file`) holds the
deployment: `groups_per_chip` and the semantic `RaftConfig` fields under
`raft`. The traffic's file, `traffic/<traffic>.json`, holds the load:
more `raft` fields (commands, clients, faults), the universe's ticks and
flight ring. A cell's universe is the two `raft` groups merged (a key in
both is refused), plus its seed (`universe_seeds`).

The layout, residency and narrow dials (`LAYOUT_FIELDS`, `STREAM_FIELDS`,
`NARROW_FIELDS`) are the program's choice: neither file may set them.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from raftbench.reference import config as ref_config

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent

DIALS = (ref_config.LAYOUT_FIELDS + ref_config.STREAM_FIELDS
         + ref_config.NARROW_FIELDS)
SEMANTIC = tuple(f.name for f in dataclasses.fields(ref_config.RaftConfig)
                 if f.name not in DIALS + ("n_groups", "seed"))
TRAFFIC_KEYS = ("why", "raft", "ticks_per_universe", "flight_ring")
# The universe seeds a run cycles through. One seed gives every universe
# of a run a common offset (the kernel's time moves by about 1% from one
# seed to another at 100K groups); seven, in turn, average it out, and
# the reference runs each seed's judged groups as one batch.
SEEDS_PER_RUN = 7


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    chips: int
    groups: int          # groups of one universe, over all its chips
    ticks: int           # ticks of one universe, from tick 0
    ring: int            # flight-recorder rows
    fields: dict         # the semantic RaftConfig fields, seed excluded
    end_to_end: tuple    # the cell's end-to-end metric entries
    per_layer: tuple     # the cell's per-layer metric entries

    def raft_fields(self, seed: int) -> dict:
        """The RaftConfig keyword arguments of a universe of this cell
        with the universe seed `seed` (`universe_seeds`)."""
        return dict(self.fields, seed=seed)


def config_seed(seed: int) -> int:
    """A run's `--seed` as a u32, the width both engines fold it to."""
    return int(seed) % 2 ** 32


def universe_seeds(seed: int) -> list:
    """The `SEEDS_PER_RUN` universe seeds of a run's `--seed` (u32s,
    drawn from it); universe u takes the (u mod SEEDS_PER_RUN)-th."""
    rng = np.random.default_rng([config_seed(seed), 0x5EED5])
    return [int(s) for s in rng.integers(0, 2 ** 32, SEEDS_PER_RUN,
                                         dtype=np.uint64)]


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def config_file(bench: dict, name: str) -> dict:
    entry = {c["name"]: c for c in bench["configs"]}[name]
    return _json(ROOT / entry["file"])


def traffic_file(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def _raft(group: dict, where: str) -> dict:
    bad = sorted(set(group) - set(SEMANTIC))
    if bad:
        raise ValueError(f"{where}: {bad} are not semantic RaftConfig "
                         f"fields (the dials are the program's choice)")
    return dict(group)


def _for_cell(metrics: list, cell: str) -> tuple:
    return tuple(m for m in metrics
                 if "workloads" not in m or cell in m["workloads"])


def cell(name: str, bench: dict | None = None) -> Cell:
    """The cell `name` of `BENCHMARK.json`, resolved through its files."""
    bench = load_benchmark() if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    conf = config_file(bench, w["config"])
    traffic = traffic_file(w["traffic"])
    extra = sorted(set(traffic) - set(TRAFFIC_KEYS))
    if extra:
        raise ValueError(f"traffic {w['traffic']}: unknown keys {extra}")
    a = _raft(conf["raft"], f"config {w['config']}")
    b = _raft(traffic["raft"], f"traffic {w['traffic']}")
    both = sorted(set(a) & set(b))
    if both:
        raise ValueError(f"{name}: {both} set by both the config and the "
                         f"traffic")
    return Cell(name=name, config=w["config"], traffic=w["traffic"],
                chips=int(w["chips"]),
                groups=int(conf["groups_per_chip"]) * int(w["chips"]),
                ticks=int(traffic["ticks_per_universe"]),
                ring=int(traffic["flight_ring"]), fields={**a, **b},
                end_to_end=_for_cell(bench["end_to_end"], name),
                per_layer=_for_cell(bench["per_layer"], name))
