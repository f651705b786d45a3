"""Host-side checkpoint of the batched simulator, in the JAX package's
file format, so a run saved by either package resumes in the other.

A `State` is a tree of dense tensors and the simulation is a pure
function of `(cfg, state, t)`, so a checkpoint is the flattened tree
plus the absolute tick: save both, reload in any process (same cfg),
continue from `t`, bit-identical to a run that never stopped. Metrics
ride along optionally.

Format: one `.npz` with dot-separated field paths as keys
(`state.nodes.term`, `metrics.hist`), numpy dtypes as the JAX package
holds them (the u32 digests as uint32), and the metadata scalars
`__version__`, `__tick__` and, when a cfg is given, `__cfg__` (the
config's `dataclasses.asdict` as sorted JSON bytes).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.clients.state import ClientState
from raft_tpu_torch.config import (LAYOUT_FIELDS, NARROW_FIELDS,
                                   STREAM_FIELDS, RaftConfig)
from raft_tpu_torch.sim import state as state_mod
from raft_tpu_torch.sim.run import Metrics
from raft_tpu_torch.sim.state import I32, U32, Mailbox, PerNode, State

_VERSION = 1


def iter_named_leaves(tree, prefix: str = ""):
    """(dot-path, leaf) over a NamedTuple tree, skipping None subtrees
    (the optional slots of a feature that is off): the naming rule of
    checkpoint keys."""
    if tree is None:
        return
    if hasattr(tree, "_fields"):   # NamedTuple node
        for f in tree._fields:
            yield from iter_named_leaves(getattr(tree, f), f"{prefix}{f}.")
    else:
        yield prefix[:-1], tree


def _flatten(prefix: str, obj, out: dict):
    for name, leaf in iter_named_leaves(obj, prefix):
        out[name] = state_mod._torch_to_np(leaf)


def save(path, st: State, t: int, metrics: Optional[Metrics] = None,
         cfg: Optional[RaftConfig] = None) -> None:
    """Write `st` (and optional metrics) and the absolute tick `t` to
    `path`. Pass `cfg` to embed the semantic config: `load` then refuses
    to resume under a different one. A state whose narrow-overflow
    latch fired is refused."""
    flat: dict = {"__version__": np.int64(_VERSION), "__tick__": np.int64(t)}
    if cfg is not None:
        state_mod.check_narrow_overflow(cfg, st)
        flat["__cfg__"] = np.bytes_(
            json.dumps(dataclasses.asdict(cfg), sort_keys=True))
    _flatten("state.", st, flat)
    if metrics is not None:
        _flatten("metrics.", metrics, flat)
    np.savez(path, **flat)


def _optional_fields(cls) -> frozenset:
    """Fields whose NamedTuple default is None: the subtrees `save`
    skips when their feature is off."""
    return frozenset(f for f in cls._fields
                     if cls._field_defaults.get(f, "required") is None)


def _load_nt(z, prefix: str, cls, device):
    """A NamedTuple from the file's `prefix` keys. An optional field that
    is absent loads as None; any other missing field raises, naming
    it."""
    optional = _optional_fields(cls)

    def get(f):
        key = f"{prefix}{f}"
        if key not in z.files:
            if f in optional:
                return None
            raise KeyError(f"checkpoint missing field {key!r}")
        return state_mod._np_to_torch(z[key], device)
    return cls(**{f: get(f) for f in cls._fields})


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _hop_narrow(cfg: RaftConfig, st: State) -> State:
    """Re-declare a loaded State at the cfg's resident dtypes, by leaf
    name, both ways: a wide file narrows under a narrow cfg, a narrow
    file widens under a wide one. A leaf at a dtype that is neither the
    wide form nor its own narrow dtype refuses, naming the leaf; a wide
    value that does not fit the target narrow dtype refuses too."""
    allowed = state_mod.full_narrow_spec(cfg)

    def leaf(name, a):
        if a.dtype in (I32, U32, torch.bool):
            return a
        dt = allowed.get(name)
        if dt is not None and a.dtype == dt:
            return a.to(I32)   # exact: zero/sign-extend
        raise ValueError(
            f"checkpoint leaf state.{name} has dtype "
            f"{_dtype_name(a.dtype)}, which is neither the wide form nor "
            f"its narrow-native dtype "
            f"({None if dt is None else _dtype_name(dt)}) — refusing the "
            f"narrow-axis hop")

    out = state_mod.narrow_state(cfg, state_mod._map_named(st, "", leaf))
    state_mod.check_narrow_overflow(cfg, out)
    return out


def _check_cfg(z, cfg: RaftConfig) -> None:
    """Refuse a file whose embedded config differs from `cfg` in a
    semantic field. Fields the file predates take their defaults; the
    layout, residency and narrow dials are not compared."""
    saved = json.loads(bytes(z["__cfg__"]).decode())
    want = json.loads(json.dumps(dataclasses.asdict(cfg)))
    defaults = json.loads(json.dumps(dataclasses.asdict(RaftConfig())))
    for k, v in defaults.items():
        saved.setdefault(k, v)
    for k in LAYOUT_FIELDS + STREAM_FIELDS + NARROW_FIELDS:
        saved.pop(k, None)
        want.pop(k, None)
    if saved != want:
        diff = {k: (saved.get(k), want.get(k))
                for k in set(saved) | set(want)
                if saved.get(k) != want.get(k)}
        raise ValueError(f"checkpoint cfg mismatch: {diff}")


def _load_metrics(z, clients: bool, device) -> Optional[Metrics]:
    if "metrics.committed" not in z.files:
        return None
    md = {f: state_mod._np_to_torch(z[f"metrics.{f}"], device)
          for f in Metrics._fields if f"metrics.{f}" in z.files}
    if "safety" not in md:
        # A file from before the safety fold: the resumed AND starts clean.
        md["safety"] = torch.ones_like(md["committed"])
    client_lanes = ("client_acked", "client_retries", "client_hist",
                    "client_max_lat")
    if clients:
        # A client universe whose file predates the SLO lanes resumes
        # with zeroed lanes (acked/retries are recomputed from the
        # client state every tick).
        md.setdefault("client_acked", torch.zeros_like(md["committed"]))
        md.setdefault("client_retries", torch.zeros_like(md["committed"]))
        md.setdefault("client_hist", torch.zeros_like(md["hist"]))
        md.setdefault("client_max_lat",
                      torch.zeros((), dtype=md["hist"].dtype, device=device))
    else:
        for f in client_lanes:
            md.setdefault(f, None)
    missing = set(Metrics._fields) - set(md)
    if missing:
        raise KeyError(f"checkpoint missing metric field(s) "
                       f"{sorted(missing)}")
    return Metrics(**md)


def load(path, cfg: Optional[RaftConfig] = None, device="cuda", mesh=None
         ) -> Tuple[State, int, Optional[Metrics]]:
    """Read (state, tick, metrics-or-None) from `path` onto `device`.

    If `cfg` is given and the file embeds one, they must match in every
    semantic field (a `ValueError` names the difference), and the State
    is re-declared at the cfg's narrow or wide dtypes.

    With `mesh` (`parallel.mesh.make_mesh`), the State comes back as its
    shards, shard j on `mesh[j]` (`parallel.mesh.shard_state`), and the
    metrics whole on the mesh's first device: a file written by a run on
    one device continues sharded (the JAX package's `sharding=`), as the
    file holds no device layout and `State.group_id` travels with each
    shard. The drivers of `parallel.kmesh` and `parallel.mesh` take the
    shards as they are."""
    if mesh is not None:
        from raft_tpu_torch.parallel.mesh import make_mesh, shard_state
        mesh = make_mesh(devices=mesh)
        st, t, metrics = load(path, cfg, device="cpu")
        return (shard_state(st, mesh), t,
                None if metrics is None else state_mod._map_named(
                    metrics, "", lambda _, a: a.to(mesh[0])))
    device = torch.device(device)
    with np.load(path) as z:
        version = int(z["__version__"])
        if version != _VERSION:
            raise ValueError(f"unsupported checkpoint version {version}")
        if cfg is not None and "__cfg__" in z.files:
            _check_cfg(z, cfg)
        t = int(z["__tick__"])
        clients = None
        if "state.clients.done" in z.files:
            clients = _load_nt(z, "state.clients.", ClientState, device)
        st = State(
            nodes=_load_nt(z, "state.nodes.", PerNode, device),
            mailbox=_load_nt(z, "state.mailbox.", Mailbox, device),
            alive_prev=state_mod._np_to_torch(z["state.alive_prev"], device),
            group_id=state_mod._np_to_torch(z["state.group_id"], device),
            clients=clients)
        if cfg is not None:
            st = _hop_narrow(cfg, st)
        metrics = _load_metrics(z, clients is not None, device)
    return st, t, metrics
