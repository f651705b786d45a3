"""The counter-based hashes on torch tensors, bit-identical to the JAX
package's uint32 lanes.

torch has no usable uint32 arithmetic on every device (no `>>`, `%`,
`<` or `+` for uint32 on the CPU build), so a u32 value is carried in
int64 and masked back to 32 bits after every add and multiply. Shifts
of a non-negative int64 are logical, comparisons are then unsigned, and
a multiply by a 32-bit constant is split in two 16-bit halves so no
intermediate leaves int64's range (`_mulc`).

Every function takes tensors or Python ints and broadcasts like an
elementwise op. Hashes come back as int64 in [0, 2**32); draws that are
int32 in the state (deadlines, payloads) come back as int32.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.utils import rng as _r

MASK = 0xFFFFFFFF
_C1 = 0x7FEB352D
_C2 = 0x846CA68B


def _u32(x):
    """A value as u32-in-int64: int32 lanes wrap to their two's
    complement bits, Python ints are masked."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK
    return int(x) & MASK


def _mulc(x, c: int):
    """(x * c) mod 2**32 for x in [0, 2**32) and a 32-bit constant c,
    with every intermediate below 2**49."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def mix32(x):
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mulc(x, _C1)
    x = x ^ (x >> 15)
    x = _mulc(x, _C2)
    x = x ^ (x >> 16)
    return x


def hash_u32(*vals):
    """Fold the arguments in order: h = mix32(h * GOLD + v)."""
    h = _r.SEED0
    for v in vals:
        h = mix32(_mulc(h, _r.GOLD) + _u32(v))
    return h


def _i32(x):
    """A value in int32 range as an int32 tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32)
    return torch.tensor(x, dtype=torch.int32)


def _zeros_bool(*coords):
    shapes, device = [], None
    for c in coords:
        if isinstance(c, torch.Tensor):
            shapes.append(c.shape)
            device = c.device if device is None else device
    return torch.zeros(torch.broadcast_shapes(*shapes), dtype=torch.bool,
                       device=device)


def _ones_bool(*coords):
    return ~_zeros_bool(*coords)


def election_deadline(seed, g, node, draws, election_min, election_range):
    r = hash_u32(seed, _r.TAG_TIMEOUT, g, node, draws) % election_range
    return _i32(election_min + r)


def link_dropped(seed, g, tick, src, dst, drop_u32: int):
    if drop_u32 == 0:
        return _zeros_bool(g, tick, src, dst)
    return hash_u32(seed, _r.TAG_DROP, g, tick, src, dst) < drop_u32


def node_alive(seed, g, node, tick, crash_u32: int, crash_epoch: int):
    if crash_u32 == 0:
        return _ones_bool(g, node, tick)
    epoch = _u32(tick) // crash_epoch
    return hash_u32(seed, _r.TAG_CRASH, g, node, epoch) >= crash_u32


def link_partitioned(seed, g, tick, src, dst, partition_u32: int,
                     partition_epoch: int):
    if partition_u32 == 0:
        return _zeros_bool(g, tick, src, dst)
    epoch = _u32(tick) // partition_epoch
    active = hash_u32(seed, _r.TAG_PART, g, epoch) < partition_u32
    side_src = hash_u32(seed, _r.TAG_PART_SIDE, g, epoch, src) & 1
    side_dst = hash_u32(seed, _r.TAG_PART_SIDE, g, epoch, dst) & 1
    return active & (side_src != side_dst)


def client_payload(seed, g, term, index):
    # 30-bit: the membership-change flag bit stays clear.
    return _i32(hash_u32(seed, _r.TAG_CMD, g, term, index) & 0x3FFFFFFF)


def reconfig_fires(seed, g, epoch, reconfig_u32: int):
    if reconfig_u32 == 0:
        return _zeros_bool(g, epoch)
    return hash_u32(seed, _r.TAG_RECONFIG, g, epoch) < reconfig_u32


def reconfig_target(seed, g, epoch, k: int):
    return _i32(hash_u32(seed, _r.TAG_RECONFIG_NODE, g, epoch) % k)


def transfer_fires(seed, g, epoch, transfer_u32: int):
    if transfer_u32 == 0:
        return _zeros_bool(g, epoch)
    return hash_u32(seed, _r.TAG_TRANSFER, g, epoch) < transfer_u32


def transfer_target(seed, g, epoch, k: int):
    return _i32(hash_u32(seed, _r.TAG_TRANSFER_NODE, g, epoch) % k)


def digest_update(digest, index, payload):
    return mix32(_mulc(_u32(digest), _r.GOLD)
                 + mix32(_mulc(_u32(index), _r.GOLD) + _u32(payload)))
