"""The flagship entry's universe at the headline width: every fault
class and every protocol feature (__graft_entry__.py: seed 1, drop 0.05,
crash 0.2/8, partition 0.2/8, PreVote, reads every 8 ticks, membership
change 0.3/16, transfer 0.3/16) at k=5, L=32, E=4. The port's plain tick
against the JAX package's, full State after every tick, tolerance 0,
each feature shown to fire. A file of its own: the reference tick's
compile at k=5 with every feature on is most of its time."""

from __future__ import annotations

from test_torch_features import check_every_tick

FLAGSHIP = dict(n_groups=8, seed=1, drop_prob=0.05, crash_prob=0.2,
                crash_epoch=8, partition_prob=0.2, partition_epoch=8,
                prevote=True, read_every=8, reconfig_prob=0.3,
                reconfig_epoch=16, transfer_prob=0.3, transfer_epoch=16)


def test_flagship_tick_matches_jax_every_tick():
    check_every_tick("flagship_k5", FLAGSHIP, 160,
                     ("prevote", "transfer", "membership", "reads", "term"))
