"""Role constants of a Raft replica, as the batched tick encodes them.

Only the constants are ported. The CPU oracle `Node` class of the JAX
package (its one-group reference implementation) is not part of this
package.
"""

FOLLOWER, CANDIDATE, LEADER, PRECANDIDATE = 0, 1, 2, 3
NO_VOTE = -1
