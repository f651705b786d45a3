// Fused-chunk Raft tick for Hopper (sm_90a): `n_ticks` whole ticks of the
// batched simulation per launch, each group's state in shared memory for
// the whole launch and one lane per Raft node.
//
// Replaces the JAX package's Pallas kernel raft_tpu/sim/pkernel.py:1950
// (`_build_kernel` -> `kernel`, launched by `_prun_padded_impl` through
// `pl.pallas_call`), for the features the port carries: RequestVote,
// AppendEntries, InstallSnapshot, fire-hose commands, commit/apply/
// compaction, crash/partition/drop faults, the election-latency histogram
// and the per-tick safety fold, four protocol features — PreVote,
// leadership transfer (TimeoutNow), single-server membership change and
// scheduled ReadIndex reads — the scheduled exactly-once client traffic
// (session appends, the dedup filter, the client transition, the ack-latency
// histogram and the exactly-once safety clause), the flight-recorder ring and
// the nemesis program's seams (gray failures and storage pressure).
// It computes what `raft_tpu_torch.sim.run.run` (with a flight:
// `obs.recorder.run_recorded`) computes over the same ticks (the plain
// PyTorch tick, sim/step.py), bit for bit; chip_smoke.py holds the two equal
// on the card.
//
// Features. Each protocol feature, the clients and the nemesis program are a
// compile-time flag (FC_PREVOTE, FC_TRANSFER, FC_RECONFIG, FC_READS,
// FC_CLIENTS, FC_NEMESIS, set by kernel.py per build) guarding its code with
// `if constexpr`: the build with all six off carries none of their code or
// mailbox rows, and the launcher refuses a config whose flags differ from
// the build's. The voter set is an i32 bitmask (k <= 30) derived from the
// node's own ring by a scan of the live window, never stored. The flight
// ring is a launch parameter (its length, 0 = off): each build holds the
// kernel without and with it (a template argument; the launcher picks one).
//
// Design. The tick contract gives three properties: a node reads only its
// own state, last tick's inbox and its senders' rings as they stood at the
// start of the tick; no other node reads its state during the tick; and
// only the group-level steps after the node steps (client transition,
// metrics, the safety fold, the flight row) read every node. So:
//
// - A group is a tile of W lanes of one warp, W the smallest power of two
//   >= k (at most 32); lane i steps node i. The tile's lanes meet only at
//   tile barriers (`__syncwarp` over its mask) and warp collectives
//   (ballot, reduce, shuffle) over that mask, so tiles never wait for each
//   other. Per tick: (1) each lane copies into the next buffer the slots
//   of its node's ring that the last tick wrote (the whole ring on a
//   launch's first tick; elsewhere the two buffers' rings already agree)
//   and the tile clears the next mailbox's presence rows (every row on the
//   last tick of the launch), while each lane draws its node's aliveness,
//   partition side and nemesis bits (exchanged by ballot), restarts its own
//   node on the rising edge and draws its own delivery filter (the K drop
//   hashes of the links into it); (2) each lane steps its node: handlers in
//   canonical (type, src) order (PreVote and TimeoutNow last), then phases
//   T, C, A, editing its own ring in the next buffer and writing its outbox
//   straight into the next mailbox; (3) after a barrier, the client
//   transition by slot, then the metrics by reduction and ballot, the
//   pairwise safety fold with lane y checking its pairs, and the flight row.
// - A block holds `ng` groups, as many as the launcher's occupancy query
//   finds best for the shared memory each group needs. Each group's static
//   rows and its double-buffered rings and mailbox are loaded from the wire
//   once per launch into dynamic shared memory, every tick runs there, and
//   the group goes back to the wire once at the end: device memory sees one
//   read and one write of the wire per launch (plus the flight rows, which
//   no tick reads back and are written straight to the wire, and the
//   integer atomics into `acc`). The nemesis clause table is copied into
//   the block's shared memory once, so a program's length is bounded only by
//   shared memory.
// - Registers hold scalars only: a node's peer arrays (next, match, acks),
//   dedup tables and ring are its shared-memory rows, edited in place. A
//   dead node's step stops after phase T (its outbox is all it leaves: the
//   fields as computed, presence erased), and its peer arrays and ring are
//   never written, so its state stays frozen.
//
// Layout. The wire is an int32 [W_rows, G] tensor, structure of arrays with
// the group axis minor (row = field x node x lane, see kernel.py
// `_wire_rows`): the static rows, the flight rows, then the
// double-buffered rows (rings first, then the mailbox). In shared memory a
// group holds, at a stride `gs` (twice an odd number, so neighbouring
// groups fall in other banks): its static rows without the flight rows,
// buffer 0 and buffer 1 of the double-buffered rows (each from an even
// word), and the nemesis participation bits.
//
// In place. A null `wire_in` runs the ticks on `out` as it stands: the
// wrapper passes it for the output written over the input (`alias_wire`) and
// for the working wire the codec unpacks (csrc/wire_codec.cu), so the two
// `__restrict__` pointers never alias. The codec runs only at the launch
// boundary and never inside this kernel.
//
// What bounds it on the H100: the bytes are one read and one write of the
// wire per launch; the integer work per group-tick is a few thousand
// operations, hashing most of it. What holds it back is the latency of each
// lane's dependent chain through its node step with few groups per SM (the
// shared memory a group needs sets that count: 27 headline groups, ~7 warps
// per SM), and the lanes of a warp that take different roles' paths in
// turn. Draws that share their leading hash arguments share those folds
// (`hash_fold`). PERF.md records the measured times beside both bounds.

#include <cstdint>
#include <mutex>
#include <type_traits>
#include <cuda_runtime.h>

#ifndef FC_PREVOTE
#define FC_PREVOTE 0
#endif
#ifndef FC_TRANSFER
#define FC_TRANSFER 0
#endif
#ifndef FC_RECONFIG
#define FC_RECONFIG 0
#endif
#ifndef FC_READS
#define FC_READS 0
#endif
#ifndef FC_CLIENTS
#define FC_CLIENTS 0
#endif
#ifndef FC_NEMESIS
#define FC_NEMESIS 0
#endif

namespace {

constexpr bool PREVOTE = FC_PREVOTE != 0;
constexpr bool TRANSFER = FC_TRANSFER != 0;
constexpr bool RECONFIG = FC_RECONFIG != 0;
constexpr bool READS = FC_READS != 0;
constexpr bool CLIENTS = FC_CLIENTS != 0;
constexpr bool NEMESIS = FC_NEMESIS != 0;

constexpr int K_LIMIT = 30;        // pkernel.supported's k bound: one warp
constexpr int MAX_THREADS = 256;   // threads per block the launcher tries

constexpr uint32_t GOLD = 0x9E3779B9u;
constexpr uint32_t SEED0 = 0x243F6A88u;
constexpr uint32_t TAG_TIMEOUT = 1, TAG_DROP = 2, TAG_CRASH = 3,
                   TAG_PART = 4, TAG_PART_SIDE = 5, TAG_CMD = 6,
                   TAG_RECONFIG = 7, TAG_RECONFIG_NODE = 8, TAG_TRANSFER = 9,
                   TAG_TRANSFER_NODE = 10, TAG_CLIENT_ARRIVAL = 11,
                   TAG_CLIENT_VAL = 12, TAG_NEM_GROUP = 13, TAG_NEM_NODE = 14,
                   TAG_NEM_LINK = 15, TAG_NEM_CRASH = 16, TAG_NEM_SIDE = 17,
                   TAG_NEM_BURST = 18, TAG_NEM_DISK = 19,
                   TAG_NEM_COMPACT = 20;
// Nemesis clause kinds, and a clause's eight words.
constexpr uint32_t NEM_SLOW = 1, NEM_FLAKY = 2, NEM_WAN = 3, NEM_WAVE = 6;
enum NemWord { NK, NT0, NT1, NGROUP, NP, NA, NB, NCID, NEM_WORDS };
// The seams, in the order kernel.py groups the clauses.
enum NemSeam { NS_LINK, NS_CRASH, NS_SKEW, NS_DISK, NS_COMPACT, N_SEAMS };
constexpr int FOLLOWER = 0, CANDIDATE = 1, LEADER = 2, PRECANDIDATE = 3,
              NO_VOTE = -1;
constexpr int CONFIG_FLAG = 1 << 30;   // membership entry: low k bits voters
// Session command: sid in bits 20-28, seq in bits 10-19, value in bits 0-9.
constexpr int SESSION_FLAG = 1 << 29;
constexpr int SID_SHIFT = 20, SID_MASK = 0x1FF, SEQ_SHIFT = 10,
              SEQ_MASK = 0x3FF, VAL_MASK = 0x3FF;
constexpr int INT_MAX_ = 0x7FFFFFFF, INT_MIN_ = -INT_MAX_ - 1;

// Wire fields, in the order of kernel.py `WIRE_FIELDS`. The offsets come
// from the wrapper (-1 for a field the universe does not carry); the rings
// and the mailbox fields (F_LOG_TERM to F_IS_REQ_SNAP_SESSIONS) are
// relative to the start of the double-buffered region.
enum Field {
  F_TERM, F_VOTED_FOR, F_SNAP_INDEX, F_SNAP_TERM, F_SNAP_DIGEST,
  F_SNAP_VOTERS, F_RNG_DRAWS, F_LAST_INDEX, F_ROLE, F_LEADER_ID, F_COMMIT,
  F_APPLIED, F_DIGEST, F_VOTES, F_NEXT_INDEX, F_MATCH_INDEX,
  F_ELECTION_ELAPSED, F_HEARTBEAT_ELAPSED, F_DEADLINE, F_LEADER_ELAPSED,
  F_ACK_TIME, F_SCHED_READ_INDEX, F_SCHED_READ_REG, F_READS_DONE,
  F_ALIVE_PREV, F_GROUP_ID, F_COMMITTED, F_LEADERLESS, F_SAFETY,
  F_LOG_TERM, F_LOG_PAYLOAD,
  F_MB0,   // first mailbox field; the mailbox fields follow in Mb order
  F_IS_REQ_SNAP_SESSIONS = F_MB0 + 36,   // [K_dst, K_src, S]
  F_SESSION_SEQ, F_SNAP_SESSION_SEQ,     // [K, S]
  F_CLIENTS_DONE, F_CLIENTS_BACKLOG, F_CLIENTS_INFLIGHT, F_CLIENTS_T_START,
  F_CLIENTS_T_SUB, F_CLIENTS_SUBMIT, F_CLIENTS_RETRIES, F_CLIENTS_LAST_LAT,
  F_CLIENTS_SHED,                        // [S] each
  F_CLIENT_ACKED, F_CLIENT_RETRIES,
  F_FLIGHT_TICK, F_FLIGHT_LEADERS, F_FLIGHT_ELECTIONS, F_FLIGHT_COMMIT,
  F_FLIGHT_MSGS, F_FLIGHT_SAFETY,        // [ring] each
  N_FIELDS
};

// Mailbox fields, in the order of the Mailbox NamedTuple.
enum Mb {
  RV_REQ_PRESENT, RV_REQ_TERM, RV_REQ_LLI, RV_REQ_LLT,
  RV_RESP_PRESENT, RV_RESP_TERM, RV_RESP_GRANTED,
  AE_REQ_PRESENT, AE_REQ_TERM, AE_REQ_PREV_INDEX, AE_REQ_PREV_TERM,
  AE_REQ_N, AE_REQ_COMMIT,
  AE_RESP_PRESENT, AE_RESP_TERM, AE_RESP_SUCCESS, AE_RESP_MATCH,
  IS_REQ_PRESENT, IS_REQ_TERM, IS_REQ_SNAP_INDEX, IS_REQ_SNAP_TERM,
  IS_REQ_SNAP_DIGEST, IS_REQ_SNAP_VOTERS,
  IS_RESP_PRESENT, IS_RESP_TERM, IS_RESP_MATCH,
  PV_REQ_PRESENT, PV_REQ_TERM, PV_REQ_LLI, PV_REQ_LLT,
  PV_RESP_PRESENT, PV_RESP_TERM, PV_RESP_REQ_TERM, PV_RESP_GRANTED,
  TN_PRESENT, TN_TERM,
  N_MB
};

// Calls f(m) for each presence slot m this build's mailbox carries
// (PreVote's and TimeoutNow's only with their flags).
template <class F>
__device__ __forceinline__ void for_presence(F f) {
  f(RV_REQ_PRESENT);
  f(RV_RESP_PRESENT);
  f(AE_REQ_PRESENT);
  f(AE_RESP_PRESENT);
  f(IS_REQ_PRESENT);
  f(IS_RESP_PRESENT);
  if constexpr (PREVOTE) {
    f(PV_REQ_PRESENT);
    f(PV_RESP_PRESENT);
  }
  if constexpr (TRANSFER) f(TN_PRESENT);
}

// Parameters of the launch, in the order of kernel.py `_params`.
enum Param {
  P_G, P_K, P_L, P_E, P_SEED, P_ELECTION_MIN, P_ELECTION_RANGE,
  P_HEARTBEAT, P_COMPACT, P_CMDS, P_CRASH_U32, P_CRASH_EPOCH,
  P_PARTITION_U32, P_PARTITION_EPOCH, P_DROP_U32, P_MAJORITY, P_FULL_MASK,
  P_HIST, P_N_WORDS, P_DB_START, P_DB_WORDS, P_T0, P_N_TICKS,
  P_PREVOTE, P_TRANSFER, P_RECONFIG, P_READS, P_CLIENTS, P_NEMESIS,
  P_TRANSFER_U32,
  P_TRANSFER_EPOCH, P_RECONFIG_U32, P_RECONFIG_EPOCH, P_MIN_VOTERS,
  P_READ_EVERY, P_S, P_CLIENTS_U32, P_BACKOFF, P_CAP, P_RING,
  N_PARAMS
};

struct Args {
  int G, K, L, E;
  uint32_t seed;
  int election_min, election_range, heartbeat, compact, cmds;
  uint32_t crash_u32; int crash_epoch;
  uint32_t partition_u32; int partition_epoch;
  uint32_t drop_u32;
  int majority, full_mask, hist;
  int n_words, db_start, db_words;
  int t0, n_ticks;
  uint32_t transfer_u32; int transfer_epoch;
  uint32_t reconfig_u32; int reconfig_epoch, min_voters;
  int read_every;
  int off[N_FIELDS];
  // Members added after the offset table, so that they never move an
  // offset's place in the parameter bank.
  int S;   // client slots
  uint32_t clients_u32;
  int backoff, cap;   // client retry backoff, admission cap (0 = off)
  int ring;           // flight ring length, 0 = no flight
  // The nemesis program's clauses, grouped by seam: seam s owns clauses
  // [nem_start[s], nem_start[s + 1]) of the clause table (a device tensor,
  // eight words a clause; times clamped to [0, 2**31 - 1], the skew amount
  // its int32 bit pattern).
  int nem_start[N_SEAMS + 1];
  // The launch's shape: static rows in shared memory (the wire's static
  // rows less the flight rows), lanes per group, groups per block, the
  // group's stride in shared memory, its participation words, and where
  // its double-buffered rows start and how far apart its two buffers
  // lie (both even).
  int n_static, W, ng, gs, part_words, db0, db_pitch;
};

// ----------------------------------------------------------------- hashes

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// Folds more arguments into a hash state: hash_fold(hash_u32(a, b), c)
// == hash_u32(a, b, c), so draws that share leading arguments share
// their folds.
template <typename... T>
__device__ __forceinline__ uint32_t hash_fold(uint32_t h, T... v) {
  ((h = mix32(h * GOLD + static_cast<uint32_t>(v))), ...);
  return h;
}

// Folds its arguments in order, as utils/trng.py `hash_u32`.
template <typename... T>
__device__ __forceinline__ uint32_t hash_u32(T... v) {
  return hash_fold(SEED0, v...);
}

__device__ __forceinline__ uint32_t digest_update(uint32_t d, int idx,
                                                  int payload) {
  return mix32(d * GOLD +
               mix32(static_cast<uint32_t>(idx) * GOLD +
                     static_cast<uint32_t>(payload)));
}

// Floor mod of x by L (a mask when L is a power of two, as the default
// log_cap is: an integer division costs tens of instructions).
__device__ __forceinline__ int mod_l(int x, int L) {
  if ((L & (L - 1)) == 0) return x & (L - 1);
  int r = x % L;
  return r < 0 ? r + L : r;
}

// Floor-mod ring slot of absolute index idx: index 0 maps to L - 1.
__device__ __forceinline__ int slot_of(int idx, int L) {
  return mod_l(idx - 1, L);
}

// ---------------------------------------------------------------- the tile

// A group's lanes: W consecutive lanes of one warp, lane i stepping node i
// (lanes i >= K take part in the collectives only). Every collective runs
// over the tile's mask, in control flow that is uniform over the tile.
struct Tile {
  unsigned mask;   // the tile's lanes in its warp
  int base;        // its first lane in the warp
  int w;           // its width W
  int i;           // this lane's node
};

__device__ __forceinline__ void tile_sync(const Tile& t) {
  __syncwarp(t.mask);
}
// Bit n: lane n's predicate.
__device__ __forceinline__ unsigned tile_ballot(const Tile& t, bool p) {
  return (__ballot_sync(t.mask, p) & t.mask) >> t.base;
}
__device__ __forceinline__ bool tile_all(const Tile& t, bool p) {
  return __all_sync(t.mask, p) != 0;
}
__device__ __forceinline__ int tile_max(const Tile& t, int v) {
  return __reduce_max_sync(t.mask, v);
}
__device__ __forceinline__ int tile_sum(const Tile& t, int v) {
  return __reduce_add_sync(t.mask, v);
}
// Lane `src`'s value.
__device__ __forceinline__ uint32_t tile_shfl(const Tile& t, uint32_t v,
                                              int src) {
  return __shfl_sync(t.mask, v, src, t.w);
}

// ------------------------------------------------------------- node state

// A group's rows in shared memory, by field (offsets from Args).
struct Group {
  const Args& a;
  const uint32_t* nem;   // the clause table, NEM_WORDS a clause
  int* st;               // the static rows
  const int* cur;        // double-buffered rows, start of this tick
  int* nxt;              // double-buffered rows, end of this tick
  uint32_t gid;
  uint32_t h_timeout;    // hash_u32(seed, TAG_TIMEOUT, gid, this lane)

  __device__ int& s(int f, int r) const { return st[a.off[f] + r]; }
  __device__ int c(int f, int r) const { return cur[a.off[f] + r]; }
  __device__ int& x(int f, int r) const { return nxt[a.off[f] + r]; }
  __device__ uint32_t clause(int j, int w) const {
    return nem[NEM_WORDS * j + w];
  }
};

// Scheduled-read lanes: part of a node's working state only in a build
// with reads on.
struct ReadLanes {
  int* ack;   // last current-term response tick, by peer (shared)
  int sri, srr, rdone;   // read point (-1 none), registration tick, count
};
struct NoReadLanes {};

// Dedup tables, shared rows: part of a node's working state only with
// clients on.
struct SessLanes {
  int* sess;        // the live table
  int* snap_sess;   // the snapshot's table
};
struct NoSessLanes {};

// A node's scalars in registers and its rows in shared memory: the peer
// arrays in the static rows, the ring in the next buffer.
struct Node : std::conditional_t<READS, ReadLanes, NoReadLanes>,
              std::conditional_t<CLIENTS, SessLanes, NoSessLanes> {
  int term, voted_for, snap_index, snap_term;
  uint32_t snap_digest;
  int snap_voters, rng_draws, last_index, role, leader_id, commit, applied;
  uint32_t digest;
  unsigned votes;   // bit p = vote granted by p
  int ee, hb, deadline, le;
  int* next;
  int* match;
  int* lt;   // own ring, terms
  int* lp;   // own ring, payloads
  int wlo, whi;   // lowest and highest index written to the ring this tick
  bool live;   // alive this tick: a dead node writes no row but its outbox
};

// The group's nemesis lanes (nemesis builds only): which clauses the group
// takes part in (bit j % 32 of word j / 32, once per launch) and which
// nodes' disks are full this tick (bit = node).
struct NemLanes {
  const unsigned* part;
  unsigned full;
};
struct NoNemLanes {};
using Nem = std::conditional_t<NEMESIS, NemLanes, NoNemLanes>;

// The deadline of draw `draws` of this lane's node:
// hash_u32(seed, TAG_TIMEOUT, gid, i, draws), from the lane's prefix.
__device__ __forceinline__ int election_deadline(const Args& a,
                                                 uint32_t h_timeout,
                                                 int draws) {
  uint32_t r = hash_fold(h_timeout, draws) %
               static_cast<uint32_t>(a.election_range);
  return static_cast<int>(static_cast<uint32_t>(a.election_min) + r);
}

// ------------------------------------------------------------ nemesis seams
// (templates over the lanes' type: a build without nemesis never
// instantiates them)

template <class NM>
__device__ __forceinline__ bool nem_active(const Group& gr, const NM& nm,
                                           int j, uint32_t tu) {
  return ((nm.part[j >> 5] >> (j & 31)) & 1u) && tu >= gr.clause(j, NT0) &&
         tu < gr.clause(j, NT1);
}

// The participation words: bit j, hash(seed, TAG_NEM_GROUP, cid, g) <
// group_u32, a word per lane in turn.
__device__ __forceinline__ void nem_participate(
    const Group& gr, const Tile& t, unsigned* part) {
  const int n = gr.a.nem_start[N_SEAMS];
  for (int w = t.i; w < gr.a.part_words; w += t.w) {
    unsigned bits = 0;
    for (int j = 32 * w; j < n && j < 32 * w + 32; ++j)
      if (hash_u32(gr.a.seed, TAG_NEM_GROUP, gr.clause(j, NCID), gr.gid) <
          gr.clause(j, NGROUP))
        bits |= 1u << (j - 32 * w);
    part[w] = bits;
  }
}

// Bit s: an active link clause drops s -> d this tick, d the lane's node.
// Every lane of the tile calls it (the WAN and wave clauses exchange their
// per-node draws).
template <class NM>
__device__ __forceinline__ unsigned nem_blk(
    const Group& gr, const Tile& t, const NM& nm, uint32_t tu) {
  const Args& a = gr.a;
  const int K = a.K, d = t.i;
  const uint32_t k = static_cast<uint32_t>(K), gid = gr.gid;
  unsigned blk = 0;
  for (int j = a.nem_start[NS_LINK]; j < a.nem_start[NS_LINK + 1]; ++j) {
    if (!nem_active(gr, nm, j, tu)) continue;
    const uint32_t kind = gr.clause(j, NK), cid = gr.clause(j, NCID),
                   A = gr.clause(j, NA), B = gr.clause(j, NB);
    unsigned hit = 0;   // bit s: the link s -> d is hit
    if (kind == NEM_SLOW) {
      const int target =
          static_cast<int>(hash_u32(a.seed, TAG_NEM_NODE, cid, gid) % k);
      for (int s = 0; s < K; ++s)
        if (((A & 1u) && s == target) || ((A & 2u) && d == target))
          hit |= 1u << s;
    } else if (kind == NEM_FLAKY) {
      if (K < 2) continue;   // a 1-node group has no links
      const uint32_t s0 = hash_u32(a.seed, TAG_NEM_NODE, cid, gid, 0u) % k;
      const uint32_t d0 =
          (s0 + 1u + hash_u32(a.seed, TAG_NEM_NODE, cid, gid, 1u) % (k - 1u)) %
          k;
      if (hash_u32(a.seed, TAG_NEM_BURST, cid, gid, tu / A) < B &&
          static_cast<uint32_t>(d) == d0)
        hit |= 1u << s0;
    } else if (kind == NEM_WAN) {
      const uint32_t site = hash_u32(a.seed, TAG_NEM_NODE, cid, gid, d) % A;
      for (int s = 0; s < K; ++s)
        if (tile_shfl(t, site, s) != site) hit |= 1u << s;
    } else {   // NEM_WAVE: inside the sweeping window, cross-side links
      if ((tu + gid) % A >= B) continue;
      const unsigned side = tile_ballot(
          t, hash_u32(a.seed, TAG_NEM_SIDE, cid, gid, tu / A, d) & 1u);
      for (int s = 0; s < K; ++s)
        if (((side >> s) ^ (side >> d)) & 1u) hit |= 1u << s;
    }
    // the link draw, on the links hit
    const uint32_t h_link = hash_u32(a.seed, TAG_NEM_LINK, cid, gid, tu);
    for (int s = 0; s < K; ++s)
      if (s != d && ((hit >> s) & 1u) &&
          hash_fold(h_link, s, d) < gr.clause(j, NP))
        blk |= 1u << s;
  }
  return blk;
}

// A crash storm holds node n down this tick.
template <class NM>
__device__ __forceinline__ bool nem_down(
    const Group& gr, const NM& nm, uint32_t tu, int n) {
  const Args& a = gr.a;
  for (int j = a.nem_start[NS_CRASH]; j < a.nem_start[NS_CRASH + 1]; ++j)
    if (nem_active(gr, nm, j, tu) &&
        hash_u32(a.seed, TAG_NEM_CRASH, gr.clause(j, NCID), gr.gid, n,
                 tu / gr.clause(j, NA)) < gr.clause(j, NP))
      return true;
  return false;
}

// The nodes whose disk is full this tick: each clause's target node,
// during the sub-epochs that fire.
template <class NM>
__device__ __forceinline__ unsigned nem_full(
    const Group& gr, const NM& nm, uint32_t tu) {
  const Args& a = gr.a;
  unsigned full = 0;
  for (int j = a.nem_start[NS_DISK]; j < a.nem_start[NS_DISK + 1]; ++j) {
    if (!nem_active(gr, nm, j, tu)) continue;
    const uint32_t cid = gr.clause(j, NCID);
    if (hash_u32(a.seed, TAG_NEM_DISK, cid, gr.gid, tu / gr.clause(j, NA)) <
        gr.clause(j, NP))
      full |= 1u << (hash_u32(a.seed, TAG_NEM_NODE, cid, gr.gid) %
                     static_cast<uint32_t>(a.K));
  }
  return full;
}

template <class NM>
__device__ __forceinline__ bool nem_compact_block(
    const Group& gr, const NM& nm, int i, uint32_t tu) {
  const Args& a = gr.a;
  for (int j = a.nem_start[NS_COMPACT]; j < a.nem_start[NS_COMPACT + 1]; ++j)
    if (nem_active(gr, nm, j, tu) &&
        hash_u32(a.seed, TAG_NEM_COMPACT, gr.clause(j, NCID), gr.gid, i,
                 tu / gr.clause(j, NA)) < gr.clause(j, NP))
      return true;
  return false;
}

// A deadline drawn by node i at tick tu, shifted by the active skew
// clauses (the signed amounts summed in int32) and clamped at 1.
template <class NM>
__device__ __forceinline__ int nem_skewed(
    const Group& gr, const NM& nm, int i, uint32_t tu, int deadline) {
  const Args& a = gr.a;
  if (a.nem_start[NS_SKEW] == a.nem_start[NS_SKEW + 1]) return deadline;
  uint32_t extra = 0;
  for (int j = a.nem_start[NS_SKEW]; j < a.nem_start[NS_SKEW + 1]; ++j)
    if (nem_active(gr, nm, j, tu) &&
        hash_u32(a.seed, TAG_NEM_NODE, gr.clause(j, NCID), gr.gid, i) <
            gr.clause(j, NP))
      extra += gr.clause(j, NA);
  return max(1, static_cast<int>(static_cast<uint32_t>(deadline) + extra));
}

// -------------------------------------------------------- node helpers

__device__ __forceinline__ int term_at(const Node& n, int idx, int L) {
  return idx == n.snap_index ? n.snap_term : n.lt[slot_of(idx, L)];
}

// The one writer of a node's ring: entry idx takes `term`, and `payload`
// too unless `term_only`. It widens [wlo, whi], the indices this tick
// wrote, which are all that the next tick's `ring_sync` copies.
__device__ __forceinline__ void put_entry(Node& n, int idx, int L, int term,
                                          int payload, bool term_only) {
  const int sl = slot_of(idx, L);
  n.lt[sl] = term;
  if (!term_only) n.lp[sl] = payload;
  n.wlo = min(n.wlo, idx);
  n.whi = max(n.whi, idx);
}

// The ring slots of the indices [lo, hi]: at most L, none when hi < lo.
__device__ __forceinline__ int span_slots(int lo, int hi, int L) {
  return hi < lo ? 0 : min(hi - lo + 1, L);
}

// Node i's ring in the next buffer brought up to date with the current
// buffer: only the slots of the indices [lo, hi] that the last tick wrote
// (into what is now the current buffer) differ between the two, so
// copying them leaves what a copy of the whole ring would. A launch's
// first tick passes L indices: its next buffer has not been loaded.
__device__ __forceinline__ void ring_sync(const Group& gr, int i, int lo,
                                          int hi) {
  const int L = gr.a.L, n = span_slots(lo, hi, L);
  for (int j = 0, sl = slot_of(lo, L); j < n; ++j) {
    gr.x(F_LOG_TERM, i * L + sl) = gr.c(F_LOG_TERM, i * L + sl);
    gr.x(F_LOG_PAYLOAD, i * L + sl) = gr.c(F_LOG_PAYLOAD, i * L + sl);
    sl = sl + 1 == L ? 0 : sl + 1;
  }
}

// One counted deadline draw, made at tick t.
template <class NM>
__device__ __forceinline__ void reset_timer(const Group& gr, Node& n, int i,
                                            int t, const NM& nm) {
  n.ee = 0;
  n.deadline = election_deadline(gr.a, gr.h_timeout, n.rng_draws);
  if constexpr (NEMESIS)
    n.deadline = nem_skewed(gr, nm, i, static_cast<uint32_t>(t), n.deadline);
  n.rng_draws += 1;
}

// (voters, cfg_index) of the membership entry with the highest absolute
// index <= through in the live window, else the snapshot's config. The
// window's indices snap_index + 1 .. snap_index + L each own one slot, so
// a scan down from the highest candidate stops at the first entry.
__device__ __forceinline__ void config_scan(const Args& a, const Node& n,
                                            int through, int& voters,
                                            int& cfg_index) {
  const int hi = min(min(n.last_index, through), n.snap_index + a.L);
  voters = n.snap_voters;
  cfg_index = n.snap_index;
  int sl = slot_of(hi, a.L);
  for (int idx = hi; idx > n.snap_index; --idx) {
    const int p = n.lp[sl];
    if (p & CONFIG_FLAG) {
      voters = p & a.full_mask;
      cfg_index = idx;
      return;
    }
    sl = sl == 0 ? a.L - 1 : sl - 1;
  }
}

__device__ __forceinline__ int current_voters(const Args& a, const Node& n) {
  int voters = a.full_mask, cfg_index;
  if constexpr (RECONFIG) config_scan(a, n, INT_MAX_, voters, cfg_index);
  return voters;
}

__device__ __forceinline__ bool is_voter(int voters, int node) {
  return (voters >> node) & 1;
}

__device__ __forceinline__ int voter_majority(int voters) {
  return __popc(static_cast<unsigned>(voters)) / 2 + 1;
}

// Granted votes from current-config voters reach that config's majority.
__device__ __forceinline__ bool vote_quorum(const Args& a, const Node& n,
                                            unsigned votes) {
  if constexpr (RECONFIG) {
    const int voters = current_voters(a, n);
    return __popc(votes & static_cast<unsigned>(voters)) >=
           voter_majority(voters);
  } else {
    return __popc(votes) >= a.majority;
  }
}

// The pending scheduled read aborts, the ack evidence goes stale. (A
// template, as is node_step, so that a build without reads never
// instantiates the read lanes its Node lacks.)
template <class N>
__device__ __forceinline__ void drop_reads(const Args& a, N& n) {
  if constexpr (READS) {
    if (n.live)
      for (int p = 0; p < a.K; ++p) n.ack[p] = -1;
    n.sri = -1;
  }
}

__device__ __forceinline__ void step_down(const Args& a, Node& n,
                                          int new_term) {
  n.term = new_term;
  n.role = FOLLOWER;
  n.voted_for = NO_VOTE;
  n.leader_id = NO_VOTE;
  n.votes = 0;
  drop_reads(a, n);
}

// (A dead node's rows stay as they were: it writes none.)
__device__ __forceinline__ void become_leader(const Args& a, Node& n, int i) {
  drop_reads(a, n);
  n.role = LEADER;
  n.leader_id = i;
  n.hb = a.heartbeat;
  if (!n.live) return;
  for (int p = 0; p < a.K; ++p) {
    n.next[p] = n.last_index + 1;
    n.match[p] = 0;
  }
  // Takeover re-proposal: the top uncommitted entry takes the new term.
  if (n.last_index > n.commit)
    put_entry(n, n.last_index, a.L, n.term, 0, true);
}

template <class NM>
__device__ __forceinline__ void accept_leader(const Group& gr, Node& n, int i,
                                              int src, int t, const NM& nm) {
  n.role = FOLLOWER;
  n.leader_id = src;
  n.votes = 0;
  n.le = 0;
  reset_timer(gr, n, i, t, nm);
}

// The r-th largest (r >= 1) of v(p) over p in [0, K): the count of values
// above a candidate decides, so no array is sorted.
template <class V>
__device__ __forceinline__ int rank_desc(int K, int r, V v) {
  for (int p = 0; p < K; ++p) {
    const int x = v(p);
    int above = 0, equal = 0;
    for (int q = 0; q < K; ++q) {
      const int y = v(q);
      above += y > x;
      equal += y == x;
    }
    if (above < r && above + equal >= r) return x;
  }
  return -1;   // unreachable for 1 <= r <= K
}

// (majority-1)-th largest peer match index, the leader ranked first.
__device__ __forceinline__ int commit_candidate(const Args& a, const Node& n,
                                                int i) {
  if (a.majority == 1) return n.last_index;
  return rank_desc(a.K, a.majority - 1,
                   [&](int p) { return p == i ? -1 : n.match[p]; });
}

// Voters-aware tally: the majority(voters)-th largest replication index
// among voters, the leader counting its own last_index iff a voter; -1
// when there are no voters.
__device__ __forceinline__ int commit_candidate_voters(const Args& a,
                                                       const Node& n, int i,
                                                       int voters) {
  return rank_desc(a.K, voter_majority(voters), [&](int p) {
    return !is_voter(voters, p) ? -1 : p == i ? n.last_index : n.match[p];
  });
}

// This node's outbox slot m to dst, in the next mailbox.
#define OB(m, dst) gr.x(F_MB0 + (m), (dst) * K + i)

template <class NM>
__device__ __forceinline__ void start_election(const Group& gr, Node& n,
                                               int i, int t, const NM& nm) {
  const Args& a = gr.a;
  const int K = a.K;
  n.term += 1;
  n.role = CANDIDATE;
  n.voted_for = i;
  n.leader_id = NO_VOTE;
  n.votes = 1u << i;
  reset_timer(gr, n, i, t, nm);
  bool won = vote_quorum(a, n, n.votes);   // single-voter win
  if (won) become_leader(a, n, i);
  if (won) return;
  int llt = term_at(n, n.last_index, a.L);
  for (int p = 0; p < K; ++p) {
    if (p == i) continue;
    OB(RV_REQ_PRESENT, p) = 1;
    OB(RV_REQ_TERM, p) = n.term;
    OB(RV_REQ_LLI, p) = n.last_index;
    OB(RV_REQ_LLT, p) = llt;
  }
}

// ------------------------------------------------------------ one node

// Node i's step (lane i). `keep`: the delivery filter for dst = i, by src.
// [lo, hi]: the indices it wrote to its ring (hi < lo: none).
template <class N = Node, class NM = Nem>
__device__ __forceinline__ void node_step(
    const Group& gr, int i, unsigned keep, bool alive, int t, const NM& nm,
    int& lo, int& hi) {
  const Args& a = gr.a;
  const int K = a.K, L = a.L;
  const uint32_t gid = gr.gid, tu = static_cast<uint32_t>(t);
  bool full = false;   // a full disk fails every append of this node
  if constexpr (NEMESIS) full = (nm.full >> i) & 1u;
  N n;
  n.live = alive;
  n.term = gr.s(F_TERM, i);
  n.voted_for = gr.s(F_VOTED_FOR, i);
  n.snap_index = gr.s(F_SNAP_INDEX, i);
  n.snap_term = gr.s(F_SNAP_TERM, i);
  n.snap_digest = static_cast<uint32_t>(gr.s(F_SNAP_DIGEST, i));
  n.snap_voters = gr.s(F_SNAP_VOTERS, i);
  n.rng_draws = gr.s(F_RNG_DRAWS, i);
  n.last_index = gr.s(F_LAST_INDEX, i);
  n.role = gr.s(F_ROLE, i);
  n.leader_id = gr.s(F_LEADER_ID, i);
  n.commit = gr.s(F_COMMIT, i);
  n.applied = gr.s(F_APPLIED, i);
  n.digest = static_cast<uint32_t>(gr.s(F_DIGEST, i));
  n.votes = 0;
  for (int p = 0; p < K; ++p)
    n.votes |= (gr.s(F_VOTES, i * K + p) != 0 ? 1u : 0u) << p;
  n.next = &gr.s(F_NEXT_INDEX, i * K);
  n.match = &gr.s(F_MATCH_INDEX, i * K);
  n.ee = gr.s(F_ELECTION_ELAPSED, i);
  n.hb = gr.s(F_HEARTBEAT_ELAPSED, i);
  n.deadline = gr.s(F_DEADLINE, i);
  n.le = gr.s(F_LEADER_ELAPSED, i);
  n.lt = &gr.x(F_LOG_TERM, i * L);   // this tick's copy, in the next buffer
  n.lp = &gr.x(F_LOG_PAYLOAD, i * L);
  n.wlo = INT_MAX_;
  n.whi = INT_MIN_;
  if constexpr (READS) {
    n.ack = &gr.s(F_ACK_TIME, i * K);
    n.sri = gr.s(F_SCHED_READ_INDEX, i);
    n.srr = gr.s(F_SCHED_READ_REG, i);
    n.rdone = gr.s(F_READS_DONE, i);
  }
  if constexpr (CLIENTS) {
    n.sess = &gr.s(F_SESSION_SEQ, i * a.S);
    n.snap_sess = &gr.s(F_SNAP_SESSION_SEQ, i * a.S);
  }

  // inbox field m from src (dst = i), as delivered this tick
#define IN(m, src) gr.c(F_MB0 + (m), i * K + (src))
#define PRESENT(m, src) (((keep >> (src)) & 1u) && IN(m, src) != 0)

  // ---- phase D: canonical (type, src) order
  for (int s = 0; s < K; ++s) {   // RequestVote request
    if (!PRESENT(RV_REQ_PRESENT, s)) continue;
    int mt = IN(RV_REQ_TERM, s), lli = IN(RV_REQ_LLI, s),
        llt = IN(RV_REQ_LLT, s);
    if (mt > n.term) step_down(a, n, mt);
    int my_llt = term_at(n, n.last_index, L);
    bool log_ok = llt > my_llt || (llt == my_llt && lli >= n.last_index);
    bool grant = mt == n.term &&
                 (n.voted_for == NO_VOTE || n.voted_for == s) && log_ok;
    if (grant) {
      n.voted_for = s;
      reset_timer(gr, n, i, t, nm);
    }
    OB(RV_RESP_PRESENT, s) = 1;
    OB(RV_RESP_TERM, s) = n.term;
    OB(RV_RESP_GRANTED, s) = grant;
  }
  for (int s = 0; s < K; ++s) {   // RequestVote response
    if (!PRESENT(RV_RESP_PRESENT, s)) continue;
    int mt = IN(RV_RESP_TERM, s);
    bool granted = IN(RV_RESP_GRANTED, s) != 0;
    bool higher = mt > n.term;
    if (higher) step_down(a, n, mt);
    if (!higher && n.role == CANDIDATE && mt == n.term && granted) {
      n.votes |= 1u << s;
      if (vote_quorum(a, n, n.votes)) become_leader(a, n, i);
    }
  }
  for (int s = 0; s < K; ++s) {   // AppendEntries request
    if (!PRESENT(AE_REQ_PRESENT, s)) continue;
    int mt = IN(AE_REQ_TERM, s), prev = IN(AE_REQ_PREV_INDEX, s),
        prev_term = IN(AE_REQ_PREV_TERM, s), mn = IN(AE_REQ_N, s),
        mcommit = IN(AE_REQ_COMMIT, s);
    if (mt > n.term) step_down(a, n, mt);
    bool proceed = false;
    int match = 0;
    if (mt >= n.term) {   // not stale
      accept_leader(gr, n, i, s, t, nm);
      bool past = prev > n.last_index;
      bool conflict = !past && prev >= n.snap_index &&
                      term_at(n, prev, L) != prev_term;
      if (past) {
        match = n.last_index + 1;
      } else if (conflict) {
        // Fast backup: one past the highest in-window index below prev
        // whose term differs from prev's.
        int ct = term_at(n, prev, L);
        int best = n.snap_index, base = mod_l(n.snap_index, L);
        for (int l = 0; l < L; ++l) {
          int off = l - base;
          int ab = n.snap_index + 1 + (off >= 0 ? off : off + L);
          if (ab > n.snap_index && ab < prev && n.lt[l] != ct && ab > best)
            best = ab;
        }
        match = min(best + 1, prev);
      } else {
        proceed = true;
        // Entry walk: pull from the sender's start-of-tick ring.
        int j0 = max(0, n.snap_index - prev);
        int hi = prev + j0, last = n.last_index;
        for (int j = j0; j < a.E && j < mn; ++j) {
          int idx = prev + 1 + j;
          int sl = slot_of(idx, L);
          int et = gr.c(F_LOG_TERM, s * L + sl);
          int ep = gr.c(F_LOG_PAYLOAD, s * L + sl);
          bool in_log = idx <= last;
          bool same_t = in_log && n.lt[sl] == et;
          bool same_p = in_log && !same_t && n.lp[sl] == ep;
          bool diverge = in_log && !same_t && !same_p;
          bool need_append = !in_log || diverge;
          bool room = idx - n.snap_index <= L && !full;
          bool do_append = need_append && room;
          if (same_p || do_append) put_entry(n, idx, L, et, ep, same_p);
          if (do_append) last = idx;
          else if (diverge && !room) last = idx - 1;
          if (same_t || same_p || do_append) hi = idx;
          if (need_append && !room) break;   // stopped
        }
        n.last_index = last;
        if (mcommit > n.commit) n.commit = max(n.commit, min(mcommit, hi));
        match = hi;
      }
    }
    OB(AE_RESP_PRESENT, s) = 1;
    OB(AE_RESP_TERM, s) = n.term;
    OB(AE_RESP_SUCCESS, s) = proceed;
    OB(AE_RESP_MATCH, s) = match;
  }
  for (int s = 0; s < K; ++s) {   // AppendEntries response
    if (!PRESENT(AE_RESP_PRESENT, s)) continue;
    int mt = IN(AE_RESP_TERM, s), mm = IN(AE_RESP_MATCH, s);
    bool success = IN(AE_RESP_SUCCESS, s) != 0;
    bool higher = mt > n.term;
    if (higher) step_down(a, n, mt);
    if (!higher && n.role == LEADER && mt == n.term) {
      if constexpr (READS) n.ack[s] = t;   // ReadIndex deference evidence
      if (success) {
        int nm2 = max(n.match[s], mm);
        n.match[s] = nm2;
        n.next[s] = nm2 + 1;
      } else {
        n.next[s] = max(1, min(n.next[s] - 1, mm));
      }
    }
  }
  for (int s = 0; s < K; ++s) {   // InstallSnapshot request
    if (!PRESENT(IS_REQ_PRESENT, s)) continue;
    int mt = IN(IS_REQ_TERM, s), si = IN(IS_REQ_SNAP_INDEX, s),
        sterm = IN(IS_REQ_SNAP_TERM, s), sv = IN(IS_REQ_SNAP_VOTERS, s);
    uint32_t sd = static_cast<uint32_t>(IN(IS_REQ_SNAP_DIGEST, s));
    if (mt > n.term) step_down(a, n, mt);
    int match = 0;
    if (mt >= n.term) {
      accept_leader(gr, n, i, s, t, nm);
      if (si <= n.commit) {   // already covered
        match = n.commit;
      } else {
        bool keep_suffix = si <= n.last_index && si >= n.snap_index &&
                           term_at(n, max(si, n.snap_index), L) == sterm;
        if (!keep_suffix) n.last_index = si;
        n.snap_index = si;
        n.snap_term = sterm;
        n.snap_digest = sd;
        n.snap_voters = sv;
        n.commit = si;
        n.applied = si;
        n.digest = sd;
        if constexpr (CLIENTS) {   // the snapshot's dedup table installs
          for (int q = 0; q < a.S; ++q) {
            const int v = gr.c(F_IS_REQ_SNAP_SESSIONS, (i * K + s) * a.S + q);
            n.sess[q] = v;
            n.snap_sess[q] = v;
          }
        }
        match = si;
      }
    }
    OB(IS_RESP_PRESENT, s) = 1;
    OB(IS_RESP_TERM, s) = n.term;
    OB(IS_RESP_MATCH, s) = match;
  }
  for (int s = 0; s < K; ++s) {   // InstallSnapshot response
    if (!PRESENT(IS_RESP_PRESENT, s)) continue;
    int mt = IN(IS_RESP_TERM, s), mm = IN(IS_RESP_MATCH, s);
    bool higher = mt > n.term;
    if (higher) step_down(a, n, mt);
    if (!higher && n.role == LEADER && mt == n.term) {
      if constexpr (READS) n.ack[s] = t;
      int nm2 = max(n.match[s], mm);
      n.match[s] = nm2;
      n.next[s] = nm2 + 1;
    }
  }
  if constexpr (PREVOTE) {
    for (int s = 0; s < K; ++s) {   // PreVote request: grant, no adoption
      if (!PRESENT(PV_REQ_PRESENT, s)) continue;
      int mt = IN(PV_REQ_TERM, s), lli = IN(PV_REQ_LLI, s),
          llt = IN(PV_REQ_LLT, s);
      int my_llt = term_at(n, n.last_index, L);
      bool log_ok = llt > my_llt || (llt == my_llt && lli >= n.last_index);
      bool grant = mt > n.term && log_ok && n.role != LEADER &&
                   n.le >= a.election_min;   // the leader lease
      OB(PV_RESP_PRESENT, s) = 1;
      OB(PV_RESP_TERM, s) = n.term;
      OB(PV_RESP_REQ_TERM, s) = mt;
      OB(PV_RESP_GRANTED, s) = grant;
    }
    for (int s = 0; s < K; ++s) {   // PreVote response
      if (!PRESENT(PV_RESP_PRESENT, s)) continue;
      int mt = IN(PV_RESP_TERM, s), req = IN(PV_RESP_REQ_TERM, s);
      bool granted = IN(PV_RESP_GRANTED, s) != 0;
      bool higher = mt > n.term;
      if (higher) step_down(a, n, mt);
      if (!higher && n.role == PRECANDIDATE && req == n.term + 1 && granted) {
        n.votes |= 1u << s;
        // A pre-vote quorum starts the real election here, in phase D.
        if (vote_quorum(a, n, n.votes)) start_election(gr, n, i, t, nm);
      }
    }
  }
  if constexpr (TRANSFER) {
    for (int s = 0; s < K; ++s) {   // TimeoutNow: campaign, skip PreVote
      if (!PRESENT(TN_PRESENT, s)) continue;
      int mt = IN(TN_TERM, s);
      if (mt > n.term) step_down(a, n, mt);
      // Not a candidate: it campaigned already (perhaps this tick) and a
      // second start would write the RequestVote slots twice.
      bool go = mt == n.term && n.role != LEADER && n.role != CANDIDATE;
      if constexpr (RECONFIG) go = go && is_voter(current_voters(a, n), i);
      if (go) start_election(gr, n, i, t, nm);
    }
  }
#undef PRESENT
#undef IN

  // ---- phase T: heartbeat/replication broadcast, election timeout
  bool is_leader = n.role == LEADER;
  int hb = n.hb + 1;
  bool fire = is_leader && hb >= a.heartbeat;
  if (is_leader) n.hb = fire ? 0 : hb;
  if (fire) {
    for (int p = 0; p < K; ++p) {
      if (p == i) continue;
      if (n.next[p] <= n.snap_index) {
        OB(IS_REQ_PRESENT, p) = 1;
        OB(IS_REQ_TERM, p) = n.term;
        OB(IS_REQ_SNAP_INDEX, p) = n.snap_index;
        OB(IS_REQ_SNAP_TERM, p) = n.snap_term;
        OB(IS_REQ_SNAP_DIGEST, p) = static_cast<int>(n.snap_digest);
        OB(IS_REQ_SNAP_VOTERS, p) = n.snap_voters;
        if constexpr (CLIENTS)   // the snapshot's table as of phase T
          for (int q = 0; q < a.S; ++q)
            gr.x(F_IS_REQ_SNAP_SESSIONS, (p * K + i) * a.S + q) =
                n.snap_sess[q];
      } else {
        int prev = n.next[p] - 1;
        OB(AE_REQ_PRESENT, p) = 1;
        OB(AE_REQ_TERM, p) = n.term;
        OB(AE_REQ_PREV_INDEX, p) = prev;
        OB(AE_REQ_PREV_TERM, p) = term_at(n, prev, L);
        OB(AE_REQ_N, p) = min(a.E, n.last_index - prev);
        OB(AE_REQ_COMMIT, p) = n.commit;
      }
    }
  }
  if constexpr (TRANSFER) {
    // First tick of a firing epoch: TimeoutNow to a hash-chosen target
    // that is a current-config voter holding every committed entry and as
    // caught up as any peer.
    const uint32_t te = static_cast<uint32_t>(a.transfer_epoch);
    if (is_leader && tu % te == 0 &&
        hash_u32(a.seed, TAG_TRANSFER, gid, tu / te) < a.transfer_u32) {
      int target = static_cast<int>(
          hash_u32(a.seed, TAG_TRANSFER_NODE, gid, tu / te) %
          static_cast<uint32_t>(K));
      int top = n.match[0];
      for (int p = 1; p < K; ++p) top = max(top, n.match[p]);
      int mt = n.match[target];
      bool ok = mt >= n.commit && mt == top && target != i;
      if constexpr (RECONFIG)
        ok = ok && is_voter(current_voters(a, n), target);
      if (ok) {
        OB(TN_PRESENT, target) = 1;
        OB(TN_TERM, target) = n.term;
      }
    }
  }
  int ee = n.ee + 1;
  bool timeout = !is_leader && ee >= n.deadline;
  if constexpr (RECONFIG)   // non-voters never campaign
    if (timeout) timeout = is_voter(current_voters(a, n), i);
  if (!is_leader) n.ee = ee;
  n.le = is_leader ? 0 : n.le + 1;   // the PreVote lease clock
  if constexpr (PREVOTE) {
    if (timeout) {   // pre-candidacy: no term bump
      n.role = PRECANDIDATE;
      n.leader_id = NO_VOTE;
      n.votes = 1u << i;
      reset_timer(gr, n, i, t, nm);
      if (vote_quorum(a, n, n.votes)) {   // one vote is a quorum
        start_election(gr, n, i, t, nm);
      } else {
        int llt = term_at(n, n.last_index, L);
        for (int p = 0; p < K; ++p) {
          if (p == i) continue;
          OB(PV_REQ_PRESENT, p) = 1;
          OB(PV_REQ_TERM, p) = n.term + 1;
          OB(PV_REQ_LLI, p) = n.last_index;
          OB(PV_REQ_LLT, p) = llt;
        }
      }
    }
  } else if (timeout) {
    start_election(gr, n, i, t, nm);
  }

  if (!alive) {   // a dead sender's presence bits are erased; no row moves
    for_presence([&](int m) {
      for (int p = 0; p < K; ++p) OB(m, p) = 0;
    });
    lo = n.wlo;
    hi = n.whi;
    return;
  }

  // ---- phase C: scheduled read, scheduled membership change, fire-hose
  // (a disk-full leader appends nothing)
  const bool lead = n.role == LEADER;
  if constexpr (READS) {
    // ReadIndex at the start of phase C, at the pre-append commit index.
    if (lead && tu % static_cast<uint32_t>(a.read_every) == 0 &&
        n.sri < 0 &&
        (n.commit == n.last_index || term_at(n, n.commit, L) == n.term)) {
      n.sri = n.commit;
      n.srr = t;
    }
  }
  if constexpr (RECONFIG) {
    // First tick of a firing epoch: toggle one hash-chosen node, once the
    // last config entry is committed, the leader has committed in its
    // term and enough voters remain.
    const uint32_t re = static_cast<uint32_t>(a.reconfig_epoch);
    if (lead && tu % re == 0 &&
        hash_u32(a.seed, TAG_RECONFIG, gid, tu / re) < a.reconfig_u32) {
      int target = static_cast<int>(
          hash_u32(a.seed, TAG_RECONFIG_NODE, gid, tu / re) %
          static_cast<uint32_t>(K));
      int voters, cfg_index;
      config_scan(a, n, INT_MAX_, voters, cfg_index);
      int new_mask = voters ^ (1 << target);
      int idx = n.last_index + 1;
      if (__popc(static_cast<unsigned>(new_mask)) >= a.min_voters &&
          cfg_index <= n.commit && term_at(n, n.commit, L) == n.term &&
          idx - n.snap_index <= L && !full) {
        put_entry(n, idx, L, n.term, CONFIG_FLAG | new_mask, false);
        n.last_index = idx;
      }
    }
  }
  bool stopped = false;   // the window filled: no further appends
  if constexpr (CLIENTS) {
    // The pulsed session ops in slot order (seq = done; the value hashes
    // the op identity, so a retry is byte-identical); duplicates appended
    // by two transient leaders are safe by the exactly-once fold.
    if (lead) {
      for (int q = 0; q < a.S; ++q) {
        if (!gr.s(F_CLIENTS_SUBMIT, q)) continue;
        int idx = n.last_index + 1;
        if (idx - n.snap_index > L || full) {
          stopped = true;
          break;
        }
        const int done = gr.s(F_CLIENTS_DONE, q);
        put_entry(n, idx, L, n.term,
                  SESSION_FLAG | (q << SID_SHIFT) | (done << SEQ_SHIFT) |
                      static_cast<int>(
                          hash_u32(a.seed, TAG_CLIENT_VAL, gid, q, done) &
                          VAL_MASK),
                  false);
        n.last_index = idx;
      }
    }
  }
  if (n.role == LEADER && !stopped && !full) {
    for (int c = 0; c < a.cmds; ++c) {
      int idx = n.last_index + 1;
      if (idx - n.snap_index > L) break;   // window full
      put_entry(n, idx, L, n.term,
                static_cast<int>(
                    hash_u32(a.seed, TAG_CMD, gid, n.term, idx) & 0x3FFFFFFFu),
                false);
      n.last_index = idx;
    }
  }

  // ---- phase A: commit advance, removed-leader step-down, apply,
  // compaction, scheduled-read completion
  int voters = a.full_mask, cfg_index = n.snap_index;
  if constexpr (RECONFIG) config_scan(a, n, INT_MAX_, voters, cfg_index);
  if (n.role == LEADER) {
    const int nc = RECONFIG ? commit_candidate_voters(a, n, i, voters)
                            : commit_candidate(a, n, i);
    if (nc > n.commit && term_at(n, nc, L) == n.term) n.commit = nc;
  }
  if constexpr (RECONFIG) {
    if (n.role == LEADER && cfg_index <= n.commit && !is_voter(voters, i)) {
      n.role = FOLLOWER;   // its removal is committed
      n.leader_id = NO_VOTE;
      n.votes = 0;
      drop_reads(a, n);
    }
  }
  for (int st = 0; st < L && n.applied + 1 <= n.commit; ++st) {
    int idx = n.applied + 1;
    const int p = n.lp[slot_of(idx, L)];
    bool fold = true;
    if constexpr (CLIENTS) {
      // The exactly-once filter: a session entry folds, and advances its
      // sid's table entry, only if its seq is above the entry and its sid
      // is one of the S pre-registered slots.
      if ((p & SESSION_FLAG) && !(p & CONFIG_FLAG)) {
        const int sid = (p >> SID_SHIFT) & SID_MASK;
        const int seq = (p >> SEQ_SHIFT) & SEQ_MASK;
        fold = sid < a.S && seq > n.sess[sid];
        if (fold) n.sess[sid] = seq;
      }
    }
    if (fold) n.digest = digest_update(n.digest, idx, p);
    n.applied = idx;
  }
  bool compact = n.commit - n.snap_index >= a.compact;
  if constexpr (NEMESIS)
    if (compact) compact = !nem_compact_block(gr, nm, i, tu);
  if (compact) {
    if constexpr (CLIENTS)   // the live table folds into the snapshot's
      for (int q = 0; q < a.S; ++q) n.snap_sess[q] = n.sess[q];
    int snap_voters = a.full_mask;   // the committed config
    if constexpr (RECONFIG)
      config_scan(a, n, n.commit, snap_voters, cfg_index);
    n.snap_term = term_at(n, n.commit, L);
    n.snap_voters = snap_voters;
    n.snap_index = n.commit;
    n.snap_digest = n.digest;
  }
  if constexpr (READS) {
    // A current-config voter majority (self included when a voter) acked
    // at ticks >= reg + 2, and the read point is applied.
    if (n.sri >= 0 && n.applied >= n.sri) {
      const int rv = current_voters(a, n);   // after compaction
      int acks = is_voter(rv, i) ? 1 : 0;
      for (int p = 0; p < K; ++p)
        if (p != i && is_voter(rv, p) && n.ack[p] >= n.srr + 2) ++acks;
      if (acks >= (RECONFIG ? voter_majority(rv) : a.majority)) {
        n.rdone += 1;
        n.sri = -1;
      }
    }
  }

  // ---- the node's scalars back to its rows (its arrays and ring were
  // edited in place)
  gr.s(F_TERM, i) = n.term;
  gr.s(F_VOTED_FOR, i) = n.voted_for;
  gr.s(F_SNAP_INDEX, i) = n.snap_index;
  gr.s(F_SNAP_TERM, i) = n.snap_term;
  gr.s(F_SNAP_DIGEST, i) = static_cast<int>(n.snap_digest);
  gr.s(F_SNAP_VOTERS, i) = n.snap_voters;
  gr.s(F_RNG_DRAWS, i) = n.rng_draws;
  gr.s(F_LAST_INDEX, i) = n.last_index;
  gr.s(F_ROLE, i) = n.role;
  gr.s(F_LEADER_ID, i) = n.leader_id;
  gr.s(F_COMMIT, i) = n.commit;
  gr.s(F_APPLIED, i) = n.applied;
  gr.s(F_DIGEST, i) = static_cast<int>(n.digest);
  for (int p = 0; p < K; ++p) gr.s(F_VOTES, i * K + p) = (n.votes >> p) & 1u;
  gr.s(F_ELECTION_ELAPSED, i) = n.ee;
  gr.s(F_HEARTBEAT_ELAPSED, i) = n.hb;
  gr.s(F_DEADLINE, i) = n.deadline;
  gr.s(F_LEADER_ELAPSED, i) = n.le;
  if constexpr (READS) {
    gr.s(F_SCHED_READ_INDEX, i) = n.sri;
    gr.s(F_SCHED_READ_REG, i) = n.srr;
    gr.s(F_READS_DONE, i) = n.rdone;
  }
  lo = n.wlo;
  hi = n.whi;
}
#undef OB

// Restart edge: durable state survives, volatile state rewinds.
__device__ __forceinline__ void restart(const Group& gr, int i) {
  const Args& a = gr.a;
  const int K = a.K;
  int snap = gr.s(F_SNAP_INDEX, i);
  int draws = gr.s(F_RNG_DRAWS, i);
  gr.s(F_ROLE, i) = FOLLOWER;
  gr.s(F_LEADER_ID, i) = NO_VOTE;
  gr.s(F_COMMIT, i) = snap;
  gr.s(F_APPLIED, i) = snap;
  gr.s(F_DIGEST, i) = gr.s(F_SNAP_DIGEST, i);
  for (int p = 0; p < K; ++p) {
    gr.s(F_VOTES, i * K + p) = 0;
    gr.s(F_NEXT_INDEX, i * K + p) = 1;
    gr.s(F_MATCH_INDEX, i * K + p) = 0;
    gr.s(F_ACK_TIME, i * K + p) = -1;
  }
  gr.s(F_HEARTBEAT_ELAPSED, i) = 0;
  gr.s(F_ELECTION_ELAPSED, i) = 0;
  gr.s(F_LEADER_ELAPSED, i) = 0;
  gr.s(F_DEADLINE, i) = election_deadline(a, gr.h_timeout, draws);
  gr.s(F_RNG_DRAWS, i) = draws + 1;
  gr.s(F_SCHED_READ_INDEX, i) = -1;
  gr.s(F_READS_DONE, i) = 0;
  if constexpr (CLIENTS)   // the live dedup table rewinds to the snapshot's
    for (int q = 0; q < a.S; ++q)
      gr.s(F_SESSION_SEQ, i * a.S + q) = gr.s(F_SNAP_SESSION_SEQ, i * a.S + q);
}

// Node y's share of the per-tick safety predicate (sim/check.py
// `tick_safety`) on the post-tick state: its window bounds, election safety
// and digest agreement against every node above it, and leader
// completeness of every leader x (bit x of `leaders`) against it.
__device__ __forceinline__ bool tick_safety(
    const Group& gr, int y, unsigned leaders) {
  const Args& a = gr.a;
  const int K = a.K, L = a.L;
  const int ay = gr.s(F_APPLIED, y), cy = gr.s(F_COMMIT, y),
            sy = gr.s(F_SNAP_INDEX, y), ly = gr.s(F_LAST_INDEX, y),
            ty = gr.s(F_TERM, y), dy = gr.s(F_DIGEST, y);
  const bool lead_y = (leaders >> y) & 1u;
  bool ok = ay == cy && sy <= cy && cy <= ly && ly - sy <= L;
  for (int x = y + 1; x < K; ++x) {
    if (lead_y && ((leaders >> x) & 1u) && ty == gr.s(F_TERM, x)) ok = false;
    if (ay == gr.s(F_APPLIED, x) && dy != gr.s(F_DIGEST, x)) ok = false;
  }
  // Leader completeness, over the absolute indices both windows hold
  // (the lanes where both slot maps agree) up to min(commit_y, last_x).
  for (unsigned m = leaders & ~(1u << y); m != 0; m &= m - 1) {
    const int x = __ffs(m) - 1;
    const int tx = gr.s(F_TERM, x);
    if (tx < ty) continue;
    const int lx = gr.s(F_LAST_INDEX, x), sx = gr.s(F_SNAP_INDEX, x);
    if (cy > lx) {
      ok = false;
      continue;
    }
    const int lo = max(sx, sy) + 1;
    const int hi = min(min(sx, sy) + L, min(cy, lx));
    const int* px = &gr.x(F_LOG_PAYLOAD, x * L);
    const int* py = &gr.x(F_LOG_PAYLOAD, y * L);
#pragma unroll 4
    for (int idx = lo, sl = slot_of(lo, L); idx <= hi; ++idx) {
      if (px[sl] != py[sl]) ok = false;
      sl = sl + 1 == L ? 0 : sl + 1;
    }
  }
  return ok;
}

// Node x's share of the exactly-once clause of the safety fold, on the
// post-transition state: no table seq above its slot's issued frontier,
// and equal tables at equal applied prefixes for every node above it.
__device__ __forceinline__ bool client_safety(const Group& gr, int x) {
  const Args& a = gr.a;
  const int K = a.K, S = a.S;
  bool ok = true;
  for (int q = 0; q < S; ++q)
    if (gr.s(F_SESSION_SEQ, x * S + q) > gr.s(F_CLIENTS_DONE, q)) ok = false;
  const int ax = gr.s(F_APPLIED, x);
  for (int y = x + 1; y < K; ++y)
    if (ax == gr.s(F_APPLIED, y))
      for (int q = 0; q < S; ++q)
        if (gr.s(F_SESSION_SEQ, x * S + q) != gr.s(F_SESSION_SEQ, y * S + q))
          ok = false;
  return ok;
}

// The client transition on the post-tick state (clients/workload.py
// `client_update`), slot q on lane q % W: the ack against the group's
// applied dedup tables, the open-loop arrival (bounded by the 1,024-op
// lifetime and, with a cap, by admission), the retry, the start. Ack
// events go to the ack-latency histogram; `cmax` keeps the lane's longest
// ack latency.
__device__ __forceinline__ void client_update(
    const Group& gr, const Tile& tl, int t, int* acc, int& cmax) {
  const Args& a = gr.a;
  const int K = a.K, S = a.S;
  for (int q = tl.i; q < S; q += tl.w) {
    int tmax = gr.s(F_SESSION_SEQ, q);
    for (int k = 1; k < K; ++k)
      tmax = max(tmax, gr.s(F_SESSION_SEQ, k * S + q));
    int& done = gr.s(F_CLIENTS_DONE, q);
    int& backlog = gr.s(F_CLIENTS_BACKLOG, q);
    int& inflight = gr.s(F_CLIENTS_INFLIGHT, q);
    int& t_start = gr.s(F_CLIENTS_T_START, q);
    int& t_sub = gr.s(F_CLIENTS_T_SUB, q);
    int& last_lat = gr.s(F_CLIENTS_LAST_LAT, q);
    const bool acked = inflight && tmax >= done;
    last_lat = acked ? t - t_start : -1;
    if (acked) {
      done += 1;
      inflight = 0;
      if (a.hist > 0)
        atomicAdd(&acc[a.hist + 2 + min(last_lat, a.hist - 1)], 1);
      cmax = max(cmax, last_lat);
    }
    bool arrive = done + backlog + inflight <= SEQ_MASK &&
                  hash_u32(a.seed, TAG_CLIENT_ARRIVAL, gr.gid, q, t) <
                      a.clients_u32;
    if (a.cap > 0 && arrive && backlog >= a.cap) {
      gr.s(F_CLIENTS_SHED, q) += 1;   // a definitive reject: no seq, no retry
      arrive = false;
    }
    backlog += arrive;
    // Retry before start: only an op that stayed in flight re-submits.
    const bool retry = inflight && t - t_sub >= a.backoff;
    const bool start = !inflight && backlog > 0;
    if (start) {
      backlog -= 1;
      inflight = 1;
      t_start = t;
    }
    if (start || retry) t_sub = t;
    gr.s(F_CLIENTS_SUBMIT, q) = start || retry;
    gr.s(F_CLIENTS_RETRIES, q) += retry;
  }
}

// One group's launch on its tile, in shared memory (`gsm`: its static rows,
// buffers 0 and 1, its participation words). Flight rows go to `out`.
template <class NM, bool FLIGHT>
__device__ __forceinline__ void run_group(
    const Args& a, const Tile& tl, const uint32_t* nem, int* gsm, int* out, int*
    acc, int gi) {
  const int K = a.K, i = tl.i;
  const bool node = i < K;
  // Buffer b at gsm + db0 + b * db_pitch (arithmetic on the shared base,
  // not an indexed array of pointers, so every access stays a shared one).
  Group gr{a, nem, gsm, gsm + a.db0, gsm + a.db0 + a.db_pitch, 0u, 0u};
  gr.gid = static_cast<uint32_t>(gr.s(F_GROUP_ID, 0));
  gr.h_timeout = hash_u32(a.seed, TAG_TIMEOUT, gr.gid, i);
  unsigned alive_prev = tile_ballot(tl, node && gr.s(F_ALIVE_PREV, i) != 0);
  int committed = gr.s(F_COMMITTED, 0);
  int leaderless = gr.s(F_LEADERLESS, 0);
  int safety = gr.s(F_SAFETY, 0);
  int elections = 0, max_latency = 0;
  int cmax = 0;   // this lane's longest ack latency this launch
  NM nm;
  if constexpr (NEMESIS) {
    unsigned* part =
        reinterpret_cast<unsigned*>(gsm + a.db0 + 2 * a.db_pitch);
    nem_participate(gr, tl, part);
    nm.part = part;
    tile_sync(tl);
  }
  const int ring_words = 2 * K * a.L;   // the rings lead the region
  // The indices this lane's node wrote to its ring last tick; before the
  // first tick, L of them, so that tick copies the whole ring.
  int wlo = 1, whi = a.L;

  for (int tt = 0; tt < a.n_ticks; ++tt) {
    const int tick = a.t0 + tt;
    const uint32_t tu = static_cast<uint32_t>(tick);
    gr.cur = gsm + a.db0 + (tt & 1) * a.db_pitch;
    gr.nxt = gsm + a.db0 + ((tt + 1) & 1) * a.db_pitch;
    // The next buffer: the rings as they stand (a node edits its copy,
    // a dead node's stays frozen), the mailbox empty. A handler reads a
    // slot's fields only when its presence bit is set, so before the
    // last tick only the presence rows are cleared; the last tick
    // clears every row, as the wire holds them.
    if (node && whi >= wlo) ring_sync(gr, i, wlo, whi);   // wrote any?
    if (tt + 1 == a.n_ticks) {
      for (int w = ring_words + i; w < a.db_words; w += tl.w) gr.nxt[w] = 0;
    } else {
      for_presence([&](int m) {
        int* row = &gr.x(F_MB0 + m, 0);
        for (int q = i; q < K * K; q += tl.w) row[q] = 0;
      });
    }

    // Faults: node i's aliveness (storms ANDed in before the restart edge)
    bool up = node;
    if (node && a.crash_u32 != 0)
      up = hash_u32(a.seed, TAG_CRASH, gr.gid, i,
                    tu / static_cast<uint32_t>(a.crash_epoch)) >= a.crash_u32;
    if constexpr (NEMESIS)
      if (up) up = !nem_down(gr, nm, tu, i);
    const unsigned alive = tile_ballot(tl, up);
    if (((alive & ~alive_prev) >> i) & 1u) {
      restart(gr, i);
      if constexpr (NEMESIS)   // the restart's deadline draw, skewed
        gr.s(F_DEADLINE, i) = nem_skewed(gr, nm, i, tu, gr.s(F_DEADLINE, i));
    }
    bool part_active = false;
    unsigned side = 0;
    if (a.partition_u32 != 0) {
      const uint32_t epoch = tu / static_cast<uint32_t>(a.partition_epoch);
      part_active =
          hash_u32(a.seed, TAG_PART, gr.gid, epoch) < a.partition_u32;
      side = tile_ballot(tl, node && (hash_u32(a.seed, TAG_PART_SIDE, gr.gid,
                                               epoch, i) & 1u));
    }
    unsigned blk = 0;   // link clauses' drops into node i, by src
    if constexpr (NEMESIS) {
      blk = nem_blk(gr, tl, nm, tu);
      nm.full = nem_full(gr, nm, tu);
    }
    unsigned keep = 0;   // delivery filter for dst = i, by src
    if ((alive >> i) & 1u) {
      const uint32_t h_drop =
          a.drop_u32 != 0 ? hash_u32(a.seed, TAG_DROP, gr.gid, tu) : 0u;
      for (int s = 0; s < K; ++s) {
        bool cut = part_active && (((side >> s) ^ (side >> i)) & 1u);
        bool drop = a.drop_u32 != 0 && hash_fold(h_drop, s, i) < a.drop_u32;
        if (!cut && !drop) keep |= 1u << s;
      }
      keep &= ~blk;
    }
    tile_sync(tl);   // the next buffer is ready
    if (node)
      node_step<Node, NM>(gr, i, keep, (alive >> i) & 1u, tick, nm, wlo, whi);
    tile_sync(tl);   // every node has stepped
    alive_prev = alive;
    if constexpr (CLIENTS) {
      client_update(gr, tl, tick, acc, cmax);
      tile_sync(tl);
    }

    // metrics on the post-tick state
    const int top = tile_max(tl, node ? gr.s(F_COMMIT, i) : INT_MIN_);
    committed = max(committed, top);
    const unsigned leaders = tile_ballot(tl, node && gr.s(F_ROLE, i) == LEADER);
    const bool has_leader = (leaders & alive) != 0;
    const bool elected = has_leader && leaderless > 0;
    if (elected) {
      if (a.hist > 0 && i == 0) atomicAdd(&acc[min(leaderless, a.hist - 1)], 1);
      elections += 1;
      max_latency = max(max_latency, leaderless);
    }
    leaderless = has_leader ? 0 : leaderless + 1;
    bool ok = !node || tick_safety(gr, i, leaders);
    if constexpr (CLIENTS) ok = ok && (!node || client_safety(gr, i));
    const bool safe = tile_all(tl, ok);
    if (!safe) safety = 0;

    if constexpr (FLIGHT) {   // the flight ring: row t % ring
      int msgs = 0;   // the occupied outbox slots
      for_presence([&](int m) {
        for (int q = i; q < K * K; q += tl.w) msgs += gr.x(F_MB0 + m, q);
      });
      msgs = tile_sum(tl, msgs);
      if (i == 0) {
        const size_t G = a.G;
        const int row = static_cast<int>(tu % static_cast<uint32_t>(a.ring));
        const int vals[] = {tick, __popc(leaders & alive), elected, top,
                            msgs, safe};
        for (int f = 0; f < 6; ++f)
          out[(size_t)(a.off[F_FLIGHT_TICK + f] + row) * G + gi] = vals[f];
      }
    }
  }

  if (node) gr.s(F_ALIVE_PREV, i) = (alive_prev >> i) & 1u;
  if (i == 0) {
    gr.s(F_COMMITTED, 0) = committed;
    gr.s(F_LEADERLESS, 0) = leaderless;
    gr.s(F_SAFETY, 0) = safety;
    if (elections) atomicAdd(&acc[a.hist], elections);
    if (max_latency) atomicMax(&acc[a.hist + 1], max_latency);
  }
  if constexpr (CLIENTS) {
    // The acked / retry lanes are sums of monotone counters, so their
    // values after the last tick are what a per-tick recompute leaves.
    if (a.n_ticks > 0) {
      int acked = 0, retries = 0;
      for (int q = i; q < a.S; q += tl.w) {
        acked += gr.s(F_CLIENTS_DONE, q);
        retries += gr.s(F_CLIENTS_RETRIES, q);
      }
      acked = tile_sum(tl, acked);
      retries = tile_sum(tl, retries);
      if (i == 0) {
        gr.s(F_CLIENT_ACKED, 0) = acked;
        gr.s(F_CLIENT_RETRIES, 0) = retries;
      }
    }
    cmax = tile_max(tl, cmax);
    if (i == 0 && cmax) atomicMax(&acc[2 * a.hist + 2], cmax);
  }
}

// The shared words of one block: the clause table, then `ng` groups.
__host__ __device__ __forceinline__ size_t smem_words(const Args& a, int ng) {
  return NEM_WORDS * static_cast<size_t>(a.nem_start[N_SEAMS]) +
         static_cast<size_t>(ng) * a.gs;
}

// A template over the nemesis lanes' type, so that a build without
// nemesis never instantiates the code that names their members, and over
// the flight ring (see the head of the file). A block's groups load, run
// their tiles, and store; the tiles of one block never wait for each other
// between the load and the store.
template <class NM, bool FLIGHT>
__global__ void __launch_bounds__(MAX_THREADS, 1)
fused_chunk_kernel(const int* __restrict__ wire_in, int* __restrict__ out,
                   int* __restrict__ acc, const uint32_t* __restrict__ nem_tab,
                   const __grid_constant__ Args a) {
  extern __shared__ int smem[];
  const size_t G = a.G;
  const int g0 = blockIdx.x * a.ng;
  const int ng = min(a.ng, a.G - g0);
  const int n_nem = NEM_WORDS * a.nem_start[N_SEAMS];
  uint32_t* nem = reinterpret_cast<uint32_t*>(smem);
  int* groups = smem + n_nem;
  for (int w = threadIdx.x; w < n_nem; w += blockDim.x) nem[w] = nem_tab[w];
  // The static rows (less the flight rows) and buffer 0, group by group
  // in shared memory; consecutive threads read consecutive groups (the
  // block has W threads for each of its a.ng groups: thread t moves
  // group t % a.ng, rows t / a.ng, t / a.ng + W, ...).
  const int* src = wire_in != nullptr ? wire_in : out;
  const int rows = a.n_static + a.db_words;
  const int g = threadIdx.x % a.ng, r0 = threadIdx.x / a.ng;
  for (int r = r0; g < ng && r < rows; r += a.W) {
    const bool st = r < a.n_static;
    const int wr = st ? r : a.db_start + (r - a.n_static);
    groups[g * a.gs + (st ? r : a.db0 + (r - a.n_static))] =
        src[(size_t)wr * G + g0 + g];
  }
  if (FLIGHT && wire_in != nullptr)   // rows no tick of this launch writes
    for (int r = a.n_static + r0; g < ng && r < a.db_start; r += a.W)
      out[(size_t)r * G + g0 + g] = wire_in[(size_t)r * G + g0 + g];
  __syncthreads();

  const int tile = threadIdx.x / a.W;
  Tile tl;
  tl.w = a.W;
  tl.i = threadIdx.x % a.W;
  tl.base = threadIdx.x % 32 - tl.i;
  tl.mask = a.W == 32 ? 0xFFFFFFFFu : ((1u << a.W) - 1u) << tl.base;
  if (tile < ng)
    run_group<NM, FLIGHT>(a, tl, nem, groups + tile * a.gs, out, acc,
                          g0 + tile);
  __syncthreads();

  // The groups back to the wire: the static rows and the buffer the last
  // tick wrote.
  const int last = a.db0 + (a.n_ticks & 1) * a.db_pitch;
  for (int r = r0; g < ng && r < rows; r += a.W) {
    const bool st = r < a.n_static;
    const int wr = st ? r : a.db_start + (r - a.n_static);
    out[(size_t)wr * G + g0 + g] =
        groups[g * a.gs + (st ? r : last + (r - a.n_static))];
  }
}

}  // namespace

namespace {

// The launch's Args from the wrapper's host arrays: 0, -1 on a bad
// argument, -2 when the config's feature flags are not this build's.
int parse(Args& a, const int* offsets, int n_offsets,
          const long long* params, int n_params, const unsigned* nem,
          int n_nem) {
  if (n_offsets != N_FIELDS || n_params != N_PARAMS) return -1;
  a.G = static_cast<int>(params[P_G]);
  a.K = static_cast<int>(params[P_K]);
  a.L = static_cast<int>(params[P_L]);
  a.E = static_cast<int>(params[P_E]);
  a.seed = static_cast<uint32_t>(params[P_SEED]);
  a.election_min = static_cast<int>(params[P_ELECTION_MIN]);
  a.election_range = static_cast<int>(params[P_ELECTION_RANGE]);
  a.heartbeat = static_cast<int>(params[P_HEARTBEAT]);
  a.compact = static_cast<int>(params[P_COMPACT]);
  a.cmds = static_cast<int>(params[P_CMDS]);
  a.crash_u32 = static_cast<uint32_t>(params[P_CRASH_U32]);
  a.crash_epoch = static_cast<int>(params[P_CRASH_EPOCH]);
  a.partition_u32 = static_cast<uint32_t>(params[P_PARTITION_U32]);
  a.partition_epoch = static_cast<int>(params[P_PARTITION_EPOCH]);
  a.drop_u32 = static_cast<uint32_t>(params[P_DROP_U32]);
  a.majority = static_cast<int>(params[P_MAJORITY]);
  a.full_mask = static_cast<int>(params[P_FULL_MASK]);
  a.hist = static_cast<int>(params[P_HIST]);
  a.n_words = static_cast<int>(params[P_N_WORDS]);
  a.db_start = static_cast<int>(params[P_DB_START]);
  a.db_words = static_cast<int>(params[P_DB_WORDS]);
  a.t0 = static_cast<int>(params[P_T0]);
  a.n_ticks = static_cast<int>(params[P_N_TICKS]);
  a.transfer_u32 = static_cast<uint32_t>(params[P_TRANSFER_U32]);
  a.transfer_epoch = static_cast<int>(params[P_TRANSFER_EPOCH]);
  a.reconfig_u32 = static_cast<uint32_t>(params[P_RECONFIG_U32]);
  a.reconfig_epoch = static_cast<int>(params[P_RECONFIG_EPOCH]);
  a.min_voters = static_cast<int>(params[P_MIN_VOTERS]);
  a.read_every = static_cast<int>(params[P_READ_EVERY]);
  a.S = static_cast<int>(params[P_S]);
  a.clients_u32 = static_cast<uint32_t>(params[P_CLIENTS_U32]);
  a.backoff = static_cast<int>(params[P_BACKOFF]);
  a.cap = static_cast<int>(params[P_CAP]);
  a.ring = static_cast<int>(params[P_RING]);
  if (a.K < 1 || a.K > K_LIMIT || a.L < 1 || a.G < 1 || a.ring < 0 ||
      a.hist < 0 || (CLIENTS && a.S < 1))
    return -1;
  // The config's feature flags must be this build's.
  if (params[P_PREVOTE] != PREVOTE || params[P_TRANSFER] != TRANSFER ||
      params[P_RECONFIG] != RECONFIG || params[P_READS] != READS ||
      params[P_CLIENTS] != CLIENTS || params[P_NEMESIS] != NEMESIS)
    return -2;
  for (int f = 0; f < N_FIELDS; ++f) a.off[f] = offsets[f];
  // The rings lead the double-buffered region; the flight rows end the
  // static one.
  a.n_static = a.db_start - 6 * a.ring;
  if (a.off[F_LOG_TERM] != 0 || a.off[F_LOG_PAYLOAD] != a.K * a.L ||
      a.n_static < 0 || a.db_words < 2 * a.K * a.L ||
      a.n_words != a.db_start + a.db_words)
    return -1;
  if (n_nem < N_SEAMS) return -1;
  a.nem_start[0] = 0;
  for (int s = 0; s < N_SEAMS; ++s) {
    if (static_cast<int>(nem[s]) < 0) return -1;
    a.nem_start[s + 1] = a.nem_start[s] + static_cast<int>(nem[s]);
  }
  const int n_clauses = a.nem_start[N_SEAMS];
  if ((!NEMESIS && n_clauses > 0) || n_nem != N_SEAMS + NEM_WORDS * n_clauses)
    return -1;
  a.part_words = NEMESIS ? (n_clauses + 31) / 32 : 0;
  a.W = 1;
  while (a.W < a.K) a.W *= 2;
  a.db0 = (a.n_static + 1) & ~1;
  a.db_pitch = (a.db_words + 1) & ~1;
  // An even stride whose half is odd: neighbouring groups start in other
  // banks.
  a.gs = (a.db0 + 2 * a.db_pitch + a.part_words + 1) & ~1;
  if ((a.gs / 2) % 2 == 0) a.gs += 2;
  return 0;
}

// The block shape: lanes per group, groups per block, threads per block,
// shared bytes per block, blocks and groups per SM.
struct Plan {
  int W, ng, threads, smem, blocks_per_sm, groups_per_sm;
};

// The groups per block that let the most groups run at once on an SM (by
// the occupancy query, the larger block on a tie), for this shape: 0, a
// CUDA error, or -3 when one group does not fit a block's shared memory.
// A function's attributes (the shared-memory opt-in, the carveout) belong
// to the context of the device they were set on, so the plans are cached
// by device as well as by shape: a table of PLAN_SLOTS entries, replaced
// in turn, so that shards of unequal shapes or on several cards do not
// evict each other on every launch. The launch runs on the current device.
constexpr int PLAN_SLOTS = 16;

template <class NM, bool FLIGHT>
int plan(Args& a, Plan& out) {
  struct Slot {
    int key[5];
    Plan value;
  };
  static Slot table[PLAN_SLOTS];
  static int used = 0, next = 0;
  static std::mutex lock;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int want[5] = {dev, a.W, a.gs, a.nem_start[N_SEAMS], a.K};
  std::lock_guard<std::mutex> hold(lock);
  for (int s = 0; s < used; ++s) {
    bool hit = true;
    for (int j = 0; j < 5; ++j) hit = hit && table[s].key[j] == want[j];
    if (hit) {
      out = table[s].value;
      a.ng = out.ng;
      return 0;
    }
  }
  auto* kern = fused_chunk_kernel<NM, FLIGHT>;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  Plan best{a.W, 0, 0, 0, 0, 0};
  for (int ng = 1; ng * a.W <= MAX_THREADS; ++ng) {
    const size_t bytes = 4 * smem_words(a, ng);
    if (bytes > static_cast<size_t>(optin)) break;
    int nb = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kern, ng * a.W,
                                                      bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (nb > 0 && nb * ng >= best.groups_per_sm)
      best = Plan{a.W, ng, ng * a.W, static_cast<int>(bytes), nb, nb * ng};
  }
  if (best.ng == 0) return -3;
  Slot& slot = table[next];   // the slots fill in order, then in turn
  next = (next + 1) % PLAN_SLOTS;
  if (used < PLAN_SLOTS) ++used;
  for (int j = 0; j < 5; ++j) slot.key[j] = want[j];
  slot.value = best;
  out = best;
  a.ng = best.ng;
  return 0;
}

template <bool FLIGHT>
int plan_or_launch(Args& a, Plan& p, const int* in, int* o, int* ac,
                   const uint32_t* nt, cudaStream_t st, bool launch) {
  const int rc = plan<Nem, FLIGHT>(a, p);
  if (rc != 0 || !launch) return rc;
  const int blocks = (a.G + a.ng - 1) / a.ng;
  fused_chunk_kernel<Nem, FLIGHT><<<blocks, p.threads, p.smem, st>>>(
      in, o, ac, nt, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; a null `wire_in` runs in place on `wire_out`.
// `nem_tab` is the nemesis clause table on the device (NEM_WORDS words a
// clause, grouped by seam; null without clauses). `offsets` (n_offsets ==
// N_FIELDS ints, -1 for a field the config does not carry), `params`
// (n_params == N_PARAMS int64s) and `nem` (the seams' clause counts, then
// the clauses' words; n_nem words) are host arrays. Returns the
// cudaGetLastError() of the launch (0 = launched), -1 on a bad argument,
// -2 when the config's feature flags are not this build's, -3 when one
// group does not fit a block's shared memory.
extern "C" int fused_chunk_launch(const void* wire_in, void* wire_out,
                                  void* acc, const void* nem_tab,
                                  const int* offsets, int n_offsets,
                                  const long long* params, int n_params,
                                  const unsigned* nem, int n_nem,
                                  void* stream) {
  Args a;
  int rc = parse(a, offsets, n_offsets, params, n_params, nem, n_nem);
  if (rc != 0) return rc;
  if (a.nem_start[N_SEAMS] > 0 && nem_tab == nullptr) return -1;
  Plan p;
  const int* in = static_cast<const int*>(wire_in);
  int* o = static_cast<int*>(wire_out);
  int* ac = static_cast<int*>(acc);
  const uint32_t* nt = static_cast<const uint32_t*>(nem_tab);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return a.ring > 0 ? plan_or_launch<true>(a, p, in, o, ac, nt, st, true)
                    : plan_or_launch<false>(a, p, in, o, ac, nt, st, true);
}

// The block shape the launch of the same arguments takes, in `out[6]`:
// lanes per group, groups per block, threads per block, shared bytes per
// block, blocks per SM and groups per SM (occupancy query). Returns as
// fused_chunk_launch, without launching.
extern "C" int fused_chunk_plan(const int* offsets, int n_offsets,
                                const long long* params, int n_params,
                                const unsigned* nem, int n_nem, int* out) {
  Args a;
  int rc = parse(a, offsets, n_offsets, params, n_params, nem, n_nem);
  if (rc != 0) return rc;
  Plan p;
  rc = a.ring > 0
           ? plan_or_launch<true>(a, p, nullptr, nullptr, nullptr, nullptr,
                                  nullptr, false)
           : plan_or_launch<false>(a, p, nullptr, nullptr, nullptr, nullptr,
                                   nullptr, false);
  if (rc != 0) return rc;
  const int v[6] = {p.W, p.ng, p.threads, p.smem, p.blocks_per_sm,
                    p.groups_per_sm};
  for (int j = 0; j < 6; ++j) out[j] = v[j];
  return 0;
}
