// Fused-chunk Raft tick for Hopper (sm_90a): `n_ticks` whole ticks of the
// batched simulation per launch, one thread per Raft group.
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
// `if constexpr`: the build with all six off carries none of their code,
// branches or mailbox rows, and the launcher refuses a config whose flags
// differ from the build's. The
// PreVote/TimeoutNow mailbox slots ride the wire, and the outbox frame, only
// when their flags are on; the voter set is an i32 bitmask (k <= 8 here)
// derived from the node's own ring by a scan of the live window, never
// stored. The flight ring is a launch parameter (its length, 0 = off): the
// tick writes row t % ring of six per-group rings after the metrics. Each
// build holds the kernel twice, without and with the ring (a template
// argument; the launcher picks one), because the ring's code, even behind
// a runtime branch, grows the base kernel's frame (1,568 -> 1,584 B on
// sm_90a): the kernel without it is the base build's code as it was.
//
// Clients. The per-node dedup tables live in a base class of Node that is
// empty without clients (as the read lanes do); the per-group client state
// (S <= SMAX slots) stays in the thread's local memory across the tick loop,
// loaded once per launch and stored at its end. Each tick computes the
// submit payloads from the pre-tick client state, every self-believed leader
// appends them in phase C, phase A folds a session entry only if its seq
// advances its sid's table entry, and the client transition runs on the
// post-tick tables. Ack latencies go to `acc` with integer atomics.
//
// Nemesis. The program's clauses arrive as launch data (`Args::nem`, at
// most NEM_MAX), grouped by seam on the host so each seam walks only its
// own clauses: link clauses mask the per-destination delivery filter,
// crash storms the aliveness mask before the restart edge, skew clauses
// every deadline draw (the timer reset and the restart), disk-full clauses
// every append of the node (computed once per node per tick, used in the
// AppendEntries walk and in phase C), compaction clauses phase A's
// snapshot step. Each clause's per-group participation is hashed once per
// launch into a bit mask. Every draw is the (seed, TAG_NEM_*, cid, coords)
// hash of utils/trng.py `nem_*`, taken only where its clause is active.
//
// Design. Groups never talk to each other, so each thread steps its own
// group through the tick loop sequentially: nodes 0..K-1, each through the
// handler types in canonical (type, src) order (PreVote and TimeoutNow
// last), then phases T, C, A —
// the sequential tick contract written out directly, with the data-
// dependent branches a thread can take. The TPU kernel's one-hot selects,
// [GS,128] fold and bool->i32 carries are gone: a ring read is an indexed
// load.
//
// Layout. The wire is an int32 [W, G] tensor, structure of arrays with the
// group axis minor (row = field x node x lane, see kernel.py `_wire_rows`),
// so neighbouring threads touch neighbouring addresses. The rings and the
// mailbox are double-buffered across ticks (`db[0]` inside the wire,
// `db[1]` in a scratch tensor): a receiver pulls AppendEntries entries from
// the sender's ring as of the start of the tick, while the receiver's own
// ring changes, and the inbox delivered this tick is last tick's outbox.
// A node works on a private copy of its ring and writes it to the next
// buffer at the end of its step (frozen: the old ring, when the node is
// dead). Scalar node state is updated in place: no other node reads it.
//
// Metrics go to global accumulators: committed/leaderless/safety are wire
// rows; the [H] histogram, the election count and the longest streak are
// integer atomics into `acc` (exact in any order). With H = 0 (the
// `wire_hist=False` dial) `acc` holds no histogram rows and the kernel tracks
// none.
//
// In place. A null `wire_in` runs the ticks on `out` as it stands, with no
// copy: the wrapper passes it for the output written over the input
// (`alias_wire`) and for the working wire the codec unpacks
// (csrc/wire_codec.cu), so the two `__restrict__` pointers never alias. The
// codec runs only at the launch boundary and never inside this kernel.
//
// What bounds it on the H100: the per-tick state stays in device memory
// (about 4.7 KB per group; at 100K groups far more than the 50 MB L2), so
// every tick streams each group's mailbox, rings and scalars through HBM
// and local memory; the integer work per group-tick is a few thousand
// operations. One thread per group also leaves the card short of threads
// below a few hundred thousand groups, so each thread's long dependent
// chain of loads sets the time: a 200-tick launch takes about as long at
// 50K groups as at 100K. PERF.md records the measured times beside both
// bounds. Where the per-group state should live instead (registers or
// shared memory across the tick loop), and more threads per group, are
// left to a later change.

#include <cstdint>
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

constexpr int KMAX = 8;    // kernel.py refuses larger k
constexpr int LMAX = 64;   // kernel.py refuses larger log_cap
constexpr int SMAX = 16;   // the config refuses more client slots
constexpr int NEM_MAX = 16;   // kernel.py refuses longer nemesis programs

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
enum NemWord { NK, NT0, NT1, NGROUP, NP, NA, NB, NCID };
// The seams, in the order kernel.py groups the clauses.
enum NemSeam { NS_LINK, NS_CRASH, NS_SKEW, NS_DISK, NS_COMPACT, N_SEAMS };
constexpr int FOLLOWER = 0, CANDIDATE = 1, LEADER = 2, PRECANDIDATE = 3,
              NO_VOTE = -1;
constexpr int CONFIG_FLAG = 1 << 30;   // membership entry: low k bits voters
// Session command: sid in bits 20-28, seq in bits 10-19, value in bits 0-9.
constexpr int SESSION_FLAG = 1 << 29;
constexpr int SID_SHIFT = 20, SID_MASK = 0x1FF, SEQ_SHIFT = 10,
              SEQ_MASK = 0x3FF, VAL_MASK = 0x3FF;
constexpr int INT_MAX_ = 0x7FFFFFFF;

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

// The outbox holds the rows of the slots this build carries: the base 26,
// then PreVote's 8, then TimeoutNow's 2.
constexpr int N_PV = TN_PRESENT - PV_REQ_PRESENT;
constexpr int N_OB = PV_REQ_PRESENT + (PREVOTE ? N_PV : 0) +
                     (TRANSFER ? N_MB - TN_PRESENT : 0);
__device__ __forceinline__ constexpr int ob_row(int m) {
  return m < TN_PRESENT || PREVOTE ? m : m - N_PV;
}
__device__ __forceinline__ constexpr int mb_of_row(int r) {
  return r < PV_REQ_PRESENT || PREVOTE ? r : r + N_PV;
}

__device__ __forceinline__ bool is_presence(int m) {
  return m == RV_REQ_PRESENT || m == RV_RESP_PRESENT ||
         m == AE_REQ_PRESENT || m == AE_RESP_PRESENT ||
         m == IS_REQ_PRESENT || m == IS_RESP_PRESENT ||
         m == PV_REQ_PRESENT || m == PV_RESP_PRESENT || m == TN_PRESENT;
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
  // Members added with the clients and the flight ring come after the
  // offsets: before them, they moved every offset's place in the parameter
  // bank, and ptxas then allocated three clients-off builds differently.
  int S;   // client slots
  uint32_t clients_u32;
  int backoff, cap;   // client retry backoff, admission cap (0 = off)
  int ring;           // flight ring length, 0 = no flight
  // The nemesis program, clauses grouped by seam: seam s owns rows
  // [start[s], start[s + 1]). Times are clamped to [0, 2**31 - 1] and the
  // skew amount is the int32 bit pattern.
  struct {
    int start[N_SEAMS + 1];
    uint32_t c[NEMESIS ? NEM_MAX : 1][8];
  } nem;
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

// Folds its arguments in order, as utils/trng.py `hash_u32`.
template <typename... T>
__device__ __forceinline__ uint32_t hash_u32(T... v) {
  uint32_t h = SEED0;
  ((h = mix32(h * GOLD + static_cast<uint32_t>(v))), ...);
  return h;
}

__device__ __forceinline__ uint32_t digest_update(uint32_t d, int idx,
                                                  int payload) {
  return mix32(d * GOLD +
               mix32(static_cast<uint32_t>(idx) * GOLD +
                     static_cast<uint32_t>(payload)));
}

// Floor-mod ring slot of absolute index idx: index 0 maps to L - 1.
__device__ __forceinline__ int slot_of(int idx, int L) {
  int r = (idx - 1) % L;
  return r < 0 ? r + L : r;
}

// ------------------------------------------------------------- node state

// Scheduled-read lanes: part of a node's working state only in a build
// with reads on. (As plain members of Node, never touched, they still
// cost the base build 48 B of stack frame: 1,616 B against 1,568 B in
// nvcc's ptxas -v for sm_90a.)
struct ReadLanes {
  int ack[KMAX];    // last current-term response tick, by peer
  int sri, srr, rdone;   // read point (-1 none), registration tick, count
};
struct NoReadLanes {};

// Dedup tables: part of a node's working state only with clients on.
struct SessLanes {
  int sess[SMAX], snap_sess[SMAX];   // live table, snapshot's table
  int sent_sess[SMAX];   // the snapshot table this tick's IS sends carry
};
struct NoSessLanes {};

struct Node : std::conditional_t<READS, ReadLanes, NoReadLanes>,
              std::conditional_t<CLIENTS, SessLanes, NoSessLanes> {
  int term, voted_for, snap_index, snap_term;
  uint32_t snap_digest;
  int snap_voters, rng_draws, last_index, role, leader_id, commit, applied;
  uint32_t digest;
  unsigned votes;   // bit p = vote granted by p
  int next[KMAX], match[KMAX];
  int ee, hb, deadline, le;
  int lt[LMAX], lp[LMAX];   // own ring, this tick's working copy
};

// The per-group client state, held across the launch's tick loop, and the
// payloads of this tick's pulsed ops (clients builds only).
struct ClientLanes {
  int done[SMAX], backlog[SMAX], inflight[SMAX], t_start[SMAX];
  int t_sub[SMAX], submit[SMAX], retries[SMAX], last_lat[SMAX], shed[SMAX];
  int pay[SMAX];
};
struct NoClientLanes {};
using Clients = std::conditional_t<CLIENTS, ClientLanes, NoClientLanes>;

// The group's nemesis lanes (nemesis builds only): which clauses the group
// takes part in (bit = table row, once per launch) and which nodes' disks
// are full this tick (bit = node).
struct NemLanes {
  unsigned part, full;
};
struct NoNemLanes {};
using Nem = std::conditional_t<NEMESIS, NemLanes, NoNemLanes>;

struct Group {
  const Args& a;
  int* st;        // the static region of the output wire
  const int* cur; // double-buffered region, start of this tick
  int* nxt;       // double-buffered region, end of this tick
  size_t G;
  int gi;
  uint32_t gid;

  __device__ int& s(int f, int r) const {
    return st[(size_t)(a.off[f] + r) * G + gi];
  }
  __device__ int c(int f, int r) const {
    return cur[(size_t)(a.off[f] + r) * G + gi];
  }
  __device__ int& x(int f, int r) const {
    return nxt[(size_t)(a.off[f] + r) * G + gi];
  }
};

__device__ __forceinline__ int election_deadline(const Args& a, uint32_t gid,
                                                 int i, int draws) {
  uint32_t r = hash_u32(a.seed, TAG_TIMEOUT, gid, i, draws) %
               static_cast<uint32_t>(a.election_range);
  return static_cast<int>(static_cast<uint32_t>(a.election_min) + r);
}

// ------------------------------------------------------------ nemesis seams
// (templates over the lanes' type: a build without nemesis never
// instantiates them)

template <class NM>
__device__ __forceinline__ bool nem_active(const Args& a, const NM& nm, int j,
                                           uint32_t tu) {
  return ((nm.part >> j) & 1u) && tu >= a.nem.c[j][NT0] &&
         tu < a.nem.c[j][NT1];
}

// The participation mask: hash(seed, TAG_NEM_GROUP, cid, g) < group_u32.
template <class NM>
__device__ void nem_participate(const Args& a, NM& nm, uint32_t gid) {
  nm.part = 0;
  for (int j = 0; j < a.nem.start[N_SEAMS]; ++j)
    if (hash_u32(a.seed, TAG_NEM_GROUP, a.nem.c[j][NCID], gid) <
        a.nem.c[j][NGROUP])
      nm.part |= 1u << j;
}

// blk[d] bit s: an active link clause drops s -> d this tick.
template <class NM>
__device__ void nem_links(const Args& a, const NM& nm, uint32_t gid,
                          uint32_t tu, unsigned* blk) {
  const int K = a.K;
  const uint32_t k = static_cast<uint32_t>(K);
  for (int d = 0; d < K; ++d) blk[d] = 0;
  for (int j = a.nem.start[NS_LINK]; j < a.nem.start[NS_LINK + 1]; ++j) {
    if (!nem_active(a, nm, j, tu)) continue;
    const uint32_t* c = a.nem.c[j];
    const uint32_t cid = c[NCID], A = c[NA], B = c[NB];
    unsigned hit[KMAX];   // by destination, bit = source
    for (int d = 0; d < K; ++d) hit[d] = 0;
    if (c[NK] == NEM_SLOW) {
      const int target = static_cast<int>(
          hash_u32(a.seed, TAG_NEM_NODE, cid, gid) % k);
      for (int d = 0; d < K; ++d)
        for (int s = 0; s < K; ++s)
          if (((A & 1u) && s == target) || ((A & 2u) && d == target))
            hit[d] |= 1u << s;
    } else if (c[NK] == NEM_FLAKY) {
      if (K < 2) continue;   // a 1-node group has no links
      const uint32_t s0 = hash_u32(a.seed, TAG_NEM_NODE, cid, gid, 0u) % k;
      const uint32_t d0 =
          (s0 + 1u + hash_u32(a.seed, TAG_NEM_NODE, cid, gid, 1u) % (k - 1u)) %
          k;
      if (hash_u32(a.seed, TAG_NEM_BURST, cid, gid, tu / A) < B)
        hit[d0] |= 1u << s0;
    } else if (c[NK] == NEM_WAN) {
      uint32_t site[KMAX];
      for (int n = 0; n < K; ++n)
        site[n] = hash_u32(a.seed, TAG_NEM_NODE, cid, gid, n) % A;
      for (int d = 0; d < K; ++d)
        for (int s = 0; s < K; ++s)
          if (site[s] != site[d]) hit[d] |= 1u << s;
    } else {   // NEM_WAVE: inside the sweeping window, cross-side links
      if ((tu + gid) % A >= B) continue;
      unsigned side = 0;
      for (int n = 0; n < K; ++n)
        side |= (hash_u32(a.seed, TAG_NEM_SIDE, cid, gid, tu / A, n) & 1u)
                << n;
      for (int d = 0; d < K; ++d)
        for (int s = 0; s < K; ++s)
          if (((side >> s) ^ (side >> d)) & 1u) hit[d] |= 1u << s;
    }
    for (int d = 0; d < K; ++d)   // the link draw, on the links hit
      for (int s = 0; s < K; ++s)
        if (s != d && ((hit[d] >> s) & 1u) &&
            hash_u32(a.seed, TAG_NEM_LINK, cid, gid, tu, s, d) < c[NP])
          blk[d] |= 1u << s;
  }
}

// The nodes a crash storm holds down this tick.
template <class NM>
__device__ unsigned nem_down(const Args& a, const NM& nm, uint32_t gid,
                             uint32_t tu) {
  unsigned down = 0;
  for (int j = a.nem.start[NS_CRASH]; j < a.nem.start[NS_CRASH + 1]; ++j) {
    if (!nem_active(a, nm, j, tu)) continue;
    const uint32_t* c = a.nem.c[j];
    for (int k = 0; k < a.K; ++k)
      if (hash_u32(a.seed, TAG_NEM_CRASH, c[NCID], gid, k, tu / c[NA]) <
          c[NP])
        down |= 1u << k;
  }
  return down;
}

// The nodes whose disk is full this tick: each clause's target node,
// during the sub-epochs that fire.
template <class NM>
__device__ unsigned nem_full(const Args& a, const NM& nm, uint32_t gid,
                             uint32_t tu) {
  unsigned full = 0;
  for (int j = a.nem.start[NS_DISK]; j < a.nem.start[NS_DISK + 1]; ++j) {
    if (!nem_active(a, nm, j, tu)) continue;
    const uint32_t* c = a.nem.c[j];
    if (hash_u32(a.seed, TAG_NEM_DISK, c[NCID], gid, tu / c[NA]) < c[NP])
      full |= 1u << (hash_u32(a.seed, TAG_NEM_NODE, c[NCID], gid) %
                     static_cast<uint32_t>(a.K));
  }
  return full;
}

template <class NM>
__device__ bool nem_compact_block(const Args& a, const NM& nm, uint32_t gid,
                                  int i, uint32_t tu) {
  for (int j = a.nem.start[NS_COMPACT]; j < a.nem.start[NS_COMPACT + 1]; ++j)
    if (nem_active(a, nm, j, tu) &&
        hash_u32(a.seed, TAG_NEM_COMPACT, a.nem.c[j][NCID], gid, i,
                 tu / a.nem.c[j][NA]) < a.nem.c[j][NP])
      return true;
  return false;
}

// A deadline drawn by node i at tick tu, shifted by the active skew
// clauses (the signed amounts summed in int32) and clamped at 1.
template <class NM>
__device__ int nem_skewed(const Args& a, const NM& nm, uint32_t gid, int i,
                          uint32_t tu, int deadline) {
  if (a.nem.start[NS_SKEW] == a.nem.start[NS_SKEW + 1]) return deadline;
  uint32_t extra = 0;
  for (int j = a.nem.start[NS_SKEW]; j < a.nem.start[NS_SKEW + 1]; ++j)
    if (nem_active(a, nm, j, tu) &&
        hash_u32(a.seed, TAG_NEM_NODE, a.nem.c[j][NCID], gid, i) <
            a.nem.c[j][NP])
      extra += a.nem.c[j][NA];
  return max(1, static_cast<int>(static_cast<uint32_t>(deadline) + extra));
}

__device__ __forceinline__ int term_at(const Node& n, int idx, int L) {
  return idx == n.snap_index ? n.snap_term : n.lt[slot_of(idx, L)];
}

// One counted deadline draw, made at tick t.
template <class NM>
__device__ __forceinline__ void reset_timer(const Args& a, Node& n,
                                            uint32_t gid, int i, int t,
                                            const NM& nm) {
  n.ee = 0;
  n.deadline = election_deadline(a, gid, i, n.rng_draws);
  if constexpr (NEMESIS)
    n.deadline = nem_skewed(a, nm, gid, i, static_cast<uint32_t>(t),
                            n.deadline);
  n.rng_draws += 1;
}

// (voters, cfg_index) of the membership entry with the highest absolute
// index <= through in the live window, else the snapshot's config.
__device__ __forceinline__ void config_scan(const Args& a, const Node& n,
                                            int through, int& voters,
                                            int& cfg_index) {
  const int lim = min(n.last_index, through), base = n.snap_index % a.L;
  int best = 0, payload = 0;
  for (int l = 0; l < a.L; ++l) {
    int off = l - base;
    int ab = n.snap_index + 1 + (off >= 0 ? off : off + a.L);
    if ((n.lp[l] & CONFIG_FLAG) && ab <= lim && ab > best) {
      best = ab;
      payload = n.lp[l];
    }
  }
  voters = best > 0 ? payload & a.full_mask : n.snap_voters;
  cfg_index = best > 0 ? best : n.snap_index;
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

__device__ __forceinline__ void become_leader(const Args& a, Node& n, int i) {
  drop_reads(a, n);
  n.role = LEADER;
  n.leader_id = i;
  for (int p = 0; p < a.K; ++p) {
    n.next[p] = n.last_index + 1;
    n.match[p] = 0;
  }
  n.hb = a.heartbeat;
  // Takeover re-proposal: the top uncommitted entry takes the new term.
  if (n.last_index > n.commit) n.lt[slot_of(n.last_index, a.L)] = n.term;
}

template <class NM>
__device__ __forceinline__ void accept_leader(const Args& a, Node& n,
                                              uint32_t gid, int i, int src,
                                              int t, const NM& nm) {
  n.role = FOLLOWER;
  n.leader_id = src;
  n.votes = 0;
  n.le = 0;
  reset_timer(a, n, gid, i, t, nm);
}

// (majority-1)-th largest peer match index, the leader ranked first.
__device__ __forceinline__ int commit_candidate(const Args& a, const Node& n,
                                                int i) {
  if (a.majority == 1) return n.last_index;
  int v[KMAX];
  for (int p = 0; p < a.K; ++p) v[p] = p == i ? -1 : n.match[p];
  for (int p = 1; p < a.K; ++p) {   // insertion sort, descending
    int x = v[p], q = p - 1;
    while (q >= 0 && v[q] < x) { v[q + 1] = v[q]; --q; }
    v[q + 1] = x;
  }
  return v[a.majority - 2];
}

// Voters-aware tally: the majority(voters)-th largest replication index
// among voters, the leader counting its own last_index iff a voter; -1
// when there are no voters.
__device__ __forceinline__ int commit_candidate_voters(const Args& a,
                                                       const Node& n, int i,
                                                       int voters) {
  int v[KMAX];
  for (int p = 0; p < a.K; ++p)
    v[p] = !is_voter(voters, p) ? -1 : p == i ? n.last_index : n.match[p];
  for (int p = 1; p < a.K; ++p) {   // insertion sort, descending
    int x = v[p], q = p - 1;
    while (q >= 0 && v[q] < x) { v[q + 1] = v[q]; --q; }
    v[q + 1] = x;
  }
  return v[voter_majority(voters) - 1];
}

template <class NM>
__device__ __forceinline__ void start_election(const Args& a, Node& n,
                                               uint32_t gid, int i,
                                               int (*ob)[KMAX], int t,
                                               const NM& nm) {
  n.term += 1;
  n.role = CANDIDATE;
  n.voted_for = i;
  n.leader_id = NO_VOTE;
  n.votes = 1u << i;
  reset_timer(a, n, gid, i, t, nm);
  bool won = vote_quorum(a, n, n.votes);   // single-voter win
  if (won) become_leader(a, n, i);
  if (won) return;
  int llt = term_at(n, n.last_index, a.L);
  for (int p = 0; p < a.K; ++p) {
    if (p == i) continue;
    ob[RV_REQ_PRESENT][p] = 1;
    ob[RV_REQ_TERM][p] = n.term;
    ob[RV_REQ_LLI][p] = n.last_index;
    ob[RV_REQ_LLT][p] = llt;
  }
}

// ------------------------------------------------------------ one node

template <class N = Node, class CL = Clients, class NM = Nem>
__device__ void node_step(const Group& gr, int i, unsigned keep,
                          bool alive, int t, const CL& cl, const NM& nm) {
  const Args& a = gr.a;
  const int K = a.K, L = a.L, S = a.S;
  const uint32_t gid = gr.gid, tu = static_cast<uint32_t>(t);
  bool full = false;   // a full disk fails every append of this node
  if constexpr (NEMESIS) full = (nm.full >> i) & 1u;
  N n;
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
  for (int p = 0; p < K; ++p) {
    n.votes |= (gr.s(F_VOTES, i * K + p) != 0 ? 1u : 0u) << p;
    n.next[p] = gr.s(F_NEXT_INDEX, i * K + p);
    n.match[p] = gr.s(F_MATCH_INDEX, i * K + p);
  }
  n.ee = gr.s(F_ELECTION_ELAPSED, i);
  n.hb = gr.s(F_HEARTBEAT_ELAPSED, i);
  n.deadline = gr.s(F_DEADLINE, i);
  n.le = gr.s(F_LEADER_ELAPSED, i);
  if constexpr (READS) {
    for (int p = 0; p < K; ++p) n.ack[p] = gr.s(F_ACK_TIME, i * K + p);
    n.sri = gr.s(F_SCHED_READ_INDEX, i);
    n.srr = gr.s(F_SCHED_READ_REG, i);
    n.rdone = gr.s(F_READS_DONE, i);
  }
  if constexpr (CLIENTS) {
    for (int q = 0; q < S; ++q) {
      n.sess[q] = gr.s(F_SESSION_SEQ, i * S + q);
      n.snap_sess[q] = gr.s(F_SNAP_SESSION_SEQ, i * S + q);
    }
  }
  for (int l = 0; l < L; ++l) {
    n.lt[l] = gr.c(F_LOG_TERM, i * L + l);
    n.lp[l] = gr.c(F_LOG_PAYLOAD, i * L + l);
  }

  int ob[N_OB][KMAX];   // this node's outbox, by destination
  for (int r = 0; r < N_OB; ++r)
    for (int p = 0; p < K; ++p) ob[r][p] = 0;
#define OB(m, dst) ob[ob_row(m)][dst]

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
      reset_timer(a, n, gid, i, t, nm);
    }
    ob[RV_RESP_PRESENT][s] = 1;
    ob[RV_RESP_TERM][s] = n.term;
    ob[RV_RESP_GRANTED][s] = grant;
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
      accept_leader(a, n, gid, i, s, t, nm);
      bool past = prev > n.last_index;
      bool conflict = !past && prev >= n.snap_index &&
                      term_at(n, prev, L) != prev_term;
      if (past) {
        match = n.last_index + 1;
      } else if (conflict) {
        // Fast backup: one past the highest in-window index below prev
        // whose term differs from prev's.
        int ct = term_at(n, prev, L);
        int best = n.snap_index, base = n.snap_index % L;
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
          if (same_p || do_append) n.lt[sl] = et;
          if (do_append) n.lp[sl] = ep;
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
    ob[AE_RESP_PRESENT][s] = 1;
    ob[AE_RESP_TERM][s] = n.term;
    ob[AE_RESP_SUCCESS][s] = proceed;
    ob[AE_RESP_MATCH][s] = match;
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
        int nm = max(n.match[s], mm);
        n.match[s] = nm;
        n.next[s] = nm + 1;
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
      accept_leader(a, n, gid, i, s, t, nm);
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
          for (int q = 0; q < S; ++q) {
            const int v = gr.c(F_IS_REQ_SNAP_SESSIONS, (i * K + s) * S + q);
            n.sess[q] = v;
            n.snap_sess[q] = v;
          }
        }
        match = si;
      }
    }
    ob[IS_RESP_PRESENT][s] = 1;
    ob[IS_RESP_TERM][s] = n.term;
    ob[IS_RESP_MATCH][s] = match;
  }
  for (int s = 0; s < K; ++s) {   // InstallSnapshot response
    if (!PRESENT(IS_RESP_PRESENT, s)) continue;
    int mt = IN(IS_RESP_TERM, s), mm = IN(IS_RESP_MATCH, s);
    bool higher = mt > n.term;
    if (higher) step_down(a, n, mt);
    if (!higher && n.role == LEADER && mt == n.term) {
      if constexpr (READS) n.ack[s] = t;
      int nm = max(n.match[s], mm);
      n.match[s] = nm;
      n.next[s] = nm + 1;
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
        if (vote_quorum(a, n, n.votes))
          start_election(a, n, gid, i, ob, t, nm);
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
      if (go) start_election(a, n, gid, i, ob, t, nm);
    }
  }
#undef PRESENT
#undef IN

  // ---- phase T: heartbeat/replication broadcast, election timeout
  bool is_leader = n.role == LEADER;
  int hb = n.hb + 1;
  bool fire = is_leader && hb >= a.heartbeat;
  if (is_leader) n.hb = fire ? 0 : hb;
  if constexpr (CLIENTS)
    if (fire)
      for (int q = 0; q < S; ++q) n.sent_sess[q] = n.snap_sess[q];
  if (fire) {
    for (int p = 0; p < K; ++p) {
      if (p == i) continue;
      if (n.next[p] <= n.snap_index) {
        ob[IS_REQ_PRESENT][p] = 1;
        ob[IS_REQ_TERM][p] = n.term;
        ob[IS_REQ_SNAP_INDEX][p] = n.snap_index;
        ob[IS_REQ_SNAP_TERM][p] = n.snap_term;
        ob[IS_REQ_SNAP_DIGEST][p] = static_cast<int>(n.snap_digest);
        ob[IS_REQ_SNAP_VOTERS][p] = n.snap_voters;
      } else {
        int prev = n.next[p] - 1;
        ob[AE_REQ_PRESENT][p] = 1;
        ob[AE_REQ_TERM][p] = n.term;
        ob[AE_REQ_PREV_INDEX][p] = prev;
        ob[AE_REQ_PREV_TERM][p] = term_at(n, prev, L);
        ob[AE_REQ_N][p] = min(a.E, n.last_index - prev);
        ob[AE_REQ_COMMIT][p] = n.commit;
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
      reset_timer(a, n, gid, i, t, nm);
      if (vote_quorum(a, n, n.votes)) {   // one vote is a quorum
        start_election(a, n, gid, i, ob, t, nm);
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
    start_election(a, n, gid, i, ob, t, nm);
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
        int sl = slot_of(idx, L);
        n.lt[sl] = n.term;
        n.lp[sl] = CONFIG_FLAG | new_mask;
        n.last_index = idx;
      }
    }
  }
  bool stopped = false;   // the window filled: no further appends
  if constexpr (CLIENTS) {
    // The pulsed session ops in slot order; duplicates appended by two
    // transient leaders are safe by the exactly-once fold.
    if (lead) {
      for (int q = 0; q < S; ++q) {
        if (!cl.submit[q]) continue;
        int idx = n.last_index + 1;
        if (idx - n.snap_index > L || full) {
          stopped = true;
          break;
        }
        int sl = slot_of(idx, L);
        n.lt[sl] = n.term;
        n.lp[sl] = cl.pay[q];
        n.last_index = idx;
      }
    }
  }
  if (n.role == LEADER && !stopped && !full) {
    for (int c = 0; c < a.cmds; ++c) {
      int idx = n.last_index + 1;
      if (idx - n.snap_index > L) break;   // window full
      int sl = slot_of(idx, L);
      n.lt[sl] = n.term;
      n.lp[sl] = static_cast<int>(
          hash_u32(a.seed, TAG_CMD, gid, n.term, idx) & 0x3FFFFFFFu);
      n.last_index = idx;
    }
  }

  // ---- phase A: commit advance, removed-leader step-down, apply,
  // compaction, scheduled-read completion
  int voters = a.full_mask, cfg_index = n.snap_index;
  if constexpr (RECONFIG) config_scan(a, n, INT_MAX_, voters, cfg_index);
  const int nc = RECONFIG ? commit_candidate_voters(a, n, i, voters)
                          : commit_candidate(a, n, i);
  if (n.role == LEADER && nc > n.commit && term_at(n, nc, L) == n.term)
    n.commit = nc;
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
        fold = sid < S && seq > n.sess[sid];
        if (fold) n.sess[sid] = seq;
      }
    }
    if (fold) n.digest = digest_update(n.digest, idx, p);
    n.applied = idx;
  }
  bool compact = n.commit - n.snap_index >= a.compact;
  if constexpr (NEMESIS)
    if (compact) compact = !nem_compact_block(a, nm, gid, i, tu);
  if (compact) {
    if constexpr (CLIENTS)   // the live table folds into the snapshot's
      for (int q = 0; q < S; ++q) n.snap_sess[q] = n.sess[q];
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

  // ---- outbox (a dead sender's presence bits are erased) and freeze
#undef OB
  for (int r = 0; r < N_OB; ++r) {
    const int m = mb_of_row(r);
    for (int p = 0; p < K; ++p)
      gr.x(F_MB0 + m, p * K + i) =
          (is_presence(m) && !alive) ? 0 : ob[r][p];
  }
  if constexpr (CLIENTS) {   // InstallSnapshot's table, to each IS dst
    for (int p = 0; p < K; ++p)
      for (int q = 0; q < S; ++q)
        gr.x(F_IS_REQ_SNAP_SESSIONS, (p * K + i) * S + q) =
            ob[IS_REQ_PRESENT][p] ? n.sent_sess[q] : 0;
  }
  if (!alive) {
    for (int l = 0; l < L; ++l) {
      gr.x(F_LOG_TERM, i * L + l) = gr.c(F_LOG_TERM, i * L + l);
      gr.x(F_LOG_PAYLOAD, i * L + l) = gr.c(F_LOG_PAYLOAD, i * L + l);
    }
    return;
  }
  for (int l = 0; l < L; ++l) {
    gr.x(F_LOG_TERM, i * L + l) = n.lt[l];
    gr.x(F_LOG_PAYLOAD, i * L + l) = n.lp[l];
  }
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
  for (int p = 0; p < K; ++p) {
    gr.s(F_VOTES, i * K + p) = (n.votes >> p) & 1u;
    gr.s(F_NEXT_INDEX, i * K + p) = n.next[p];
    gr.s(F_MATCH_INDEX, i * K + p) = n.match[p];
  }
  gr.s(F_ELECTION_ELAPSED, i) = n.ee;
  gr.s(F_HEARTBEAT_ELAPSED, i) = n.hb;
  gr.s(F_DEADLINE, i) = n.deadline;
  gr.s(F_LEADER_ELAPSED, i) = n.le;
  if constexpr (READS) {
    for (int p = 0; p < K; ++p) gr.s(F_ACK_TIME, i * K + p) = n.ack[p];
    gr.s(F_SCHED_READ_INDEX, i) = n.sri;
    gr.s(F_SCHED_READ_REG, i) = n.srr;
    gr.s(F_READS_DONE, i) = n.rdone;
  }
  if constexpr (CLIENTS) {
    for (int q = 0; q < S; ++q) {
      gr.s(F_SESSION_SEQ, i * S + q) = n.sess[q];
      gr.s(F_SNAP_SESSION_SEQ, i * S + q) = n.snap_sess[q];
    }
  }
}

// Restart edge: durable state survives, volatile state rewinds.
__device__ void restart(const Group& gr, int i) {
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
  gr.s(F_DEADLINE, i) = election_deadline(a, gr.gid, i, draws);
  gr.s(F_RNG_DRAWS, i) = draws + 1;
  gr.s(F_SCHED_READ_INDEX, i) = -1;
  gr.s(F_READS_DONE, i) = 0;
  if constexpr (CLIENTS)   // the live dedup table rewinds to the snapshot's
    for (int q = 0; q < a.S; ++q)
      gr.s(F_SESSION_SEQ, i * a.S + q) = gr.s(F_SNAP_SESSION_SEQ, i * a.S + q);
}

// The per-tick safety predicate (sim/check.py `tick_safety`) on the
// post-tick state: window bounds, election safety, digest agreement,
// leader completeness.
__device__ bool tick_safety(const Group& gr) {
  const Args& a = gr.a;
  const int K = a.K, L = a.L;
  bool ok = true;
  for (int k = 0; k < K; ++k) {
    int ap = gr.s(F_APPLIED, k), cm = gr.s(F_COMMIT, k),
        sn = gr.s(F_SNAP_INDEX, k), li = gr.s(F_LAST_INDEX, k);
    ok = ok && ap == cm && sn <= cm && cm <= li && li - sn <= L;
  }
  for (int x = 0; x < K; ++x) {
    for (int y = x + 1; y < K; ++y) {
      if (gr.s(F_ROLE, x) == LEADER && gr.s(F_ROLE, y) == LEADER &&
          gr.s(F_TERM, x) == gr.s(F_TERM, y))
        ok = false;
      if (gr.s(F_APPLIED, x) == gr.s(F_APPLIED, y) &&
          gr.s(F_DIGEST, x) != gr.s(F_DIGEST, y))
        ok = false;
    }
  }
  // Leader completeness, over the absolute indices both windows hold
  // (the lanes where both slot maps agree) up to min(commit_b, last_a).
  for (int x = 0; x < K; ++x) {
    if (gr.s(F_ROLE, x) != LEADER) continue;
    int tx = gr.s(F_TERM, x), lx = gr.s(F_LAST_INDEX, x),
        sx = gr.s(F_SNAP_INDEX, x);
    for (int y = 0; y < K; ++y) {
      if (y == x || tx < gr.s(F_TERM, y)) continue;
      int cy = gr.s(F_COMMIT, y), sy = gr.s(F_SNAP_INDEX, y);
      if (cy > lx) { ok = false; continue; }
      int lo = max(sx, sy) + 1;
      int hi = min(min(sx, sy) + L, min(cy, lx));
      for (int idx = lo; idx <= hi; ++idx) {
        int sl = slot_of(idx, L);
        if (gr.x(F_LOG_PAYLOAD, x * L + sl) != gr.x(F_LOG_PAYLOAD, y * L + sl))
          ok = false;
      }
    }
  }
  return ok;
}

// The exactly-once clause of the safety fold, on the post-transition
// state: no table seq above its slot's issued frontier, and equal tables at
// equal applied prefixes.
template <class CL>
__device__ bool client_safety(const Group& gr, const CL& cl) {
  const Args& a = gr.a;
  const int K = a.K, S = a.S;
  bool ok = true;
  for (int k = 0; k < K; ++k)
    for (int q = 0; q < S; ++q)
      if (gr.s(F_SESSION_SEQ, k * S + q) > cl.done[q]) ok = false;
  for (int x = 0; x < K; ++x)
    for (int y = x + 1; y < K; ++y)
      if (gr.s(F_APPLIED, x) == gr.s(F_APPLIED, y))
        for (int q = 0; q < S; ++q)
          if (gr.s(F_SESSION_SEQ, x * S + q) != gr.s(F_SESSION_SEQ, y * S + q))
            ok = false;
  return ok;
}

// The client transition on the post-tick state (clients/workload.py
// `client_update`): per slot, the ack against the group's applied dedup
// tables, the open-loop arrival (bounded by the 1,024-op lifetime and, with
// a cap, by admission), the retry, the start. Ack events go to the
// ack-latency histogram; `cmax` keeps the longest ack latency.
template <class CL>
__device__ void client_update(const Group& gr, CL& cl, int t, int* acc,
                              int& cmax) {
  const Args& a = gr.a;
  const int K = a.K, S = a.S;
  for (int q = 0; q < S; ++q) {
    int tmax = gr.s(F_SESSION_SEQ, q);
    for (int k = 1; k < K; ++k) tmax = max(tmax, gr.s(F_SESSION_SEQ, k * S + q));
    const bool acked = cl.inflight[q] && tmax >= cl.done[q];
    cl.last_lat[q] = acked ? t - cl.t_start[q] : -1;
    if (acked) {
      cl.done[q] += 1;
      cl.inflight[q] = 0;
      if (a.hist > 0)
        atomicAdd(&acc[a.hist + 2 + min(cl.last_lat[q], a.hist - 1)], 1);
      cmax = max(cmax, cl.last_lat[q]);
    }
    bool arrive = cl.done[q] + cl.backlog[q] + cl.inflight[q] <= SEQ_MASK &&
                  hash_u32(a.seed, TAG_CLIENT_ARRIVAL, gr.gid, q, t) <
                      a.clients_u32;
    if (a.cap > 0 && arrive && cl.backlog[q] >= a.cap) {
      cl.shed[q] += 1;   // a definitive reject: no seq, no retry
      arrive = false;
    }
    cl.backlog[q] += arrive;
    // Retry before start: only an op that stayed in flight re-submits.
    const bool retry = cl.inflight[q] && t - cl.t_sub[q] >= a.backoff;
    const bool start = !cl.inflight[q] && cl.backlog[q] > 0;
    if (start) {
      cl.backlog[q] -= 1;
      cl.inflight[q] = 1;
      cl.t_start[q] = t;
    }
    if (start || retry) cl.t_sub[q] = t;
    cl.submit[q] = start || retry;
    cl.retries[q] += retry;
  }
}

// The client state's wire rows (`load`: wire -> cl, else cl -> wire).
template <class CL>
__device__ void client_rows(const Group& gr, CL& cl, bool load) {
  const Args& a = gr.a;
  int* rows[] = {cl.done, cl.backlog, cl.inflight, cl.t_start, cl.t_sub,
                 cl.submit, cl.retries, cl.last_lat, cl.shed};
  const int n = a.cap > 0 ? 9 : 8;   // the shed row rides with a cap only
  for (int f = 0; f < n; ++f)
    for (int q = 0; q < a.S; ++q) {
      int& w = gr.s(F_CLIENTS_DONE + f, q);
      if (load) rows[f][q] = w;
      else w = rows[f][q];
    }
}

// A template over the client state's type, so that a build without clients
// never instantiates the code that names its members, and over the flight
// ring (see the head of the file).
template <class CL, class NM, bool FLIGHT>
__global__ void __launch_bounds__(128)
fused_chunk_kernel(const int* __restrict__ wire_in, int* __restrict__ out,
                   int* __restrict__ scratch, int* __restrict__ acc,
                   const __grid_constant__ Args a) {
  const int gi = blockIdx.x * blockDim.x + threadIdx.x;
  if (gi >= a.G) return;
  const size_t G = a.G;
  if (wire_in != nullptr)   // null: the tick runs in place on `out`
    for (int r = 0; r < a.n_words; ++r)
      out[(size_t)r * G + gi] = wire_in[(size_t)r * G + gi];

  int* db[2] = {out + (size_t)a.db_start * G, scratch};
  Group gr{a, out, db[0], db[1], G, gi, 0u};
  gr.gid = static_cast<uint32_t>(gr.s(F_GROUP_ID, 0));
  const int K = a.K;
  const unsigned full = (1u << K) - 1u;

  unsigned alive_prev = 0;
  for (int k = 0; k < K; ++k)
    alive_prev |= (gr.s(F_ALIVE_PREV, k) != 0 ? 1u : 0u) << k;
  int committed = gr.s(F_COMMITTED, 0);
  int leaderless = gr.s(F_LEADERLESS, 0);
  int safety = gr.s(F_SAFETY, 0);
  int elections = 0, max_latency = 0;
  CL cl;
  int cmax = 0;   // longest ack latency this launch
  if constexpr (CLIENTS) client_rows(gr, cl, true);
  NM nm;
  if constexpr (NEMESIS) nem_participate(a, nm, gr.gid);

  for (int tt = 0; tt < a.n_ticks; ++tt) {
    const uint32_t tu = static_cast<uint32_t>(a.t0 + tt);
    gr.cur = db[tt & 1];
    gr.nxt = db[(tt + 1) & 1];

    unsigned alive = full;
    if (a.crash_u32 != 0) {
      uint32_t epoch = tu / static_cast<uint32_t>(a.crash_epoch);
      alive = 0;
      for (int k = 0; k < K; ++k)
        if (hash_u32(a.seed, TAG_CRASH, gr.gid, k, epoch) >= a.crash_u32)
          alive |= 1u << k;
    }
    if constexpr (NEMESIS) alive &= ~nem_down(a, nm, gr.gid, tu);
    unsigned edge = alive & ~alive_prev;
    for (int k = 0; k < K; ++k) {
      if (!((edge >> k) & 1u)) continue;
      restart(gr, k);
      if constexpr (NEMESIS)   // the restart's deadline draw, skewed
        gr.s(F_DEADLINE, k) =
            nem_skewed(a, nm, gr.gid, k, tu, gr.s(F_DEADLINE, k));
    }

    bool part_active = false;
    unsigned side = 0;
    if (a.partition_u32 != 0) {
      uint32_t epoch = tu / static_cast<uint32_t>(a.partition_epoch);
      part_active =
          hash_u32(a.seed, TAG_PART, gr.gid, epoch) < a.partition_u32;
      for (int k = 0; k < K; ++k)
        side |= (hash_u32(a.seed, TAG_PART_SIDE, gr.gid, epoch, k) & 1u)
                << k;
    }
    if constexpr (CLIENTS) {
      // The payloads of the ops the previous tick's transition pulsed
      // (seq = done; the value hashes the op identity, so a retry is
      // byte-identical).
      for (int q = 0; q < a.S; ++q)
        if (cl.submit[q])
          cl.pay[q] = SESSION_FLAG | (q << SID_SHIFT) |
                      (cl.done[q] << SEQ_SHIFT) |
                      static_cast<int>(hash_u32(a.seed, TAG_CLIENT_VAL,
                                                gr.gid, q, cl.done[q]) &
                                       VAL_MASK);
    }
    unsigned blk[KMAX];   // link clauses' drops, by dst (bit = src)
    if constexpr (NEMESIS) {
      nem_links(a, nm, gr.gid, tu, blk);
      nm.full = nem_full(a, nm, gr.gid, tu);
    }
    for (int i = 0; i < K; ++i) {
      bool alive_i = (alive >> i) & 1u;
      unsigned keep = 0;   // delivery filter for dst = i, by src
      if (alive_i) {
        for (int s = 0; s < K; ++s) {
          bool cut = part_active && (((side >> s) ^ (side >> i)) & 1u);
          bool drop = a.drop_u32 != 0 &&
                      hash_u32(a.seed, TAG_DROP, gr.gid, tu, s, i) <
                          a.drop_u32;
          if (!cut && !drop) keep |= 1u << s;
        }
        if constexpr (NEMESIS) keep &= ~blk[i];
      }
      node_step<Node, CL, NM>(gr, i, keep, alive_i, a.t0 + tt, cl, nm);
    }
    alive_prev = alive;
    if constexpr (CLIENTS) client_update(gr, cl, a.t0 + tt, acc, cmax);

    // metrics on the post-tick state
    bool has_leader = false;
    for (int k = 0; k < K; ++k) {
      committed = max(committed, gr.s(F_COMMIT, k));
      if (gr.s(F_ROLE, k) == LEADER && ((alive >> k) & 1u)) has_leader = true;
    }
    const bool elected = has_leader && leaderless > 0;
    if (elected) {
      if (a.hist > 0) atomicAdd(&acc[min(leaderless, a.hist - 1)], 1);
      elections += 1;
      max_latency = max(max_latency, leaderless);
    }
    leaderless = has_leader ? 0 : leaderless + 1;
    bool safe = tick_safety(gr);
    if constexpr (CLIENTS) safe = safe && client_safety(gr, cl);
    if (!safe) safety = 0;

    if constexpr (FLIGHT) {   // the flight ring: row t % ring
      const int row = static_cast<int>(tu % static_cast<uint32_t>(a.ring));
      int leaders = 0, top = gr.s(F_COMMIT, 0), msgs = 0;
      for (int k = 0; k < K; ++k) {
        leaders += gr.s(F_ROLE, k) == LEADER && ((alive >> k) & 1u);
        top = max(top, gr.s(F_COMMIT, k));
      }
      for (int r = 0; r < N_OB; ++r) {   // the occupied outbox slots
        const int m = mb_of_row(r);
        if (!is_presence(m)) continue;
        for (int q = 0; q < K * K; ++q) msgs += gr.x(F_MB0 + m, q);
      }
      gr.s(F_FLIGHT_TICK, row) = a.t0 + tt;
      gr.s(F_FLIGHT_LEADERS, row) = leaders;
      gr.s(F_FLIGHT_ELECTIONS, row) = elected;
      gr.s(F_FLIGHT_COMMIT, row) = top;
      gr.s(F_FLIGHT_MSGS, row) = msgs;
      gr.s(F_FLIGHT_SAFETY, row) = safe;
    }
  }

  if (a.n_ticks & 1) {   // the last tick wrote the scratch buffer
    for (int r = 0; r < a.db_words; ++r)
      db[0][(size_t)r * G + gi] = scratch[(size_t)r * G + gi];
  }
  for (int k = 0; k < K; ++k) gr.s(F_ALIVE_PREV, k) = (alive_prev >> k) & 1u;
  gr.s(F_COMMITTED, 0) = committed;
  gr.s(F_LEADERLESS, 0) = leaderless;
  gr.s(F_SAFETY, 0) = safety;
  if (elections) atomicAdd(&acc[a.hist], elections);
  if (max_latency) atomicMax(&acc[a.hist + 1], max_latency);
  if constexpr (CLIENTS) {
    client_rows(gr, cl, false);
    // The acked / retry lanes are sums of monotone counters, so their
    // values after the last tick are what a per-tick recompute leaves.
    if (a.n_ticks > 0) {
      int acked = 0, retries = 0;
      for (int q = 0; q < a.S; ++q) {
        acked += cl.done[q];
        retries += cl.retries[q];
      }
      gr.s(F_CLIENT_ACKED, 0) = acked;
      gr.s(F_CLIENT_RETRIES, 0) = retries;
    }
    if (cmax) atomicMax(&acc[2 * a.hist + 2], cmax);
  }
}

}  // namespace

// Launch on `stream`; a null `wire_in` runs in place on `wire_out`.
// `offsets` (n_offsets == N_FIELDS ints, -1 for a
// field the config does not carry), `params` (n_params == N_PARAMS
// int64s) and `nem` (the seams' clause counts, then the clauses' 8 words
// each, grouped by seam; n_nem words) are host arrays. Returns the
// cudaGetLastError() of the launch (0 = launched), -1 on a bad argument,
// -2 when the config's feature flags are not this build's.
extern "C" int fused_chunk_launch(const void* wire_in, void* wire_out,
                                  void* scratch, void* acc,
                                  const int* offsets, int n_offsets,
                                  const long long* params, int n_params,
                                  const unsigned* nem, int n_nem,
                                  void* stream) {
  if (n_offsets != N_FIELDS || n_params != N_PARAMS) return -1;
  Args a;
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
  if (a.K < 1 || a.K > KMAX || a.L < 1 || a.L > LMAX || a.G < 1 ||
      a.ring < 0 || a.hist < 0 || (CLIENTS && (a.S < 1 || a.S > SMAX)))
    return -1;
  // The config's feature flags must be this build's.
  if (params[P_PREVOTE] != PREVOTE || params[P_TRANSFER] != TRANSFER ||
      params[P_RECONFIG] != RECONFIG || params[P_READS] != READS ||
      params[P_CLIENTS] != CLIENTS || params[P_NEMESIS] != NEMESIS)
    return -2;
  for (int f = 0; f < N_FIELDS; ++f) a.off[f] = offsets[f];
  if (n_nem < N_SEAMS) return -1;
  a.nem.start[0] = 0;
  for (int s = 0; s < N_SEAMS; ++s) {
    if (static_cast<int>(nem[s]) < 0) return -1;
    a.nem.start[s + 1] = a.nem.start[s] + static_cast<int>(nem[s]);
  }
  const int n_clauses = a.nem.start[N_SEAMS];
  if (n_clauses > (NEMESIS ? NEM_MAX : 0) ||
      n_nem != N_SEAMS + 8 * n_clauses)
    return -1;
  for (int j = 0; j < n_clauses; ++j)
    for (int w = 0; w < 8; ++w) a.nem.c[j][w] = nem[N_SEAMS + 8 * j + w];
  const int threads = 128;
  const int blocks = (a.G + threads - 1) / threads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* in = static_cast<const int*>(wire_in);
  int* o = static_cast<int*>(wire_out);
  int* sc = static_cast<int*>(scratch);
  int* ac = static_cast<int*>(acc);
  if (a.ring > 0)
    fused_chunk_kernel<Clients, Nem, true><<<blocks, threads, 0, st>>>(
        in, o, sc, ac, a);
  else
    fused_chunk_kernel<Clients, Nem, false><<<blocks, threads, 0, st>>>(
        in, o, sc, ac, a);
  return static_cast<int>(cudaGetLastError());
}
