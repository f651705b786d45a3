// Fused-chunk Raft tick for Hopper (sm_90a): `n_ticks` whole ticks of the
// batched simulation per launch, one thread per Raft group.
//
// Replaces the JAX package's Pallas kernel raft_tpu/sim/pkernel.py:1950
// (`_build_kernel` -> `kernel`, launched by `_prun_padded_impl` through
// `pl.pallas_call`), for the features this slice ports: RequestVote,
// AppendEntries, InstallSnapshot, fire-hose commands, commit/apply/
// compaction, crash/partition/drop faults, the election-latency histogram
// and the per-tick safety fold. It computes what `raft_tpu_torch.sim.run.run`
// computes over the same ticks (the plain PyTorch tick, sim/step.py), bit for
// bit; chip_smoke.py holds the two equal on the card.
//
// Design. Groups never talk to each other, so each thread steps its own
// group through the tick loop sequentially: nodes 0..K-1, each through the
// six handler types in canonical (type, src) order, then phases T, C, A —
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
// integer atomics into `acc` (exact in any order).
//
// What bounds it on the H100: the per-tick state stays in device memory
// (about 4.7 KB per group; at 100K groups far more than the 50 MB L2), so
// every tick streams each group's mailbox, rings and scalars through HBM
// and local memory; the integer work per group-tick is a few thousand
// operations. PERF.md records the measured time beside both bounds. Where
// the per-group state should live instead (registers or shared memory
// across the tick loop) is left to a later change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int KMAX = 8;    // kernel.py refuses larger k
constexpr int LMAX = 64;   // kernel.py refuses larger log_cap

constexpr uint32_t GOLD = 0x9E3779B9u;
constexpr uint32_t SEED0 = 0x243F6A88u;
constexpr uint32_t TAG_TIMEOUT = 1, TAG_DROP = 2, TAG_CRASH = 3,
                   TAG_PART = 4, TAG_PART_SIDE = 5, TAG_CMD = 6;
constexpr int FOLLOWER = 0, CANDIDATE = 1, LEADER = 2, NO_VOTE = -1;

// Wire fields, in the order of kernel.py `WIRE_FIELDS`. The offsets come
// from the wrapper; fields from F_LOG_TERM on are relative to the start of
// the double-buffered region.
enum Field {
  F_TERM, F_VOTED_FOR, F_SNAP_INDEX, F_SNAP_TERM, F_SNAP_DIGEST,
  F_SNAP_VOTERS, F_RNG_DRAWS, F_LAST_INDEX, F_ROLE, F_LEADER_ID, F_COMMIT,
  F_APPLIED, F_DIGEST, F_VOTES, F_NEXT_INDEX, F_MATCH_INDEX,
  F_ELECTION_ELAPSED, F_HEARTBEAT_ELAPSED, F_DEADLINE, F_LEADER_ELAPSED,
  F_ACK_TIME, F_SCHED_READ_INDEX, F_SCHED_READ_REG, F_READS_DONE,
  F_ALIVE_PREV, F_GROUP_ID, F_COMMITTED, F_LEADERLESS, F_SAFETY,
  F_LOG_TERM, F_LOG_PAYLOAD,
  F_MB0,   // first mailbox field; the mailbox fields follow in Mb order
  N_FIELDS = F_MB0 + 26
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
  N_MB
};

__device__ __forceinline__ bool is_presence(int m) {
  return m == RV_REQ_PRESENT || m == RV_RESP_PRESENT ||
         m == AE_REQ_PRESENT || m == AE_RESP_PRESENT ||
         m == IS_REQ_PRESENT || m == IS_RESP_PRESENT;
}

// Parameters of the launch, in the order of kernel.py `_params`.
enum Param {
  P_G, P_K, P_L, P_E, P_SEED, P_ELECTION_MIN, P_ELECTION_RANGE,
  P_HEARTBEAT, P_COMPACT, P_CMDS, P_CRASH_U32, P_CRASH_EPOCH,
  P_PARTITION_U32, P_PARTITION_EPOCH, P_DROP_U32, P_MAJORITY, P_FULL_MASK,
  P_HIST, P_N_WORDS, P_DB_START, P_DB_WORDS, P_T0, P_N_TICKS,
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
  int off[N_FIELDS];
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

struct Node {
  int term, voted_for, snap_index, snap_term;
  uint32_t snap_digest;
  int snap_voters, rng_draws, last_index, role, leader_id, commit, applied;
  uint32_t digest;
  unsigned votes;   // bit p = vote granted by p
  int next[KMAX], match[KMAX];
  int ee, hb, deadline, le;
  int lt[LMAX], lp[LMAX];   // own ring, this tick's working copy
};

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

__device__ __forceinline__ int term_at(const Node& n, int idx, int L) {
  return idx == n.snap_index ? n.snap_term : n.lt[slot_of(idx, L)];
}

__device__ __forceinline__ void reset_timer(const Args& a, Node& n,
                                            uint32_t gid, int i) {
  n.ee = 0;
  n.deadline = election_deadline(a, gid, i, n.rng_draws);
  n.rng_draws += 1;
}

__device__ __forceinline__ void step_down(Node& n, int new_term) {
  n.term = new_term;
  n.role = FOLLOWER;
  n.voted_for = NO_VOTE;
  n.leader_id = NO_VOTE;
  n.votes = 0;
}

__device__ __forceinline__ void become_leader(const Args& a, Node& n, int i) {
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

__device__ __forceinline__ void accept_leader(const Args& a, Node& n,
                                              uint32_t gid, int i, int src) {
  n.role = FOLLOWER;
  n.leader_id = src;
  n.votes = 0;
  n.le = 0;
  reset_timer(a, n, gid, i);
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

__device__ __forceinline__ void start_election(const Args& a, Node& n,
                                               uint32_t gid, int i,
                                               int (*ob)[KMAX]) {
  n.term += 1;
  n.role = CANDIDATE;
  n.voted_for = i;
  n.leader_id = NO_VOTE;
  n.votes = 1u << i;
  reset_timer(a, n, gid, i);
  bool won = __popc(n.votes) >= a.majority;   // single-voter win
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

__device__ void node_step(const Group& gr, int i, unsigned keep,
                          bool alive) {
  const Args& a = gr.a;
  const int K = a.K, L = a.L;
  const uint32_t gid = gr.gid;
  Node n;
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
  for (int l = 0; l < L; ++l) {
    n.lt[l] = gr.c(F_LOG_TERM, i * L + l);
    n.lp[l] = gr.c(F_LOG_PAYLOAD, i * L + l);
  }

  int ob[N_MB][KMAX];   // this node's outbox, by destination
  for (int m = 0; m < N_MB; ++m)
    for (int p = 0; p < K; ++p) ob[m][p] = 0;

  // inbox field m from src (dst = i), as delivered this tick
#define IN(m, src) gr.c(F_MB0 + (m), i * K + (src))
#define PRESENT(m, src) (((keep >> (src)) & 1u) && IN(m, src) != 0)

  // ---- phase D: canonical (type, src) order
  for (int s = 0; s < K; ++s) {   // RequestVote request
    if (!PRESENT(RV_REQ_PRESENT, s)) continue;
    int mt = IN(RV_REQ_TERM, s), lli = IN(RV_REQ_LLI, s),
        llt = IN(RV_REQ_LLT, s);
    if (mt > n.term) step_down(n, mt);
    int my_llt = term_at(n, n.last_index, L);
    bool log_ok = llt > my_llt || (llt == my_llt && lli >= n.last_index);
    bool grant = mt == n.term &&
                 (n.voted_for == NO_VOTE || n.voted_for == s) && log_ok;
    if (grant) {
      n.voted_for = s;
      reset_timer(a, n, gid, i);
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
    if (higher) step_down(n, mt);
    if (!higher && n.role == CANDIDATE && mt == n.term && granted) {
      n.votes |= 1u << s;
      if (__popc(n.votes) >= a.majority) become_leader(a, n, i);
    }
  }
  for (int s = 0; s < K; ++s) {   // AppendEntries request
    if (!PRESENT(AE_REQ_PRESENT, s)) continue;
    int mt = IN(AE_REQ_TERM, s), prev = IN(AE_REQ_PREV_INDEX, s),
        prev_term = IN(AE_REQ_PREV_TERM, s), mn = IN(AE_REQ_N, s),
        mcommit = IN(AE_REQ_COMMIT, s);
    if (mt > n.term) step_down(n, mt);
    bool proceed = false;
    int match = 0;
    if (mt >= n.term) {   // not stale
      accept_leader(a, n, gid, i, s);
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
          bool room = idx - n.snap_index <= L;
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
    if (higher) step_down(n, mt);
    if (!higher && n.role == LEADER && mt == n.term) {
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
    if (mt > n.term) step_down(n, mt);
    int match = 0;
    if (mt >= n.term) {
      accept_leader(a, n, gid, i, s);
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
    if (higher) step_down(n, mt);
    if (!higher && n.role == LEADER && mt == n.term) {
      int nm = max(n.match[s], mm);
      n.match[s] = nm;
      n.next[s] = nm + 1;
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
  int ee = n.ee + 1;
  bool timeout = !is_leader && ee >= n.deadline;
  if (!is_leader) n.ee = ee;
  n.le = is_leader ? 0 : n.le + 1;
  if (timeout) start_election(a, n, gid, i, ob);

  // ---- phase C: fire-hose command appends
  if (n.role == LEADER) {
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

  // ---- phase A: commit advance, apply, compaction
  int nc = commit_candidate(a, n, i);
  if (n.role == LEADER && nc > n.commit && term_at(n, nc, L) == n.term)
    n.commit = nc;
  for (int st = 0; st < L && n.applied + 1 <= n.commit; ++st) {
    int idx = n.applied + 1;
    n.digest = digest_update(n.digest, idx, n.lp[slot_of(idx, L)]);
    n.applied = idx;
  }
  if (n.commit - n.snap_index >= a.compact) {
    n.snap_term = term_at(n, n.commit, L);
    n.snap_voters = a.full_mask;
    n.snap_index = n.commit;
    n.snap_digest = n.digest;
  }

  // ---- outbox (a dead sender's presence bits are erased) and freeze
  for (int m = 0; m < N_MB; ++m)
    for (int p = 0; p < K; ++p)
      gr.x(F_MB0 + m, p * K + i) =
          (is_presence(m) && !alive) ? 0 : ob[m][p];
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

__global__ void __launch_bounds__(128)
fused_chunk_kernel(const int* __restrict__ wire_in, int* __restrict__ out,
                   int* __restrict__ scratch, int* __restrict__ acc,
                   const __grid_constant__ Args a) {
  const int gi = blockIdx.x * blockDim.x + threadIdx.x;
  if (gi >= a.G) return;
  const size_t G = a.G;
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
    unsigned edge = alive & ~alive_prev;
    for (int k = 0; k < K; ++k)
      if ((edge >> k) & 1u) restart(gr, k);

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
      }
      node_step(gr, i, keep, alive_i);
    }
    alive_prev = alive;

    // metrics on the post-tick state
    bool has_leader = false;
    for (int k = 0; k < K; ++k) {
      committed = max(committed, gr.s(F_COMMIT, k));
      if (gr.s(F_ROLE, k) == LEADER && ((alive >> k) & 1u)) has_leader = true;
    }
    if (has_leader && leaderless > 0) {
      atomicAdd(&acc[min(leaderless, a.hist - 1)], 1);
      elections += 1;
      max_latency = max(max_latency, leaderless);
    }
    leaderless = has_leader ? 0 : leaderless + 1;
    if (!tick_safety(gr)) safety = 0;
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
}

}  // namespace

// Launch on `stream`. `offsets` (n_offsets == N_FIELDS ints) and `params`
// (n_params == N_PARAMS int64s) are host arrays. Returns the
// cudaGetLastError() of the launch (0 = launched), or -1 on a bad argument.
extern "C" int fused_chunk_launch(const void* wire_in, void* wire_out,
                                  void* scratch, void* acc,
                                  const int* offsets, int n_offsets,
                                  const long long* params, int n_params,
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
  if (a.K < 1 || a.K > KMAX || a.L < 1 || a.L > LMAX || a.G < 1) return -1;
  for (int f = 0; f < N_FIELDS; ++f) a.off[f] = offsets[f];
  const int threads = 128;
  const int blocks = (a.G + threads - 1) / threads;
  fused_chunk_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(wire_in), static_cast<int*>(wire_out),
      static_cast<int*>(scratch), static_cast<int*>(acc), a);
  return static_cast<int>(cudaGetLastError());
}
