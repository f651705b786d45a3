// The packed wire codec for Hopper (sm_90a): the wire at rest between
// fused-chunk launches <-> the full-width working wire the tick kernel runs
// on, one thread per Raft group.
//
// Replaces the wire codec of the JAX package's Pallas kernel,
// raft_tpu/sim/pkernel.py `_pack_wire` (:1847) and `_unpack_wire` (:1901),
// with `_ring_base_ov` (:1837) and the registry `_wire_state_leaves` (:163),
// which the TPU kernel runs at the entry and exit of every grid step. Here
// the codec is two kernels of its own that run only at the launch boundary
// (kernel.py `kstep`: unpack -> the unchanged tick kernel, in place on the
// working wire -> pack), so the tick kernel stays blind to the layout and
// its builds are not touched. Plain versions: kernel.py `unpack`, `pack`.
//
// Layout. Both forms are int32 [rows, G], structure of arrays with the
// group axis minor, so neighbouring threads touch neighbouring addresses.
// The at-rest form rewrites a few fields of the working form in place
// (kernel.py `_layout`): `votes` as one bit lane per node (bit = peer),
// `alive_prev` as one word (bit = node), every bool mailbox slot in
// `mb_words` shared words per destination (bit = field x K + src), and
// `log_term` as 16-bit deltas two to a word (slot 2j low, 2j + 1 high)
// against a per-group base word, the min term over the [K, L] ring, whose
// bit 31 is the sticky overflow flag: set when the spread above the base
// exceeds 0xFFFF, ORed with the flag the wire came in with. Every other row
// is copied as it is; the host sends those as runs of rows.
//
// What bounds it on the H100: bytes. Each thread reads its group's column of
// one form and writes the other's, each word once (the ring is read twice,
// the second time from cache), with a few integer operations per word: at
// 100,000 headline groups 3,544 + 4,716 bytes a group, about 0.25 ms at
// 3.35 TB/s. The design keeps every access coalesced across a warp and
// needs no shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_RUNS = 96;   // runs of rows copied as they are
constexpr int MAX_MB = 16;     // bool mailbox slots (12 with every feature)
constexpr int MAX_WORDS = 8;   // shared words per destination

struct Codec {
  int G, K, L;
  // working row, at-rest row (-1 when the field is not rewritten)
  int votes_w, votes_p, alive_w, alive_p, ring_w, ring_p;
  int base_p;                  // the ring base lane's at-rest row
  int mb_p, mb_words, n_mb;    // the shared bool rows, words per dst, slots
  int mb_w[MAX_MB];            // each bool slot's first working row
  int n_runs;
  int runs[MAX_RUNS][3];       // working row, at-rest row, rows
};

__global__ void __launch_bounds__(256)
wire_unpack_kernel(const int* __restrict__ packed, int* __restrict__ wire,
                   const __grid_constant__ Codec c) {
  const int gi = blockIdx.x * blockDim.x + threadIdx.x;
  if (gi >= c.G) return;
  const size_t G = c.G;
  auto in = [&](int r) {
    return static_cast<uint32_t>(packed[static_cast<size_t>(r) * G + gi]);
  };
  auto put = [&](int r, uint32_t v) {
    wire[static_cast<size_t>(r) * G + gi] = static_cast<int>(v);
  };
  for (int s = 0; s < c.n_runs; ++s)
    for (int r = 0; r < c.runs[s][2]; ++r)
      put(c.runs[s][0] + r, in(c.runs[s][1] + r));
  const int K = c.K;
  if (c.votes_p >= 0)
    for (int i = 0; i < K; ++i) {
      const uint32_t w = in(c.votes_p + i);
      for (int q = 0; q < K; ++q) put(c.votes_w + i * K + q, (w >> q) & 1u);
    }
  if (c.alive_p >= 0) {
    const uint32_t w = in(c.alive_p);
    for (int j = 0; j < K; ++j) put(c.alive_w + j, (w >> j) & 1u);
  }
  if (c.mb_p >= 0)
    for (int d = 0; d < K; ++d) {
      uint32_t words[MAX_WORDS];
      for (int j = 0; j < c.mb_words; ++j)
        words[j] = in(c.mb_p + d * c.mb_words + j);
      for (int f = 0; f < c.n_mb; ++f)
        for (int s = 0; s < K; ++s) {
          const int b = f * K + s;
          put(c.mb_w[f] + d * K + s, (words[b / 32] >> (b % 32)) & 1u);
        }
    }
  if (c.ring_p >= 0) {
    const uint32_t base = in(c.base_p) & 0x7FFFFFFFu;
    const int half = c.L / 2;
    for (int i = 0; i < K; ++i)
      for (int j = 0; j < half; ++j) {
        const uint32_t w = in(c.ring_p + i * half + j);
        put(c.ring_w + i * c.L + 2 * j, base + (w & 0xFFFFu));
        put(c.ring_w + i * c.L + 2 * j + 1, base + (w >> 16));
      }
  }
}

// `flags` is the at-rest base row whose bit 31 carries each group's incoming
// overflow flag, or null for a fresh encode. It may lie inside `packed` (the
// output written over the input), so neither is __restrict__: each thread
// reads its own flag before it writes anything.
__global__ void __launch_bounds__(256)
wire_pack_kernel(const int* __restrict__ wire, int* packed, const int* flags,
                 const __grid_constant__ Codec c) {
  const int gi = blockIdx.x * blockDim.x + threadIdx.x;
  if (gi >= c.G) return;
  const size_t G = c.G;
  const uint32_t ov_in =
      flags ? static_cast<uint32_t>(flags[gi]) >> 31 : 0u;
  auto in = [&](int r) { return wire[static_cast<size_t>(r) * G + gi]; };
  auto put = [&](int r, uint32_t v) {
    packed[static_cast<size_t>(r) * G + gi] = static_cast<int>(v);
  };
  for (int s = 0; s < c.n_runs; ++s)
    for (int r = 0; r < c.runs[s][2]; ++r)
      put(c.runs[s][1] + r, static_cast<uint32_t>(in(c.runs[s][0] + r)));
  const int K = c.K;
  if (c.votes_p >= 0)
    for (int i = 0; i < K; ++i) {
      uint32_t w = 0;
      for (int q = 0; q < K; ++q)
        w |= (static_cast<uint32_t>(in(c.votes_w + i * K + q)) & 1u) << q;
      put(c.votes_p + i, w);
    }
  if (c.alive_p >= 0) {
    uint32_t w = 0;
    for (int j = 0; j < K; ++j)
      w |= (static_cast<uint32_t>(in(c.alive_w + j)) & 1u) << j;
    put(c.alive_p, w);
  }
  if (c.mb_p >= 0)
    for (int d = 0; d < K; ++d) {
      uint32_t words[MAX_WORDS] = {};
      for (int f = 0; f < c.n_mb; ++f)
        for (int s = 0; s < K; ++s) {
          const int b = f * K + s;
          words[b / 32] |=
              (static_cast<uint32_t>(in(c.mb_w[f] + d * K + s)) & 1u)
              << (b % 32);
        }
      for (int j = 0; j < c.mb_words; ++j)
        put(c.mb_p + d * c.mb_words + j, words[j]);
    }
  if (c.ring_p >= 0) {
    const int n = K * c.L;
    int lo = in(c.ring_w), hi = lo;
    for (int r = 1; r < n; ++r) {
      const int v = in(c.ring_w + r);
      lo = min(lo, v);
      hi = max(hi, v);
    }
    const uint32_t ov =
        (static_cast<long long>(hi) - lo > 0xFFFF ? 1u : 0u) | ov_in;
    const uint32_t base = static_cast<uint32_t>(lo);
    for (int r = 0; r < n / 2; ++r) {
      const uint32_t d0 =
          (static_cast<uint32_t>(in(c.ring_w + 2 * r)) - base) & 0xFFFFu;
      const uint32_t d1 =
          (static_cast<uint32_t>(in(c.ring_w + 2 * r + 1)) - base) & 0xFFFFu;
      put(c.ring_p + r, d0 | (d1 << 16));
    }
    put(c.base_p, base | (ov << 31));
  }
}

// The host plan (kernel.py `_codec_plan`): K, L, votes (working, at-rest),
// alive_prev (working, at-rest), log_term (working, at-rest), the base row,
// the shared bool rows, words per dst, the bool slots' count and working
// rows, then the runs' count and (working, at-rest, rows) each. Returns
// false on a plan the kernels cannot take.
bool parse(const int* plan, int n_plan, int G, Codec& c) {
  if (n_plan < 12) return false;
  c.G = G;
  c.K = plan[0];
  c.L = plan[1];
  c.votes_w = plan[2];
  c.votes_p = plan[3];
  c.alive_w = plan[4];
  c.alive_p = plan[5];
  c.ring_w = plan[6];
  c.ring_p = plan[7];
  c.base_p = plan[8];
  c.mb_p = plan[9];
  c.mb_words = plan[10];
  c.n_mb = plan[11];
  if (G < 1 || c.K < 1 || c.K > 8 || c.L < 1 ||
      (c.ring_p >= 0 && c.L % 2) ||
      c.n_mb < 0 || c.n_mb > MAX_MB || c.mb_words < 0 ||
      c.mb_words > MAX_WORDS || (c.mb_p >= 0) != (c.n_mb > 0) ||
      c.n_mb * c.K > 32 * c.mb_words || (c.ring_p >= 0) != (c.base_p >= 0))
    return false;
  int at = 12;
  if (n_plan < at + c.n_mb + 1) return false;
  for (int f = 0; f < c.n_mb; ++f) c.mb_w[f] = plan[at++];
  c.n_runs = plan[at++];
  if (c.n_runs < 0 || c.n_runs > MAX_RUNS || n_plan != at + 3 * c.n_runs)
    return false;
  for (int s = 0; s < c.n_runs; ++s)
    for (int w = 0; w < 3; ++w) c.runs[s][w] = plan[at++];
  return true;
}

}  // namespace

// Launch on `stream`; `plan` is a host array. Return the cudaGetLastError()
// of the launch (0 = launched), or -1 on a plan the kernels cannot take.
extern "C" int wire_unpack_launch(const void* packed, void* wire,
                                  const int* plan, int n_plan, int G,
                                  void* stream) {
  Codec c;
  if (!parse(plan, n_plan, G, c)) return -1;
  const int threads = 256;
  wire_unpack_kernel<<<(G + threads - 1) / threads, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(packed), static_cast<int*>(wire), c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wire_pack_launch(const void* wire, void* packed,
                                const void* flags, const int* plan,
                                int n_plan, int G, void* stream) {
  Codec c;
  if (!parse(plan, n_plan, G, c)) return -1;
  const int threads = 256;
  wire_pack_kernel<<<(G + threads - 1) / threads, threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(wire), static_cast<int*>(packed),
      static_cast<const int*>(flags), c);
  return static_cast<int>(cudaGetLastError());
}
