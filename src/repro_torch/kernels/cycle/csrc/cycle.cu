// cycle: one simulated cycle of the batched network simulator, around the
// `netstep` allocator, as two kernels written by hand for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package runs the cycle as the XLA ops of
// its scan step (src/repro/core/simulator.py:585); the port ran the same
// cycle as 166-236 stock PyTorch ops (`core.simulator._torch_body`, the
// PyTorch body, which stays the oracle and serves the CPU, alloc="torch"
// and op traces).  Same function, bit for bit, in every mode of the
// simulator (static or workload injection, static or adaptive routing,
// with or without the flight recorder):
//   cycle_route (§1-§4): link deliveries into the input buffers, credit
//     returns onto the output ports, injection, the route lookup and the
//     allocator's arguments (op_slot, eligible, rr % V, rr % PI; adaptive
//     runs also each VC's downstream VC, dvc);
//   netstep (unchanged, its own library): the switch allocation;
//   cycle_move (§5): pops, upstream credit returns, ejections and link
//     traversals, the counters, the rotating priority and the cycle.
// The plain version is `repro_torch/kernels/cycle/ref.py`.
//
// Why the cycle splits at the allocator and nowhere else: within a cycle,
// routers influence each other only through the link pipelines and the
// credit pipelines, and both are written at slot (t + depth) % D with
// 1 <= depth < D, never at the slot t % D that the cycle reads.  Every
// other read and write of §1-§5 touches router (row, node)'s own state.
// So each input port *pulls* the flit of its one upstream channel, each
// output port pulls the credits of its one channel, and nothing needs an
// atomic on state or a barrier wider than one router's lanes.
//
// Bound: latency.  At [32 rows, 256 nodes, 7 ports, 4 VCs] a cycle moves
// about 4 MB of state at most (most lanes read a few words), under 1.5 us
// at 3.35 TB/s, while each kernel is a chain of dependent loads (link ->
// buffer -> table -> credits).  The design keeps the chains short:
//
// - netstep's lane layout: R = 32 / PI routers a warp, lane l < R * PI
//   takes router slot l / PI and port l % PI, so one router's lanes share a
//   warp (its credits pass between them through memory and __syncwarp) and
//   op_slot / eligible are stored as the contiguous spans netstep reads.
// - V in {1, 2, 4, 8} is a template argument, so the VC loops unroll;
//   any other V <= 32 takes the generic instantiation.  Adaptive routing
//   (`prod` given) and the flight recorder (its counters given) are two
//   more, <kV, kAdaptive, kRecord>, so <kV, false, false>, the static and
//   workload runs' code, carries no branch of either.
// - The adaptive lookup scores each VC's productive ports by their
//   downstream adaptive credit.  Each out-port lane sums its own port's
//   credits once, after §2, and its router's lanes take the sums with
//   __shfl_sync; `prod` arrives packed, P bits a (spec, dst, node).
// - The recorder adds only what one lane sees: each in-port the
//   occupancy of its upstream channel, each traversal its out channel,
//   each ejection its node and latency bin; starved head flits, which
//   several in-ports may charge to one channel, add atomically.
// - The per-row spec leaves arrive gathered and with each channel's depth
//   beside it (up_delay, out_delay), one load instead of two in a chain.
// - The destination draw is a binary search over the cumulative traffic
//   row: the count of entries below u, since every row is nondecreasing.
// - Counters are integer sums: a warp reduces each row's lanes (one REDUX
//   with a full mask per row in the warp) and one lane adds it atomically.
// - The cycle `t` advances in cycle_move's last block (a ticket), after
//   every lane has read it: no separate launch.
#include <cuda_runtime.h>
#include <stdint.h>

// The arguments of both kernels, passed by value; `ops.py` mirrors this
// layout field by field (`_Params`).  Shapes: B rows, N nodes, P ports, PI
// = P + 1 (the injection port), V VCs, Bd buffer slots, C channels, D ring
// slots, S specs, X = S (static) or S * K (workload) injection tables.
struct CycleParams {
  // per-row spec leaves, [B, N, P] int32
  const int32_t* up_ch;      // channel into in-port p, -1 none
  const int32_t* up_delay;   // its pipeline depth
  const int32_t* out_ch;     // channel out of out-port p, -1 none
  const int32_t* out_delay;  // its pipeline depth
  const int16_t* table;      // [S, N, N, PI] out port, -2 eject, -1 none
  const int32_t* srow;       // [B] spec of each row
  const int32_t* pi;         // [B] the spec's own PI
  // injection
  const float* rate;         // [B] (static)
  const float* inj_w;        // [X, N]
  const float* cum;          // [X, N, N] cumulative traffic rows
  const float* rate_t;       // [cycles, B] workload, else null
  const int64_t* kidx_row;   // [cycles, B] workload: table index
  const int64_t* bk;         // [cycles, B] workload: phase counter index
  const float* u_inj;        // [nb, N] this chunk's bits, row t % 256
  const float* u_dst;        // [nb, N]
  const int64_t* vcs;        // [nb, N]
  // state
  int32_t* buf_dst;          // [B, N, PI, V, Bd]
  int32_t* buf_t;            // [B, N, PI, V, Bd]
  int32_t* head;             // [B, N, PI, V]
  int32_t* cnt;              // [B, N, PI, V]
  int32_t* credits;          // [B, N, P, V]
  int32_t* link_dst;         // [B, C, D], -1 empty
  int32_t* link_t;           // [B, C, D]
  int32_t* link_vc;          // [B, C, D]
  int32_t* credit_pipe;      // [B, C, D, V]
  int32_t* rr;               // [B]
  // the allocator's arguments (cycle_route) and results (cycle_move)
  int32_t* op_slot;          // [B, N, PI, V]
  uint8_t* eligible;         // [B, N, PI, V]
  int32_t* rr_vc;            // [B]
  int32_t* rr_port;          // [B]
  const uint8_t* win;        // [B, N, PI, V]
  const int32_t* vc;         // [B, N, PI]
  const int32_t* req;        // [B, N, PI]
  // counters
  int32_t* delivered;        // [B]
  int32_t* offered;          // [B]
  int32_t* accepted;         // [B]
  int32_t* lat_node;         // [B, N]
  int32_t* delivered_ph;     // [B * K] workload, else null
  int32_t* offered_ph;       // [B * K]
  int32_t* accepted_ph;      // [B * K]
  int32_t* lat_ph;           // [B * K, N]
  // adaptive routing (DESIGN.md §15), else null
  const int32_t* prod;       // [S, N, N] productive out ports of (spec,
                             // dst, node): bit o for port o
  int32_t* dvc;              // [B, N, PI, V] each VC's downstream VC
  // the flight recorder (DESIGN.md §13, §16), else null; nw = max(W, 1)
  int32_t* tel_busy;         // [nw, B, C + 1] traversals (row C stays 0)
  int32_t* tel_stall;        // [nw, B, C + 1] credit-starved head flits
  int32_t* tel_occ;          // [nw, B, C + 1, V] occupancy sums
  int32_t* tel_inj;          // [nw, B, N] injections
  int32_t* tel_eject;        // [nw, B, N] ejections
  int32_t* tel_hist;         // [B, kLatHistBins] latency histogram
  int64_t* t;                // [1] the cycle
  uint32_t* ticket;          // [1] blocks of cycle_move done, 0 between
  int rows, n, p, v, bd, c, d, measuring, windows, warmup, meas;
};

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kEject = -2;       // Routing.EJECT
constexpr int kBitsChunk = 256;  // simulator._BITS_CHUNK
constexpr int kLatHistBins = 16;  // simulator.LAT_HIST_BINS

// This lane's router and port in netstep's layout.
struct Lane {
  long long router;  // flat (row, node)
  int row, node, port;
  bool active;
};

__device__ __forceinline__ Lane lane_of(int rows, int n, int pi) {
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / pi;
  const int slot = lane / pi;
  Lane l;
  l.port = lane - slot * pi;
  l.router = ((long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) *
                 per_warp + slot;
  l.active = slot < per_warp && l.router < (long long)rows * n;
  l.row = l.active ? (int)(l.router / n) : 0;
  l.node = l.active ? (int)(l.router - (long long)l.row * n) : 0;
  return l;
}

// The count of entries of the nondecreasing row[0, n) below u (a lower
// bound), at most n - 1: the reference's (cum < u).sum().clamp(0, n - 1).
__device__ __forceinline__ int draw(const float* __restrict__ row, int n,
                                    float u) {
  int lo = 0, len = n;
  while (len > 0) {
    const int half = len >> 1;
    if (row[lo + half] < u) {
      lo += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  return lo < n - 1 ? lo : n - 1;
}

// Adds x and y of every lane that is `on` into xs[row], ys[row] (and
// xs_ph[ph], ys_ph[ph] where given): one warp sum per row present in the
// warp, added by the row's first lane.  Every lane of the warp calls it.
__device__ __forceinline__ void row_add(bool on, int row, int x, int y,
                                        int ph, int32_t* xs, int32_t* ys,
                                        int32_t* xs_ph, int32_t* ys_ph) {
  const int lane = threadIdx.x & 31;
  unsigned pending = __ballot_sync(kFull, on);
  while (pending) {
    const int leader = __ffs(pending) - 1;
    const int r = __shfl_sync(kFull, row, leader);
    const bool mine = on && row == r;
    const int sx = __reduce_add_sync(kFull, mine ? x : 0);
    const int sy = ys ? __reduce_add_sync(kFull, mine ? y : 0) : 0;
    if (lane == leader) {
      if (sx) {
        atomicAdd(xs + r, sx);
        if (xs_ph) atomicAdd(xs_ph + ph, sx);
      }
      if (sy) {
        atomicAdd(ys + r, sy);
        if (ys_ph) atomicAdd(ys_ph + ph, sy);
      }
    }
    pending &= ~__ballot_sync(kFull, mine);
  }
}

// The recorder's window of cycle T (measuring): the measured cycles split
// into `windows` windows, ((T - warmup) * W) // meas; 0 without windows.
__device__ __forceinline__ int window_of(const CycleParams& a, int T) {
  if (a.windows <= 0) return 0;
  const long long w = (long long)(T - a.warmup) * a.windows / a.meas;
  return w < 0 ? 0 : (w < a.windows ? (int)w : a.windows - 1);
}

// The latency histogram's bin of `lat`: bin h counts [2^(h-1), 2^h), the
// last bin open-ended, as torch.bucketize(lat, 2 ** arange(bins - 1),
// right=True) counts it.
__device__ __forceinline__ int lat_bin(int lat) {
  if (lat <= 0) return 0;
  const int h = 32 - __clz(lat);
  return h < kLatHistBins - 1 ? h : kLatHistBins - 1;
}

// §1-§4.  kV in {1, 2, 4, 8}, or 0 for any V given at run time; kAdaptive
// routes VCs >= 1 over the productive ports (`prod`), kRecord adds the
// flight recorder's counters.  <kV, false, false> is the static and
// workload code: every addition sits under `if constexpr`.
template <int kV, bool kAdaptive, bool kRecord>
__global__ void __launch_bounds__(kThreads) cycle_route(const CycleParams a) {
  const int N = a.n, P = a.p, PI = a.p + 1, Bd = a.bd, C = a.c, D = a.d;
  const int V = kV > 0 ? kV : a.v;
  const Lane l = lane_of(a.rows, N, PI);
  const int T = (int)*a.t;
  const int slot = T % D;
  const int k = T % kBitsChunk;
  const long long rp = l.router * PI + l.port;  // flat (row, node, port)
  const bool workload = a.rate_t != nullptr;
  // kRecord: this cycle's window, and its row's offset into the [nw, B,
  // ...] counters
  const bool record = kRecord && a.measuring;
  const long long wrow =
      kRecord ? (long long)window_of(a, T) * a.rows + l.row : 0;
  // kAdaptive: this out-port's VC-0 credit, its adaptive credit (summed
  // over VCs >= 1) and the first of its adaptive VCs with the most credit
  int cr0 = 0, cr_ad = 0, best_vc = 1;

  int want = 0, injected = 0, ph = 0;
  if (l.active && l.port < P) {
    const long long bnp = l.router * P + l.port;
    // §1: the flit at slot t % D of the upstream channel, into its VC
    const int uc = a.up_ch[bnp];
    if (uc >= 0) {
      const long long li = ((long long)l.row * C + uc) * D + slot;
      const int dst = a.link_dst[li];
      if (dst >= 0) {
        const long long q = rp * V + a.link_vc[li];
        const int pos = (a.head[q] + a.cnt[q]) % Bd;
        a.buf_dst[q * Bd + pos] = dst;
        a.buf_t[q * Bd + pos] = a.link_t[li];
        a.cnt[q] += 1;
        a.link_dst[li] = -1;
      }
      if constexpr (kRecord) {
        // the occupancy snapshot: post-arrival, pre-pop (injection fills
        // port P, which no channel enters); one writer a channel
        if (record) {
          int32_t* occ = a.tel_occ + (wrow * (C + 1) + uc) * V;
#pragma unroll
          for (int c = 0; c < V; ++c) occ[c] += a.cnt[rp * V + c];
        }
      }
    }
    // §2: the credits at slot t % D of the channel out of this port
    const int oc = a.out_ch[bnp];
    if (oc >= 0) {
      const long long ci = (((long long)l.row * C + oc) * D + slot) * V;
#pragma unroll
      for (int c = 0; c < V; ++c) {
        const int x = a.credit_pipe[ci + c];
        if (x) {
          a.credits[bnp * V + c] += x;
          a.credit_pipe[ci + c] = 0;
        }
      }
    }
    if constexpr (kAdaptive) {
      const int32_t* cr = a.credits + bnp * V;
      cr0 = cr[0];
      int most = cr[1];
      cr_ad = most;
#pragma unroll
      for (int c = 2; c < V; ++c) {
        const int x = cr[c];
        cr_ad += x;
        if (x > most) {
          most = x;
          best_vc = c;
        }
      }
    }
  } else if (l.active) {
    // §3: injection at port P
    const long long kn = (long long)k * N + l.node;
    float rate, w;
    const float* row;
    if (workload) {
      const long long tb = (long long)T * a.rows + l.row;
      const long long kr = a.kidx_row[tb];
      rate = a.rate_t[tb];
      w = a.inj_w[kr * N + l.node];
      row = a.cum + (kr * N + l.node) * N;
      ph = (int)a.bk[tb];
    } else {
      const long long s = a.srow[l.row];
      rate = a.rate[l.row];
      w = a.inj_w[s * N + l.node];
      row = a.cum + (s * N + l.node) * N;
    }
    // rate * weight rounded as PyTorch's float32 product
    want = a.u_inj[kn] < __fmul_rn(rate, w);
    const int dst = draw(row, N, a.u_dst[kn]);
    want = want && dst != l.node;
    const long long q = rp * V + (int)a.vcs[kn];
    const int cn = a.cnt[q];
    injected = want && cn < Bd;
    if (injected) {
      const int pos = (a.head[q] + cn) % Bd;
      a.buf_dst[q * Bd + pos] = dst;
      a.buf_t[q * Bd + pos] = T;
      a.cnt[q] = cn + 1;
    }
    if constexpr (kRecord) {
      if (record && injected) a.tel_inj[wrow * N + l.node] += 1;
    }
  }
  // the router's credits, returned by its other lanes, are read below
  __syncwarp();

  if constexpr (!kAdaptive) {
    if (l.active) {
      // §4: each VC's head flit against the table and its credit
      const long long s = a.srow[l.row];
      const long long cb = l.router * P;
#pragma unroll
      for (int c = 0; c < V; ++c) {
        const long long q = rp * V + c;
        int op = -3;
        bool el = false;
        if (a.cnt[q] > 0) {
          const int dst = a.buf_dst[q * Bd + a.head[q]];
          const int o = a.table[((s * N + dst) * N + l.node) * PI + l.port];
          if (o == kEject) {
            op = P;
            el = true;
          } else {
            op = o;
            el = o >= 0 && a.credits[(cb + (o < P ? o : P - 1)) * V + c] > 0;
            if constexpr (kRecord) {
              // credit starvation, charged to the requested out channel
              if (record && o >= 0 && !el) {
                const int st = a.out_ch[cb + (o < P ? o : P - 1)];
                if (st >= 0) atomicAdd(a.tel_stall + wrow * (C + 1) + st, 1);
              }
            }
          }
        }
        a.op_slot[q] = op;
        a.eligible[q] = el;
      }
      if (l.node == 0 && l.port == 0) {
        const int r = a.rr[l.row];
        a.rr_vc[l.row] = r % V;
        a.rr_port[l.row] = r % a.pi[l.row];
      }
    }
  } else {
    // §4, adaptive (DESIGN.md §15): VC 0 of the downstream port is the
    // escape class, on the static table; VCs >= 1 take the productive
    // port with the most adaptive credit (the first on ties) where one
    // has any.  Every lane of the warp takes part in the shuffles that
    // pass each out-port's credits to its router's lanes.
    constexpr int kMaxV = kV > 0 ? kV : 32;
    const int base = (threadIdx.x & 31) - l.port;  // the router's port 0
    const long long s = l.active ? a.srow[l.row] : 0;
    int op[kMaxV], best[kMaxV], ad_port[kMaxV], ad_vc[kMaxV];
    unsigned cand[kMaxV];
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const long long q = rp * V + c;
      op[c] = -3;
      cand[c] = 0;
      if (l.active && a.cnt[q] > 0) {
        const int dst = a.buf_dst[q * Bd + a.head[q]];
        const long long dn = (s * N + dst) * N + l.node;
        op[c] = a.table[dn * PI + l.port];
        cand[c] = (unsigned)a.prod[dn];
      }
      best[c] = -1;
      ad_port[c] = 0;
      ad_vc[c] = 1;
    }
    for (int o = 0; o < P; ++o) {
      const int x = __shfl_sync(kFull, cr_ad, base + o);
      const int y = __shfl_sync(kFull, best_vc, base + o);
#pragma unroll
      for (int c = 0; c < V; ++c) {
        if (((cand[c] >> o) & 1u) && x > 0 && x > best[c]) {
          best[c] = x;
          ad_port[c] = o;
          ad_vc[c] = y;
        }
      }
    }
    const long long cb = l.router * P;
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const bool valid = op[c] != -3;
      const bool ej = op[c] == kEject;
      const int esc = ej ? P : op[c];
      const int esc_cr = __shfl_sync(
          kFull, cr0, base + (esc < 0 ? 0 : (esc < P ? esc : P - 1)));
      if (l.active) {
        const long long q = rp * V + c;
        const bool use_ad = valid && !ej && best[c] > 0;
        const int slot_c = use_ad ? ad_port[c] : esc;
        const bool el = valid && slot_c >= 0 &&
                        (use_ad || ej || (esc >= 0 && esc_cr > 0));
        a.op_slot[q] = slot_c;
        a.eligible[q] = el;
        a.dvc[q] = use_ad ? ad_vc[c] : 0;
        if constexpr (kRecord) {
          if (record && valid && !ej && esc >= 0 && !el) {
            const int st = a.out_ch[cb + (esc < P ? esc : P - 1)];
            if (st >= 0) atomicAdd(a.tel_stall + wrow * (C + 1) + st, 1);
          }
        }
      }
    }
    if (l.active && l.node == 0 && l.port == 0) {
      const int r = a.rr[l.row];
      a.rr_vc[l.row] = r % V;
      a.rr_port[l.row] = r % a.pi[l.row];
    }
  }
  if (a.measuring)
    row_add(l.active && l.port == P, l.row, want, injected, ph, a.offered,
            a.accepted, workload ? a.offered_ph : nullptr, a.accepted_ph);
}

// §5.  kV, kAdaptive and kRecord as in cycle_route.
template <int kV, bool kAdaptive, bool kRecord>
__global__ void __launch_bounds__(kThreads) cycle_move(const CycleParams a) {
  const int N = a.n, P = a.p, PI = a.p + 1, Bd = a.bd, C = a.c, D = a.d;
  const int V = kV > 0 ? kV : a.v;
  const Lane l = lane_of(a.rows, N, PI);
  const int T = (int)*a.t;
  const long long rp = l.router * PI + l.port;
  const bool workload = a.rate_t != nullptr;
  const bool record = kRecord && a.measuring;
  const long long wrow =
      kRecord ? (long long)window_of(a, T) * a.rows + l.row : 0;

  int ejected = 0, ph = 0;
  if (l.active) {
    bool wins = false;
#pragma unroll
    for (int c = 0; c < V; ++c) wins |= a.win[rp * V + c] != 0;
    if (workload && a.measuring) ph = (int)a.bk[(long long)T * a.rows + l.row];
    if (wins) {
      // pop the winning VC's head flit
      const int wvc = a.vc[rp];
      const int rq = a.req[rp];
      const long long q = rp * V + wvc;
      const int h = a.head[q];
      const int w_dst = a.buf_dst[q * Bd + h];
      const int w_t = a.buf_t[q * Bd + h];
      a.head[q] = (h + 1) % Bd;
      a.cnt[q] -= 1;
      if (l.port < P) {
        // the freed slot's credit, back up the channel it came in on
        const long long bnp = l.router * P + l.port;
        const int uc = a.up_ch[bnp];
        if (uc >= 0)
          a.credit_pipe[(((long long)l.row * C + uc) * D +
                         (a.up_delay[bnp] + T) % D) * V + wvc] += 1;
      }
      if (rq == P) {
        ejected = 1;
        if (a.measuring) {
          atomicAdd(a.lat_node + l.router, T - w_t);
          if (workload) atomicAdd(a.lat_ph + (long long)ph * N + l.node,
                                  T - w_t);
          if constexpr (kRecord) {
            atomicAdd(a.tel_eject + wrow * N + l.node, 1);
            atomicAdd(a.tel_hist + (long long)l.row * kLatHistBins +
                          lat_bin(T - w_t), 1);
          }
        }
      } else if (rq >= 0 && rq < P) {
        // the VC the flit takes downstream: its own, or the adaptive
        // lookup's choice (the upstream credit above stays on wvc)
        const int dv = kAdaptive ? a.dvc[q] : wvc;
        const long long bo = l.router * P + rq;
        const int oc = a.out_ch[bo];
        if (oc >= 0) {
          const long long li =
              ((long long)l.row * C + oc) * D + (a.out_delay[bo] + T) % D;
          a.link_dst[li] = w_dst;
          a.link_t[li] = w_t;
          a.link_vc[li] = dv;
          if constexpr (kRecord) {
            if (record) atomicAdd(a.tel_busy + wrow * (C + 1) + oc, 1);
          }
        }
        a.credits[bo * V + dv] -= 1;
      }
    }
    if (l.node == 0 && l.port == 0)
      a.rr[l.row] = (a.rr[l.row] + 1) % (V * a.pi[l.row]);
  }
  if (a.measuring)
    row_add(l.active, l.row, ejected, 0, ph, a.delivered, nullptr,
            workload ? a.delivered_ph : nullptr, nullptr);

  // the last block to finish advances the cycle: every lane has read t
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(a.ticket, 1u) == gridDim.x - 1) {
      *a.ticket = 0;
      *a.t = T + 1;
    }
  }
}

__global__ void cycle_draw(const float* __restrict__ cum,
                           const float* __restrict__ u, int32_t* out,
                           int rows, int n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rows) out[i] = draw(cum + i * n, n, u[i]);
}

unsigned grid_of(const CycleParams& a) {
  const int per_warp = 32 / (a.p + 1);
  const long long warps =
      ((long long)a.rows * a.n + per_warp - 1) / per_warp;
  return (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

bool takes(const CycleParams* a) {
  return a->rows > 0 && a->n > 0 && a->p >= 1 && a->p <= 31 && a->v >= 1 &&
         a->v <= 32 && a->bd >= 1 && a->c >= 1 && a->d >= 1 &&
         (long long)a->rows * a->n <= (1LL << 30) &&
         (a->prod == nullptr || a->v >= 2) && a->windows >= 0 &&
         (a->windows == 0 || a->meas >= 1);
}

template <int kV, bool kAdaptive, bool kRecord>
void launch(bool route, unsigned g, cudaStream_t s, const CycleParams& a) {
  if (route)
    cycle_route<kV, kAdaptive, kRecord><<<g, kThreads, 0, s>>>(a);
  else
    cycle_move<kV, kAdaptive, kRecord><<<g, kThreads, 0, s>>>(a);
}

template <bool kAdaptive, bool kRecord>
void launch_v(bool route, unsigned g, cudaStream_t s, const CycleParams& a) {
  switch (a.v) {
    case 1: launch<1, kAdaptive, kRecord>(route, g, s, a); break;
    case 2: launch<2, kAdaptive, kRecord>(route, g, s, a); break;
    case 4: launch<4, kAdaptive, kRecord>(route, g, s, a); break;
    case 8: launch<8, kAdaptive, kRecord>(route, g, s, a); break;
    default: launch<0, kAdaptive, kRecord>(route, g, s, a); break;
  }
}

// Launches cycle_route (route) or cycle_move: the instantiation follows
// from what the run gives, `prod` (adaptive routing) and the recorder's
// counters.
int launch_cycle(const CycleParams* a, void* stream, bool route) {
  if (!takes(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned g = grid_of(*a);
  const bool adaptive = a->prod != nullptr, record = a->tel_busy != nullptr;
  if (adaptive && record) launch_v<true, true>(route, g, s, *a);
  else if (adaptive) launch_v<true, false>(route, g, s, *a);
  else if (record) launch_v<false, true>(route, g, s, *a);
  else launch_v<false, false>(route, g, s, *a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on `stream` and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for shapes
// outside what the kernels take (P in [1, 31], V in [1, 32], V >= 2 with
// adaptive routing, at most 2^30 routers, windows >= 0 over a measured
// span of at least one cycle); the wrapper checks types, shapes and
// contiguity.
extern "C" int cycle_route_launch(const CycleParams* a, void* stream) {
  return launch_cycle(a, stream, true);
}

extern "C" int cycle_move_launch(const CycleParams* a, void* stream) {
  return launch_cycle(a, stream, false);
}

// The destination draw alone, for tests: out[i] = the draw of u[i] from
// row i of cum [rows, n].
extern "C" int cycle_draw_launch(const void* cum, const void* u, void* out,
                                 int rows, int n, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  const int threads = 128;
  cycle_draw<<<(rows + threads - 1) / threads, threads, 0,
               (cudaStream_t)stream>>>((const float*)cum, (const float*)u,
                                       (int32_t*)out, rows, n);
  return (int)cudaGetLastError();
}
