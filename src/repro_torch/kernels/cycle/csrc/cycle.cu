// cycle: one simulated cycle of the batched network simulator, around the
// `netstep` allocator, as two kernels written by hand for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package runs the cycle as the XLA ops of
// its scan step (src/repro/core/simulator.py:585); the port ran the same
// cycle as 166-176 stock PyTorch ops (`core.simulator._torch_body`, the
// PyTorch body, which stays the oracle).  Same function, bit for bit:
//   cycle_route (§1-§4): link deliveries into the input buffers, credit
//     returns onto the output ports, injection, the route lookup and the
//     allocator's arguments (op_slot, eligible, rr % V, rr % PI);
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
//   any other V <= 32 takes the generic instantiation.
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
  int64_t* t;                // [1] the cycle
  uint32_t* ticket;          // [1] blocks of cycle_move done, 0 between
  int rows, n, p, v, bd, c, d, measuring;
};

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kEject = -2;       // Routing.EJECT
constexpr int kBitsChunk = 256;  // simulator._BITS_CHUNK

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

// §1-§4.  kV in {1, 2, 4, 8}, or 0 for any V given at run time.
template <int kV>
__global__ void __launch_bounds__(kThreads) cycle_route(const CycleParams a) {
  const int N = a.n, P = a.p, PI = a.p + 1, Bd = a.bd, C = a.c, D = a.d;
  const int V = kV > 0 ? kV : a.v;
  const Lane l = lane_of(a.rows, N, PI);
  const int T = (int)*a.t;
  const int slot = T % D;
  const int k = T % kBitsChunk;
  const long long rp = l.router * PI + l.port;  // flat (row, node, port)
  const bool workload = a.rate_t != nullptr;

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
  }
  // the router's credits, returned by its other lanes, are read below
  __syncwarp();

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
  if (a.measuring)
    row_add(l.active && l.port == P, l.row, want, injected, ph, a.offered,
            a.accepted, workload ? a.offered_ph : nullptr, a.accepted_ph);
}

// §5.  kV as in cycle_route.
template <int kV>
__global__ void __launch_bounds__(kThreads) cycle_move(const CycleParams a) {
  const int N = a.n, P = a.p, PI = a.p + 1, Bd = a.bd, C = a.c, D = a.d;
  const int V = kV > 0 ? kV : a.v;
  const Lane l = lane_of(a.rows, N, PI);
  const int T = (int)*a.t;
  const long long rp = l.router * PI + l.port;
  const bool workload = a.rate_t != nullptr;

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
        }
      } else if (rq >= 0 && rq < P) {
        const long long bo = l.router * P + rq;
        const int oc = a.out_ch[bo];
        if (oc >= 0) {
          const long long li =
              ((long long)l.row * C + oc) * D + (a.out_delay[bo] + T) % D;
          a.link_dst[li] = w_dst;
          a.link_t[li] = w_t;
          a.link_vc[li] = wvc;
        }
        a.credits[bo * V + wvc] -= 1;
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
         (long long)a->rows * a->n <= (1LL << 30);
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on `stream` and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for shapes
// outside what the kernels take (P in [1, 31], V in [1, 32], at most 2^30
// routers); the wrapper checks types, shapes and contiguity.
extern "C" int cycle_route_launch(const CycleParams* a, void* stream) {
  if (!takes(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned g = grid_of(*a);
  switch (a->v) {
    case 1: cycle_route<1><<<g, kThreads, 0, s>>>(*a); break;
    case 2: cycle_route<2><<<g, kThreads, 0, s>>>(*a); break;
    case 4: cycle_route<4><<<g, kThreads, 0, s>>>(*a); break;
    case 8: cycle_route<8><<<g, kThreads, 0, s>>>(*a); break;
    default: cycle_route<0><<<g, kThreads, 0, s>>>(*a); break;
  }
  return (int)cudaGetLastError();
}

extern "C" int cycle_move_launch(const CycleParams* a, void* stream) {
  if (!takes(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned g = grid_of(*a);
  switch (a->v) {
    case 1: cycle_move<1><<<g, kThreads, 0, s>>>(*a); break;
    case 2: cycle_move<2><<<g, kThreads, 0, s>>>(*a); break;
    case 4: cycle_move<4><<<g, kThreads, 0, s>>>(*a); break;
    case 8: cycle_move<8><<<g, kThreads, 0, s>>>(*a); break;
    default: cycle_move<0><<<g, kThreads, 0, s>>>(*a); break;
  }
  return (int)cudaGetLastError();
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
