// netstep: the cycle simulator's two-phase separable switch allocator,
// written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `_netstep_kernel` of
// src/repro/kernels/netstep/netstep.py:28 (Pallas).  Same function as the
// plain version `repro_torch/kernels/netstep/ref.py::netstep_ref`, bit for
// bit:
//   phase a: every input port picks the eligible VC with the least
//            (vc - rr_vc) mod V; its requested out slot is out_req, or -1;
//   phase b: every out slot o in [0, PI) grants the requesting input port
//            with the least (port - rr_port) mod PI (strict single winner,
//            lowest port index on ties).
//
// Layout: op_slot [B, N, PI, V] int32, eligible [B, N, PI, V] bool (one byte,
// read as uint8), rr_vc / rr_port [B] int32 -> win [B, N, PI, V] bool,
// vc [B, N, PI] int32, req [B, N, PI] int32, all contiguous.  The Pallas
// kernel took one grid of routers and a scalar rr; here the batch of
// (spec, rate) rows is explicit and every row brings its own rr pair.
//
// Bound: integer compares only, so bytes bound it: at the main path's shape
// [32, 256, 7, 4] one launch reads and writes about 1.8 MB, 0.55 us at
// 3.35 TB/s.  What actually bounds it is latency: one launch of a small
// grid and one round trip to memory.  The design keeps that to one round
// trip and fills the warps:
//
// - R = 32 / PI routers share a warp; lane l < R * PI takes router slot
//   l / PI and port l % PI, so the warp's lanes are consecutive
//   (row, router, port) triples and every load and store of a warp is one
//   contiguous span.  A warp may straddle two rows, so each lane finds its
//   own row and rr pair.  Lanes past R * PI or past the last router stay
//   alive through the warp intrinsics with a key that requests nothing.
// - Every load is issued up front and none depends on another: the rr pair,
//   the V eligible bytes as one word and the V requested slots as vectors
//   (one int4 at V = 4).  V in {1, 2, 4, 8} is a template argument, so the
//   VC scan unrolls over registers; any other V <= 32 takes the generic
//   instantiation with scalar loads.
// - Phase b is one warp intrinsic: __match_any_sync gives each requesting
//   lane the mask of the lanes that ask its router for the same out slot,
//   and the winner, the least (port - rr_port) mod PI, is the first of
//   them at or after rr_port, found with shifts and __ffs.  (A
//   __reduce_min_sync over the group finds the same winner, but with a
//   mask that differs between lanes it compiles to one REDUX per group of
//   the warp in turn, under WARPSYNC.EXCLUSIVE: on an H100 that made a
//   launch at the main shape about 1.7x slower.  `kernels.ablate` cut
//   "redux" puts it back; PERF.md has the times.)
// - No integer division on the way to the loads: lane / PI and 32 / PI
//   through a float reciprocal, the row through a multiply-high by a
//   constant the launcher computes, and rr counters that arrive already
//   reduced skip their mod.
// - Stores: the V win bytes of a port as one word, vc and req as int32,
//   contiguous across the warp.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = kWarpsPerBlock * 32;

// C's % truncates toward zero; the reference's mod is a floor-mod.  The
// simulator's rr counters arrive already in [0, m), which skips both %.
__device__ __forceinline__ int floor_mod(int x, int m) {
  if ((unsigned)x < (unsigned)m) return x;
  return ((x % m) + m) % m;
}

// The V requested slots and eligibility bits of input port `p`, read with
// the widest loads V allows (the wrapper checks the bases' alignment).
template <int V>
__device__ __forceinline__ void load_port(const int32_t* __restrict__ op_slot,
                                          const uint8_t* __restrict__ eligible,
                                          long long p, int (&slot)[V],
                                          unsigned long long& el) {
  if constexpr (V == 1) {
    slot[0] = op_slot[p];
    el = eligible[p];
  } else if constexpr (V == 2) {
    const int2 s = reinterpret_cast<const int2*>(op_slot)[p];
    slot[0] = s.x;
    slot[1] = s.y;
    el = reinterpret_cast<const uint16_t*>(eligible)[p];
  } else if constexpr (V == 4) {
    const int4 s = reinterpret_cast<const int4*>(op_slot)[p];
    slot[0] = s.x;
    slot[1] = s.y;
    slot[2] = s.z;
    slot[3] = s.w;
    el = reinterpret_cast<const uint32_t*>(eligible)[p];
  } else {
    static_assert(V == 8, "V in {1, 2, 4, 8}");
    const int4 lo = reinterpret_cast<const int4*>(op_slot)[2 * p];
    const int4 hi = reinterpret_cast<const int4*>(op_slot)[2 * p + 1];
    slot[0] = lo.x;
    slot[1] = lo.y;
    slot[2] = lo.z;
    slot[3] = lo.w;
    slot[4] = hi.x;
    slot[5] = hi.y;
    slot[6] = hi.z;
    slot[7] = hi.w;
    el = reinterpret_cast<const unsigned long long*>(eligible)[p];
  }
}

// phase b: true iff this lane's request wins its out slot.  Lanes that
// ask router slot `slot` for out slot `req` share the key slot * 32 + req
// (< 1024 as PI <= 32); every other lane takes a key of its own.  The
// group's lanes lie in the router's PI lanes from slot * PI = lane - port
// on, so `rivals` holds bit q for each port q asking for the same slot.
// The least score (q - rpm) mod PI is the first such q >= rpm, else the
// first q: one winner per slot, the reference's rotating priority.
__device__ __forceinline__ bool arbitrate(bool requests, int slot, int req,
                                          int port, int rpm, int lane) {
  const unsigned key = requests ? (unsigned)(slot * 32 + req)
                                : 1024u + (unsigned)lane;
  const unsigned rivals = __match_any_sync(0xffffffffu, key) >> (lane - port);
  const unsigned after = rivals >> rpm;
  const int first = after ? rpm + __ffs(after) - 1 : __ffs(rivals) - 1;
  return requests && first == port;
}

// kV in {1, 2, 4, 8}, or 0 for any V <= 32 given at run time as `v`.
template <int kV>
__global__ void __launch_bounds__(kThreads)
netstep_kernel(const int32_t* __restrict__ op_slot,
               const uint8_t* __restrict__ eligible,
               const int32_t* __restrict__ rr_vc,
               const int32_t* __restrict__ rr_port,
               uint8_t* __restrict__ win,
               int32_t* __restrict__ vc_out,
               int32_t* __restrict__ req_out,
               int n_routers, int routers_per_row, int pi, int v,
               unsigned long long row_magic) {
  const int lane = threadIdx.x & 31;
  // 32 / PI and lane / PI: (x + 1/2) / PI lies at least 1 / (2 PI) from an
  // integer, far more than the reciprocal's error, so truncation is exact
  const float inv_pi = __fdividef(1.0f, (float)pi);
  const int per_warp = __float2int_rz(32.5f * inv_pi);   // R routers a warp
  const int slot = __float2int_rz(((float)lane + 0.5f) * inv_pi);
  const int port = lane - slot * pi;
  const int router =
      (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * per_warp + slot;
  const bool active = slot < per_warp && router < n_routers;
  const long long p = (long long)router * pi + port;  // flat (row, node, port)

  int choice = 0, req = -1, rpm = 0;
  bool found = false;
  if (active) {
    // router / routers_per_row (Lemire's multiply-high: exact for 32-bit
    // routers, with row_magic = 2^64 / routers_per_row rounded up)
    const int row = routers_per_row == 1
        ? router
        : (int)__umul64hi(row_magic, (unsigned long long)router);
    const int rv = rr_vc[row];
    const int rp = rr_port[row];
    if constexpr (kV > 0) {
      int slots[kV];
      unsigned long long el;
      load_port<kV>(op_slot, eligible, p, slots, el);
      // phase a: rotating-priority VC choice of this input port; V is a
      // power of two, so & (V - 1) is the floor-mod
      int best = kV;
#pragma unroll
      for (int c = 0; c < kV; ++c) {
        const int s = (c - rv) & (kV - 1);
        if (((el >> (8 * c)) & 0xffu) && s < best) {
          best = s;
          choice = c;
          req = slots[c];
        }
      }
      found = best < kV;
    } else {
      const long long base = p * v;
      int best = v;
      const int rvm = floor_mod(rv, v);
      for (int c = 0; c < v; ++c) {
        const int s = c >= rvm ? c - rvm : c - rvm + v;
        if (eligible[base + c] && s < best) {
          best = s;
          choice = c;
        }
      }
      found = best < v;
      if (found) req = op_slot[base + choice];
    }
    rpm = floor_mod(rp, pi);
  }

  // a request outside [0, PI) names no slot, as in the reference's one_hot
  const bool wins =
      arbitrate(found && req >= 0 && req < pi, slot, req, port, rpm, lane);

  if (active) {
    if constexpr (kV == 1) {
      win[p] = wins;
    } else if constexpr (kV == 2) {
      reinterpret_cast<uint16_t*>(win)[p] =
          wins ? (uint16_t)(1u << (8 * choice)) : (uint16_t)0;
    } else if constexpr (kV == 4) {
      reinterpret_cast<uint32_t*>(win)[p] = wins ? 1u << (8 * choice) : 0u;
    } else if constexpr (kV == 8) {
      reinterpret_cast<unsigned long long*>(win)[p] =
          wins ? 1ull << (8 * choice) : 0ull;
    } else {
      for (int c = 0; c < v; ++c) win[p * v + c] = wins && c == choice;
    }
    vc_out[p] = choice;
    req_out[p] = req;
  }
}

template <int kV>
void launch(const void* op_slot, const void* eligible, const void* rr_vc,
            const void* rr_port, void* win, void* vc, void* req,
            int n_routers, int routers_per_row, int pi, int v,
            cudaStream_t stream) {
  const int per_warp = 32 / pi;
  const long long warps = ((long long)n_routers + per_warp - 1) / per_warp;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const unsigned long long row_magic =
      ~0ull / (unsigned long long)routers_per_row + 1;  // unused at 1
  netstep_kernel<kV><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const int32_t*)op_slot, (const uint8_t*)eligible,
      (const int32_t*)rr_vc, (const int32_t*)rr_port, (uint8_t*)win,
      (int32_t*)vc, (int32_t*)req, n_routers, routers_per_row, pi, v,
      row_magic);
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for PI or V
// outside [1, 32] or more than 2^30 routers; the caller checks shapes,
// types, contiguity and the alignment of op_slot and eligible.
extern "C" int netstep_launch(const void* op_slot, const void* eligible,
                              const void* rr_vc, const void* rr_port,
                              void* win, void* vc, void* req, int rows,
                              int routers_per_row, int pi, int v,
                              void* stream) {
  const long long n_routers = (long long)rows * routers_per_row;
  if (n_routers == 0 || pi == 0 || v == 0) return 0;
  if (pi < 0 || pi > 32 || v < 0 || v > 32 || n_routers > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const int n = (int)n_routers;
  cudaStream_t s = (cudaStream_t)stream;
  switch (v) {
    case 1: launch<1>(op_slot, eligible, rr_vc, rr_port, win, vc, req, n,
                      routers_per_row, pi, v, s); break;
    case 2: launch<2>(op_slot, eligible, rr_vc, rr_port, win, vc, req, n,
                      routers_per_row, pi, v, s); break;
    case 4: launch<4>(op_slot, eligible, rr_vc, rr_port, win, vc, req, n,
                      routers_per_row, pi, v, s); break;
    case 8: launch<8>(op_slot, eligible, rr_vc, rr_port, win, vc, req, n,
                      routers_per_row, pi, v, s); break;
    default: launch<0>(op_slot, eligible, rr_vc, rr_port, win, vc, req, n,
                       routers_per_row, pi, v, s); break;
  }
  return (int)cudaGetLastError();
}
