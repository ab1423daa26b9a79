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
// Design: one warp per (row, router), lane = input port (so PI <= 32; the
// largest Table III radix at N = 256 is FlattenedButterfly's 30, PI = 31).
// Phase a is a scan over the lane's V VCs.  Phase b needs no shared memory:
// each lane walks the warp's requests through __shfl_sync and loses to any
// other lane that asks for the same slot with a better (score, lane) key.
//
// Bound: integer compares only, so bytes bound it.  At the main path's
// shape [32, 256, 7, 4] one launch reads and writes about 1.8 MB, about
// 0.55 us at 3.35 TB/s; in practice the launch latency of a few us bounds
// it.  The design does nothing about that yet: fusing the allocator into
// the route lookup, or capturing a whole simulated cycle in a CUDA graph,
// are the next steps.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 30;
constexpr int kWarpsPerBlock = 8;

// C's % truncates toward zero; the reference's mod is a floor-mod.
__device__ __forceinline__ int floor_mod(int x, int m) {
  return ((x % m) + m) % m;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
netstep_kernel(const int32_t* __restrict__ op_slot,
               const uint8_t* __restrict__ eligible,
               const int32_t* __restrict__ rr_vc,
               const int32_t* __restrict__ rr_port,
               uint8_t* __restrict__ win,
               int32_t* __restrict__ vc_out,
               int32_t* __restrict__ req_out,
               long long n_routers, int routers_per_row, int pi, int v) {
  const int lane = threadIdx.x & 31;
  const long long router =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (router >= n_routers) return;  // uniform across the warp
  const int row = (int)(router / routers_per_row);
  const bool active = lane < pi;
  const long long port_idx = router * pi + lane;  // flat (row, node, port)
  const long long vc_base = port_idx * v;

  // phase a: rotating-priority VC choice of this input port
  int best = kInf, choice = 0, req = -1;
  if (active) {
    const int rv = rr_vc[row];
    for (int c = 0; c < v; ++c) {
      if (eligible[vc_base + c]) {
        const int s = floor_mod(c - rv, v);
        if (s < best) {
          best = s;
          choice = c;
        }
      }
    }
    if (best < kInf) req = op_slot[vc_base + choice];
  }

  // phase b: one winner per requested out slot; a request outside
  // [0, PI) names no slot, as in the reference's one_hot
  const bool requests = best < kInf && req >= 0 && req < pi;
  const int score = floor_mod(lane - rr_port[row], pi);
  const int my_req = requests ? req : -1;
  bool wins = requests;
  for (int j = 0; j < pi; ++j) {
    const int req_j = __shfl_sync(0xffffffffu, my_req, j);
    const int score_j = __shfl_sync(0xffffffffu, score, j);
    if (j != lane && requests && req_j == req &&
        (score_j < score || (score_j == score && j < lane)))
      wins = false;
  }

  if (active) {
    for (int c = 0; c < v; ++c)
      win[vc_base + c] = (wins && c == choice) ? 1 : 0;
    vc_out[port_idx] = choice;
    req_out[port_idx] = req;
  }
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched); the caller checks shapes and types.
extern "C" int netstep_launch(const void* op_slot, const void* eligible,
                              const void* rr_vc, const void* rr_port,
                              void* win, void* vc, void* req, int rows,
                              int routers_per_row, int pi, int v,
                              void* stream) {
  const long long n_routers = (long long)rows * routers_per_row;
  if (n_routers == 0) return 0;
  const long long blocks = (n_routers + kWarpsPerBlock - 1) / kWarpsPerBlock;
  netstep_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                   (cudaStream_t)stream>>>(
      (const int32_t*)op_slot, (const uint8_t*)eligible,
      (const int32_t*)rr_vc, (const int32_t*)rr_port, (uint8_t*)win,
      (int32_t*)vc, (int32_t*)req, n_routers, routers_per_row, pi, v);
  return (int)cudaGetLastError();
}
