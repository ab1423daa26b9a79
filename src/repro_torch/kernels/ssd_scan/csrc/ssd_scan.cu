// ssd_scan: the Mamba2 SSD chunked scan for float32 inputs, written by
// hand for Hopper (sm_90a).  bfloat16 inputs take ssd_scan_bf16.cu (chunk-
// parallel passes on the tensor cores); this kernel is the f32 route.
//
// Replaces the TPU kernel `_ssd_kernel` of
// src/repro/kernels/ssd_scan/ssd_scan.py:26 (Pallas), reached through
// `ssd_scan_pallas` and `ops.ssd_scan`, for float32 inputs.  Same function
// as the plain version `repro_torch/kernels/ssd_scan/ref.py::
// ssd_chunked_core`: for every chunk of Q steps, with cum the running sum
// of dt * a inside the chunk and S the state carried in from the chunks
// before,
//   y[q]  = sum_{k <= q} (C_q . B_k) exp(cum_q - cum_k) dt_k x_k
//           + exp(cum_q) C_q S
//   S    <- exp(cum_last) S + sum_k B_k (exp(cum_last - cum_k) dt_k x_k)
// in float32, and the final S.
//
// Layout: x, y [B, T, H, P], dt [B, T, H], a [H], B and C [B, T, N],
// state [B, H, N, P], all float32 and contiguous.
//
// Design: the TPU ran the chunk axis as a sequential grid axis with S in
// VMEM scratch.  Blocks here run in no order, so one block of 256 threads
// per (head, batch) walks the chunks in a loop and keeps S [N, P] in shared
// memory.  A chunk's Q x Q decay matrix would not fit, so the block walks
// q tiles of 32 rows and, for each, the k tiles at or below the diagonal,
// building the 32 x 32 scores (C Bᵀ ∘ L) in shared memory.  The decay
// exp(cum_q - cum_k) is taken only where k <= q, where it is at most 1:
// above the diagonal the exponent is positive and could overflow.
//
// Bound and why it stays on the CUDA cores: float32 inputs are held to
// 1e-4 against the plain version, which TF32 or bf16 tensor-core products
// cannot promise over a chunk of 256 terms, so the products are exact
// float32 FMAs.  One block per (head, batch) and the per-head C Bᵀ
// recompute keep it far above its byte bound; the serving path is bf16
// and takes the other kernel.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;            // q and k rows per tile

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const float* __restrict__ bm,
                const float* __restrict__ cm, float* __restrict__ y,
                float* __restrict__ state_out, int t, int h, int p, int n,
                int chunk, int tr) {
  const int hh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ns = n + 1;                // padded row stride of B and C tiles
  const int gsd = tr + 1;              // row stride of the scores tile
  extern __shared__ float smem[];
  float* S = smem;                     // [n][p]   carried state
  float* cum = S + n * p;              // [chunk]  running sum of dt * a
  float* dts = cum + chunk;            // [chunk]  dt of this head
  float* cs = dts + chunk;             // [tr][ns] C rows of the q tile
  float* bs = cs + tr * ns;            // [tr][ns] B rows of the k tile
  float* xs = bs + tr * ns;            // [tr][p]  weighted x rows, k tile
  float* gs = xs + tr * p;             // [tr][gsd] scores of a tile pair
  float* ys = gs + tr * gsd;           // [tr][p]  within-chunk y, q tile

  const float a_h = a[hh];
  for (int i = tid; i < n * p; i += kThreads) S[i] = 0.f;

  const long long row_bt = (long long)b * t;   // (b, t = 0) row index
  for (int c0 = 0; c0 < t; c0 += chunk) {
    __syncthreads();                   // the last chunk's readers are done
    for (int i = tid; i < chunk; i += kThreads)
      dts[i] = dt[(row_bt + c0 + i) * h + hh];
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < chunk; ++i) {
        run += dts[i] * a_h;
        cum[i] = run;
      }
    }
    __syncthreads();

    for (int q0 = 0; q0 < chunk; q0 += tr) {
      __syncthreads();                 // cs and ys are free
      for (int i = tid; i < tr * n; i += kThreads) {
        const int r = i / n, j = i % n;
        cs[r * ns + j] = cm[(row_bt + c0 + q0 + r) * n + j];
      }
      for (int i = tid; i < tr * p; i += kThreads) ys[i] = 0.f;

      for (int k0 = 0; k0 <= q0; k0 += tr) {
        __syncthreads();               // bs, xs and gs are free
        for (int i = tid; i < tr * n; i += kThreads) {
          const int r = i / n, j = i % n;
          bs[r * ns + j] = bm[(row_bt + c0 + k0 + r) * n + j];
        }
        for (int i = tid; i < tr * p; i += kThreads) {
          const int r = i / p, j = i % p;
          xs[i] = x[((row_bt + c0 + k0 + r) * h + hh) * p + j] *
                  dts[k0 + r];
        }
        __syncthreads();
        for (int i = tid; i < tr * tr; i += kThreads) {
          const int r = i / tr, kk = i % tr;
          const int qa = q0 + r, ka = k0 + kk;
          float g = 0.f;
          if (ka <= qa) {              // exp only where it is at most 1
            float dot = 0.f;
            for (int j = 0; j < n; ++j)
              dot = fmaf(cs[r * ns + j], bs[kk * ns + j], dot);
            g = dot * expf(cum[qa] - cum[ka]);
          }
          gs[r * gsd + kk] = g;
        }
        __syncthreads();
        for (int i = tid; i < tr * p; i += kThreads) {
          const int r = i / p, j = i % p;
          float acc = ys[i];
          for (int kk = 0; kk < tr; ++kk)
            acc = fmaf(gs[r * gsd + kk], xs[kk * p + j], acc);
          ys[i] = acc;
        }
      }

      // y = within-chunk term + exp(cum_q) C_q S_in
      for (int i = tid; i < tr * p; i += kThreads) {
        const int r = i / p, j = i % p;
        float acc = 0.f;
        for (int jn = 0; jn < n; ++jn)
          acc = fmaf(cs[r * ns + jn], S[jn * p + j], acc);
        y[((row_bt + c0 + q0 + r) * h + hh) * p + j] =
            ys[i] + acc * expf(cum[q0 + r]);
      }
    }

    // S <- exp(cum_last) S + sum_k B_k (exp(cum_last - cum_k) dt_k x_k)
    __syncthreads();                   // every reader of S_in is done
    const float last = cum[chunk - 1];
    const float decay = expf(last);
    for (int i = tid; i < n * p; i += kThreads) S[i] *= decay;
    for (int k0 = 0; k0 < chunk; k0 += tr) {
      __syncthreads();                 // bs and xs are free
      for (int i = tid; i < tr * n; i += kThreads) {
        const int r = i / n, j = i % n;
        bs[r * ns + j] = bm[(row_bt + c0 + k0 + r) * n + j];
      }
      for (int i = tid; i < tr * p; i += kThreads) {
        const int r = i / p, j = i % p;
        xs[i] = x[((row_bt + c0 + k0 + r) * h + hh) * p + j] *
                (expf(last - cum[k0 + r]) * dts[k0 + r]);
      }
      __syncthreads();
      for (int i = tid; i < n * p; i += kThreads) {
        const int jn = i / p, j = i % p;
        float acc = S[i];
        for (int kk = 0; kk < tr; ++kk)
          acc = fmaf(bs[kk * ns + jn], xs[kk * p + j], acc);
        S[i] = acc;
      }
    }
  }

  __syncthreads();
  float* sb = state_out + ((long long)b * h + hh) * n * p;
  for (int i = tid; i < n * p; i += kThreads) sb[i] = S[i];
}

int launch(const float* x, const float* dt, const float* a, const float* bm,
           const float* cm, float* y, float* state, int b, int t, int h,
           int p, int n, int chunk, cudaStream_t stream) {
  const int tr = chunk < kTile ? chunk : kTile;
  const size_t smem = sizeof(float) *
      ((size_t)n * p + 2 * chunk + 2 * tr * (n + 1) + 2 * tr * p +
       tr * (tr + 1));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)h, (unsigned)b);
  ssd_scan_kernel<<<grid, kThreads, smem, stream>>>(
      x, dt, a, bm, cm, y, state, t, h, p, n, chunk, tr);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes (all float32).  Launches on `stream` and
// returns cudaGetLastError() (0 = launched); the caller checks shapes,
// types, contiguity, that T is a multiple of chunk and that the shared
// memory fits.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* bm, const void* cm, void* y,
                               void* state, int b, int t, int h, int p, int n,
                               int chunk, void* stream) {
  if (b == 0 || h == 0) return 0;
  return launch((const float*)x, (const float*)dt, (const float*)a,
                (const float*)bm, (const float*)cm, (float*)y, (float*)state,
                b, t, h, p, n, chunk, (cudaStream_t)stream);
}
