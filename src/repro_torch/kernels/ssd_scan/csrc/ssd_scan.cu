// ssd_scan: the Mamba2 SSD chunked scan, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_ssd_kernel` of
// src/repro/kernels/ssd_scan/ssd_scan.py:26 (Pallas), reached through
// `ssd_scan_pallas` and `ops.ssd_scan`.  Same function as the plain
// version `repro_torch/kernels/ssd_scan/ref.py::ssd_chunked_core`: for
// every chunk of Q steps, with cum the running sum of dt * a inside the
// chunk and S the state carried in from the chunks before,
//   y[q]  = sum_{k <= q} (C_q . B_k) exp(cum_q - cum_k) dt_k x_k
//           + exp(cum_q) C_q S
//   S    <- exp(cum_last) S + sum_k B_k (exp(cum_last - cum_k) dt_k x_k)
// in float32, y in x's dtype, and the final S in float32.
//
// Layout: x and y [B, T, H, P], dt [B, T, H] float32, a [H] float32, B and
// C [B, T, N] in x's dtype, state [B, H, N, P] float32, all contiguous.
//
// Design: the TPU ran the chunk axis as a sequential grid axis with S in
// VMEM scratch.  Blocks here run in no order, so one block of 256 threads
// per (head, batch) walks the chunks in a loop and keeps S [N, P] in shared
// memory (128 x 64 float32 = 32 KB for mamba2-1.3b).  A chunk's Q x Q
// decay matrix would not fit (256 KB at Q = 256), so the block walks q
// tiles of 32 rows and, for each, the k tiles at or below the diagonal,
// building the 32 x 32 scores (C Bᵀ ∘ L) in shared memory.  The decay
// exp(cum_q - cum_k) is taken only where k <= q, where it is at most 1:
// above the diagonal the exponent is positive and could overflow.  The
// cumulative sum is a serial loop of one thread per chunk.  C Bᵀ does not
// depend on the head but is recomputed by every head's block: about
// Q² N / 2 multiply-adds per (head, chunk), 4.2 M of the 10.8 M a block
// spends on a chunk of mamba2-1.3b, so 64 heads redo it 63 times too often.
//
// Bound: at the serving path's shape (mamba2-1.3b prefill, B = 4, T = 1024,
// H = 64, P = 64, N = 128, chunk 256, bf16) the kernel must move about
// 79 MB (x and y 34 MB each, the f32 state 8 MB) and do about 13 GFLOP
// without the per-head recompute, so bytes bound it: about 24 us at
// 3.35 TB/s.  This kernel runs its products on the CUDA cores in float32
// from shared memory, one block per (head, batch), so 256 blocks fill the
// 132 SMs about twice: it sits far above the bound.  Sharing C Bᵀ across a
// group of heads, splitting the chunks over blocks (chunk states, then a
// scan) and moving the three products to wgmma are the next steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;            // q and k rows per tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, T* __restrict__ y,
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
        cs[r * ns + j] = to_f32(cm[(row_bt + c0 + q0 + r) * n + j]);
      }
      for (int i = tid; i < tr * p; i += kThreads) ys[i] = 0.f;

      for (int k0 = 0; k0 <= q0; k0 += tr) {
        __syncthreads();               // bs, xs and gs are free
        for (int i = tid; i < tr * n; i += kThreads) {
          const int r = i / n, j = i % n;
          bs[r * ns + j] = to_f32(bm[(row_bt + c0 + k0 + r) * n + j]);
        }
        for (int i = tid; i < tr * p; i += kThreads) {
          const int r = i / p, j = i % p;
          xs[i] = to_f32(x[((row_bt + c0 + k0 + r) * h + hh) * p + j]) *
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
        store(&y[((row_bt + c0 + q0 + r) * h + hh) * p + j],
              ys[i] + acc * expf(cum[q0 + r]));
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
        bs[r * ns + j] = to_f32(bm[(row_bt + c0 + k0 + r) * n + j]);
      }
      for (int i = tid; i < tr * p; i += kThreads) {
        const int r = i / p, j = i % p;
        xs[i] = to_f32(x[((row_bt + c0 + k0 + r) * h + hh) * p + j]) *
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

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, void* y, void* state, int b, int t, int h, int p,
           int n, int chunk, cudaStream_t stream) {
  const int tr = chunk < kTile ? chunk : kTile;
  const size_t smem = sizeof(float) *
      ((size_t)n * p + 2 * chunk + 2 * tr * (n + 1) + 2 * tr * p +
       tr * (tr + 1));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)h, (unsigned)b);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)a, (const T*)bm,
      (const T*)cm, (T*)y, (float*)state, t, h, p, n, chunk, tr);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  dtype 0 = float32, 1 = bfloat16 (of x,
// B, C and y).  Launches on `stream` and returns cudaGetLastError()
// (0 = launched); the caller checks shapes, types, contiguity, that T is a
// multiple of chunk and that the shared memory fits.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* bm, const void* cm, void* y,
                               void* state, int b, int t, int h, int p, int n,
                               int chunk, int dtype, void* stream) {
  if (b == 0 || h == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, dt, a, bm, cm, y, state, b, t, h, p, n, chunk, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, a, bm, cm, y, state, b, t, h, p, n,
                                 chunk, s);
  return (int)cudaErrorInvalidValue;
}
