// flash_attention: forward softmax attention with an online softmax for
// float32 inputs, written by hand for Hopper (sm_90a).  bfloat16 inputs
// take flash_attention_bf16.cu (tensor cores); this kernel is the f32
// route.
//
// Replaces the TPU kernel `_fa_kernel` of
// src/repro/kernels/flash_attention/flash_attention.py:28 (Pallas), reached
// through `flash_attention_bhsd` and `ops.flash_attention`, for float32
// inputs.  Same function as the plain version
// `repro_torch/kernels/flash_attention/ops.py::flash_attention_plain`: q is
// scaled by 1/sqrt(hd) in float32, scores outside the causal /
// sliding-window mask are -1e30, the running (m, l, acc) are float32, k
// tiles outside [lo, hi) are skipped, and the output is acc / max(l, 1e-30).
//
// Layout: q and o [B, Tq, H, hd], k and v [B, Tk, KV, hd], contiguous
// float32, hd in {16, 32, 64, 128, 256} (at hd 256 the tiles take
// smem_bytes<256>() = 217,600 B, one block per SM).  The GQA repeat is not materialised: q head h reads kv head
// h / (H / KV), the head `jnp.repeat` would have put there.
//
// Design: one block of 256 threads per (batch * head, 64-row q tile).  The
// block stages the q tile and each 64-row k and v tile in shared memory
// (q and k rows padded by one float, so the 16 lanes that read 16
// different k rows hit 16 banks).  Thread (ty, tx) of a 16 x 16 grid owns
// score rows ty + 16 i and columns tx + 16 j, and output rows ty + 16 i and
// columns tx + 16 d; a score row's 16 owners are one half-warp, so the row
// max and row sum are xor-shuffles.
//
// Bound and why it stays on the CUDA cores: float32 inputs are held to
// 2e-5 (tests) and 1e-3 (the full-depth model) against the plain version,
// which TF32 or bf16 tensor-core products cannot meet, so the products are
// exact float32 FMAs; the card's 67 TFLOP/s float32 rate bounds them
// (about 0.26 ms at qwen3-1.7b's prefill shape in f32).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;              // q rows per block
constexpr int kBK = 64;              // k rows per tile
constexpr int kPS = kBK + 16;        // row stride of the probability tile
constexpr float kNegInf = -1e30f;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBQ * kPS);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int tq,
                 int tk, int h, int kvh, int causal, int window,
                 float sm_scale) {
  constexpr int kQS = HD + 1;          // padded row stride of q and k tiles
  constexpr int kR = kBQ / 16;         // rows per thread
  constexpr int kC = kBK / 16;         // score columns per thread
  constexpr int kD = HD / 16;          // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                    // [kBQ][kQS]
  float* ks = qs + kBQ * kQS;          // [kBK][kQS]
  float* vs = ks + kBK * kQS;          // [kBK][HD]
  float* ps = vs + kBK * HD;           // [kBQ][kPS]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh % h;
  const int kh = hh / (h / kvh);
  const int q_start = blockIdx.y * kBQ;
  const long long q_row = (long long)h * HD;    // elements between q rows
  const long long k_row = (long long)kvh * HD;  // elements between k rows
  const float* qb = q + ((long long)b * tq * h + hh) * HD;
  const float* kb = k + ((long long)b * tk * kvh + kh) * HD;
  const float* vb = v + ((long long)b * tk * kvh + kh) * HD;
  float* ob = o + ((long long)b * tq * h + hh) * HD;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    qs[r * kQS + d] = qb[(q_start + r) * q_row + d] * sm_scale;
  }

  // k tiles that any row of this q tile can see (the Pallas lo / hi)
  const int n_k = tk / kBK;
  const int hi = causal ? min((q_start + kBQ + kBK - 1) / kBK, n_k) : n_k;
  const int lo = window > 0 ? max((q_start - window) / kBK, 0) : 0;

  float m[kR], l[kR], acc[kR][kD];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < kD; ++d) acc[i][d] = 0.f;
  }

  for (int kt = lo; kt < hi; ++kt) {
    __syncthreads();                   // the previous tile's readers are done
    const int k_start = kt * kBK;
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const long long g = (k_start + r) * k_row + d;
      ks[r * kQS + d] = kb[g];
      vs[r * HD + d] = vb[g];
    }
    __syncthreads();

    float s[kR][kC];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) s[i][j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      float qv[kR], kv[kC];
#pragma unroll
      for (int i = 0; i < kR; ++i) qv[i] = qs[(ty + 16 * i) * kQS + d];
#pragma unroll
      for (int j = 0; j < kC; ++j) kv[j] = ks[(tx + 16 * j) * kQS + d];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int qp = q_start + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int kp = k_start + tx + 16 * j;
        bool keep = true;
        if (causal) keep = keep && qp >= kp;
        if (window > 0) keep = keep && (qp - kp) < window;
        if (!keep) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_cur = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_cur);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const float p = expf(s[i][j] - m_cur);
        ps[(ty + 16 * i) * kPS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_cur;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[i][d] *= alpha;
    }
    __syncthreads();                   // the probability tile is complete

    for (int c = 0; c < kBK; ++c) {
      float pv[kR], vv[kD];
#pragma unroll
      for (int i = 0; i < kR; ++i) pv[i] = ps[(ty + 16 * i) * kPS + c];
#pragma unroll
      for (int d = 0; d < kD; ++d) vv[d] = vs[c * HD + tx + 16 * d];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int d = 0; d < kD; ++d) acc[i][d] = fmaf(pv[i], vv[d], acc[i][d]);
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const float den = fmaxf(l[i], 1e-30f);
    const long long row = (long long)(q_start + ty + 16 * i) * q_row;
#pragma unroll
    for (int d = 0; d < kD; ++d)
      ob[row + tx + 16 * d] = acc[i][d] / den;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int tq, int tk, int h, int kvh, int causal, int window,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float sm_scale = (float)(1.0 / sqrt((double)HD));
  const dim3 grid((unsigned)(b * h), (unsigned)(tq / kBQ));
  flash_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, tq, tk, h,
      kvh, causal, window, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  window 0 = no window.  Launches on
// `stream` and returns cudaGetLastError() (0 = launched); the caller checks
// shapes, the dtype (float32), contiguity and that Tq and Tk are multiples
// of 64.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int tq,
                                      int tk, int h, int kvh, int hd,
                                      int causal, int window, void* stream) {
  if (b == 0 || tq == 0 || h == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 16: return launch<16>(q, k, v, o, b, tq, tk, h, kvh, causal, window, s);
    case 32: return launch<32>(q, k, v, o, b, tq, tk, h, kvh, causal, window, s);
    case 64: return launch<64>(q, k, v, o, b, tq, tk, h, kvh, causal, window, s);
    case 128: return launch<128>(q, k, v, o, b, tq, tk, h, kvh, causal, window, s);
    case 256: return launch<256>(q, k, v, o, b, tq, tk, h, kvh, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
