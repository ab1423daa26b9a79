// ssd_scan_bf16: the Mamba2 SSD chunked scan for bfloat16 inputs, split
// into chunk-parallel passes on Hopper's tensor cores (sm_90a).
//
// Replaces the TPU kernel `_ssd_kernel` of
// src/repro/kernels/ssd_scan/ssd_scan.py:26 (Pallas), reached through
// `ssd_scan_pallas` and `ops.ssd_scan`, for bf16 inputs.  Same function as
// the plain version `repro_torch/kernels/ssd_scan/ref.py::ssd_chunked_core`:
// per chunk of Q steps, with cum the running sum of dt * a inside the
// chunk,
//   y[q]  = sum_{k <= q} (C_q . B_k) exp(cum_q - cum_k) dt_k x_k
//           + exp(cum_q) C_q S_in
//   S_out = exp(cum_last) S_in + sum_k B_k (exp(cum_last - cum_k) dt_k x_k)
// y in bf16, the final S in float32.  `ref.py::ssd_decomposed` follows
// these kernels pass for pass, roundings included.
//
// Layout: x and y [B, T, H, P], dt [B, T, H] float32, a [H] float32, B and
// C [B, T, N] bf16, state [B, H, N, P] float32, all contiguous.  Scratch,
// allocated by the wrapper: cum [B, nc, H, Q], cb [B, nc, Q, ldcb] (ldcb =
// Q rounded up to 4) and the incoming states [B, nc, H, N, P], float32.
//
// Bound: at the serving path's shape (mamba2-1.3b prefill, B 4, T 1024,
// H 64, P 64, N 128, chunk 256) the kernels must move about 79 MB (x and y
// 34 MB each, the f32 state 8 MB) for about 13 GFLOP: bytes bound it,
// about 24 us at 3.35 TB/s.  The incoming states add 34 MB written and
// read back, C Bᵀ 4 MB, and x is read twice.
//
// Design (the decomposition of Mamba2's own chunked implementation: chunk
// cumsum, bmm_chunk, chunk_state + state_passing, chunk_scan), four
// kernels in stream order:
//   1. ssd_cumsum_kernel: one warp per (b, chunk, head) scans dt * a over
//      the chunk with warp shuffles, 32 steps at a time.
//   2. ssd_cb_kernel: C Bᵀ once per (b, chunk), the 64 x 64 tiles on and
//      below the diagonal: bf16 mma.sync m16n8k16 with f32 accumulation,
//      exact up to the order of the sums (B and C are bf16 already).  It
//      does not depend on the head, so no head recomputes it.
//   3. ssd_state_kernel: per (b, head) the chunks in order, S in
//      registers: store S as chunk c's incoming state, then
//      S = exp(cum_last) S + Bᵀ W with W[k] = exp(cum_last - cum_k) dt_k x_k
//      (TF32 mma.sync m16n8k8, B exact, W split into TF32 hi + lo: two
//      products); the last S is
//      the final state.  Only this pass is serial over chunks; its
//      registers are capped so that two blocks share an SM and all
//      B H blocks of the serving shape run in one wave.
//   4. ssd_chunk_kernel: per (b, chunk, head, 64-row q tile) the output.
//      With m = cum at the tile's first row, every factor at most 1:
//        acc  = exp(m) (C S_in)
//        acc += (C Bᵀ)[q, k] (exp(m - cum_k) dt_k x_k)   k tiles below q's
//        acc *= exp(cum_q - m)
//        acc += (C Bᵀ ∘ L)[q, k] (dt_k x_k)               the diagonal tile
//      with L = exp(cum_q - cum_k) taken only where k <= q (above it the
//      exponent is positive and may overflow) and the mask a select.  So
//      only the diagonal tile takes an exp per element; the others take
//      one per row.  All products are TF32 mma.sync on split operands:
//      C S_in two per product (C exact, S_in hi + lo), the k tiles three
//      (hi hi, hi lo, lo hi).
// Kernels 2-4 stream their tiles with cp.async into a two-stage ring (the
// next tile lands while this one is multiplied) and apply the operand
// transforms (bf16 to f32, the decay factors, the TF32 split) as they
// load fragments.  This gives B nc H independent units for the quadratic
// work (1024 at the serving shape, against 256 blocks walking the chunks
// before).  Ragged tiles (Q, N or P below a tile) are zero-filled in
// shared memory and their edges are not stored; rows that are not 16-byte
// aligned (N or P not a multiple of 8) are staged element by element.
//
// Numerics: every product with an f32 intermediate operand splits it into
// two TF32 values, hi + lo, and takes the products that matter (hi hi, hi
// lo, lo hi; lo lo is below f32's rounding): about 21 bits per product,
// so the kernels add no rounding of note that the plain path (f32 inside)
// lacks.  With one TF32 operand per product (10 bits), an output near 0,
// where terms of about 100 cancel, could miss the 3e-2 the route is held
// to (one of 16.7 M outputs did at the serving shape), and full-depth
// bf16 serving drifted from the plain path's logits.  The f32 route stays
// on exact f32 FMAs in ssd_scan.cu, as its 1e-4 tolerance needs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kT = 64;               // rows (chunk positions) per tile
constexpr int kPT = 64;              // P columns per tile
constexpr int kNT = 64;              // N columns per step of C Bᵀ
constexpr int kNC = 32;              // N columns per step of C S_in
constexpr int kPitchC = kNC + 8;     // bf16 C tile of a C S_in step
constexpr int kNS = 128;             // N rows per block of the chunk states
constexpr int kPitchA = kT + 4;      // f32 A tiles [row][k]
constexpr int kPitchB = kPT + 8;     // f32 B tiles [k][col]
constexpr int kPitchH = 72;          // bf16 tiles of 64 columns
constexpr int kPitchS = kNS + 8;     // bf16 B tile of the chunk states

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// v as two TF32 operands, hi + lo: the products hi hi, hi lo and lo hi of
// two split operands keep about 21 bits of each product
__device__ __forceinline__ void tf32_split(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

// a bf16 as a tf32 operand: exact, bf16 keeps 7 of tf32's 10 bits
__device__ __forceinline__ uint32_t tf32(bf16 x) {
  return __float_as_uint(__bfloat162float(x));
}

__device__ __forceinline__ float f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D (+)= A B: m16n8k16, A row-major bf16, B column-major bf16, f32 D
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// D (+)= A B: m16n8k8, A row-major tf32, B column-major tf32, f32 D
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Fragment owners (mma.sync): lane = 4 g + t holds D rows g and g + 8,
// columns 2 t and 2 t + 1 of every 8-column block.

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying a kRows x kCols tile of T into shared memory (row pitch
// kPitch): row r comes from src + r * ld, `rows` rows and `cols` columns
// exist, the rest is zero-filled.  With `vec` (rows 16-byte aligned) by
// 16-byte cp.async, whose zero-fill covers the ragged edge; otherwise by
// plain element loads.  `safe` is any valid address, the source of the
// copies that read nothing.
template <typename T, int kRows, int kCols, int kPitch, int kBlock>
__device__ __forceinline__ void tile_load(T* dst, const T* src, long long ld,
                                          int rows, int cols, bool vec,
                                          const T* safe) {
  constexpr int kEl = 16 / sizeof(T);      // elements per 16 bytes
  constexpr int kCpr = kCols / kEl;        // 16-byte copies per row
  if (vec) {
    for (int i = threadIdx.x; i < kRows * kCpr; i += kBlock) {
      const int r = i / kCpr, c = (i % kCpr) * kEl;
      const int n = r < rows ? max(0, min(kEl, cols - c)) : 0;
      const T* s = n > 0 ? src + r * ld + c : safe;
      asm volatile(
          "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
              smem_u32(dst + r * kPitch + c)),
          "l"(s), "r"(n * (int)sizeof(T))
          : "memory");
    }
  } else {
    for (int i = threadIdx.x; i < kRows * kCols; i += kBlock) {
      const int r = i / kCols, c = i % kCols;
      dst[r * kPitch + c] = r < rows && c < cols ? src[r * ld + c] : T(0.f);
    }
  }
}

// 1. cum[b, c, h, k] = sum_{i <= k} dt[b, cQ + i, h] a[h]
__global__ void __launch_bounds__(256)
ssd_cumsum_kernel(const float* __restrict__ dt, const float* __restrict__ a,
                  float* __restrict__ cum, int h, int chunk,
                  long long units) {
  const long long u = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (u >= units) return;
  const int lane = threadIdx.x % 32;
  const int hh = (int)(u % h);
  const long long row0 = u / h * chunk;            // (b, c Q) as a row of T
  const float a_h = a[hh];
  float* out = cum + u * chunk;
  float carry = 0.f;
  for (int k0 = 0; k0 < chunk; k0 += 32) {
    const int k = k0 + lane;
    float v = k < chunk ? dt[(row0 + k) * h + hh] * a_h : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float w = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += w;
    }
    v += carry;
    if (k < chunk) out[k] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// 2. cb[b, c, q, k] = C[q] . B[k] for the 64 x 64 tiles with k tile <= q
// tile.  Block: 4 warps, warp w owns rows 16 w .. 16 w + 15 of the tile;
// N is walked 64 columns at a time through a two-stage ring.
__global__ void __launch_bounds__(128)
ssd_cb_kernel(const bf16* __restrict__ bm, const bf16* __restrict__ cm,
              float* __restrict__ cb, int n, int chunk, int ldcb, int vec) {
  __shared__ __align__(16) bf16 cs[2][kT * kPitchH];
  __shared__ __align__(16) bf16 bs[2][kT * kPitchH];
  int i = blockIdx.y, qt = 0;                      // blockIdx.y -> (qt, kt)
  while (i > qt) i -= ++qt;
  const int kt = i;
  const long long bc = blockIdx.x;                 // b * nc + c
  const long long row0 = bc * chunk;
  const int q0 = qt * kT, k0 = kt * kT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4, ra = 16 * warp + g;
  const int steps = (n + kNT - 1) / kNT;
  auto issue = [&](int st) {
    const int n0 = st * kNT;
    tile_load<bf16, kT, kNT, kPitchH, 128>(
        cs[st & 1], cm + (row0 + q0) * n + n0, n, chunk - q0, n - n0, vec,
        cm);
    tile_load<bf16, kT, kNT, kPitchH, 128>(
        bs[st & 1], bm + (row0 + k0) * n + n0, n, chunk - k0, n - n0, vec,
        bm);
    cp_commit();
  };

  float acc[8][4] = {};
  issue(0);
  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) {
      issue(st + 1);                               // lands during this step
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* c_s = cs[st & 1];
    const bf16* b_s = bs[st & 1];
#pragma unroll
    for (int kk = 0; kk < kNT / 16; ++kk) {
      const int kc = 16 * kk + 2 * tq;
      const uint32_t a0 = ld32(&c_s[ra * kPitchH + kc]);
      const uint32_t a1 = ld32(&c_s[(ra + 8) * kPitchH + kc]);
      const uint32_t a2 = ld32(&c_s[ra * kPitchH + kc + 8]);
      const uint32_t a3 = ld32(&c_s[(ra + 8) * kPitchH + kc + 8]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mma_bf16(acc[j], a0, a1, a2, a3,
                 ld32(&b_s[(8 * j + g) * kPitchH + kc]),
                 ld32(&b_s[(8 * j + g) * kPitchH + kc + 8]));
    }
    __syncthreads();                               // the stage is free again
  }
  float* out = cb + bc * chunk * ldcb;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = q0 + ra + 8 * (e / 2);
      const int col = k0 + 8 * j + 2 * tq + (e & 1);
      if (r < chunk && col < chunk) out[(long long)r * ldcb + col] = acc[j][e];
    }
}

// 3. Per (b, h) and a 128 (n) x 64 (p) tile of the state: the chunks in
// order, S in registers.  Block: 8 warps, warp w owns n rows 16 w ..
// 16 w + 15; each chunk is walked 64 positions at a time through a
// two-stage ring of B [k][n] and x [k][p] tiles.
struct StateStage {
  bf16 b[kT * kPitchS];
  bf16 x[kT * kPitchH];
  float fac[kT];                     // exp(cum_last - cum_k) dt_k
};

__global__ void __launch_bounds__(256, 2)
ssd_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const bf16* __restrict__ bm, const float* __restrict__ cum,
                 float* __restrict__ s_in, float* __restrict__ state_out,
                 int h, int p, int n, int chunk, int nc, int vec) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  StateStage* stage = reinterpret_cast<StateStage*>(smem_raw);
  const long long bh = blockIdx.x;                 // b * H + h
  const long long b = bh / h;
  const int hh = (int)(bh % h);
  const int n_pt = (p + kPT - 1) / kPT;
  const int p0 = (blockIdx.y % n_pt) * kPT, nb = (blockIdx.y / n_pt) * kNS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4, ra = 16 * warp + g;
  const int per_chunk = (chunk + kT - 1) / kT;
  const int steps = nc * per_chunk;
  // loaded a step ahead: cum and dt of this thread's k row, cum_last
  float ck = 0.f, dk = 0.f, last = 0.f;
  auto issue = [&](int st) {
    const int c = st / per_chunk, k0 = (st % per_chunk) * kT;
    const long long row = (b * nc + c) * chunk + k0;
    StateStage& s = stage[st & 1];
    tile_load<bf16, kT, kNS, kPitchS, 256>(s.b, bm + row * n + nb, n,
                                           chunk - k0, n - nb, vec, bm);
    tile_load<bf16, kT, kPT, kPitchH, 256>(s.x, x + (row * h + hh) * p + p0,
                                           (long long)h * p, chunk - k0,
                                           p - p0, vec, x);
    cp_commit();
    const float* cum_c = cum + ((b * nc + c) * h + hh) * chunk;
    last = cum_c[chunk - 1];
    const int k = k0 + threadIdx.x;
    if (threadIdx.x < kT && k < chunk) {
      ck = cum_c[k];
      dk = dt[(row + threadIdx.x) * h + hh];
    }
  };

  float acc[8][4] = {};              // S rows nb + ra (+8), columns p0 + ...
  const bool active = nb + 16 * warp < n;
  issue(0);
  for (int st = 0; st < steps; ++st) {
    const int c = st / per_chunk, k0 = (st % per_chunk) * kT;
    if (threadIdx.x < kT)            // this step's factors, loaded last step
      stage[st & 1].fac[threadIdx.x] =
          k0 + threadIdx.x < chunk ? expf(last - ck) * dk : 0.f;
    if (k0 == 0) {                   // a new chunk: S is its incoming state
      if (active) {
        float* out = s_in + ((b * nc + c) * h + hh) * n * p;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = nb + ra + 8 * (e / 2);
            const int col = p0 + 8 * j + 2 * tq + (e & 1);
            if (r < n && col < p) out[(long long)r * p + col] = acc[j][e];
          }
      }
      const float decay = expf(last);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= decay;
    }
    if (st + 1 < steps) {
      issue(st + 1);                 // lands during this step
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const StateStage& s = stage[st & 1];
    if (active) {
#pragma unroll
      for (int k8 = 0; k8 < kT; k8 += 8) {
        // A = Bᵀ: A[n][k] = B[k][n]
        const uint32_t a0 = tf32(s.b[(k8 + tq) * kPitchS + ra]);
        const uint32_t a1 = tf32(s.b[(k8 + tq) * kPitchS + ra + 8]);
        const uint32_t a2 = tf32(s.b[(k8 + tq + 4) * kPitchS + ra]);
        const uint32_t a3 = tf32(s.b[(k8 + tq + 4) * kPitchS + ra + 8]);
        const float f0 = s.fac[k8 + tq], f1 = s.fac[k8 + tq + 4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t w0, w0l, w1, w1l;   // W split, B exact: two products
          tf32_split(f0 * f32(s.x[(k8 + tq) * kPitchH + 8 * j + g]), w0,
                     w0l);
          tf32_split(f1 * f32(s.x[(k8 + tq + 4) * kPitchH + 8 * j + g]),
                     w1, w1l);
          mma_tf32(acc[j], a0, a1, a2, a3, w0l, w1l);
          mma_tf32(acc[j], a0, a1, a2, a3, w0, w1);
        }
      }
    }
    __syncthreads();                 // the stage is free again
  }
  if (!active) return;
  float* out = state_out + bh * n * p;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = nb + ra + 8 * (e / 2);
      const int col = p0 + 8 * j + 2 * tq + (e & 1);
      if (r < n && col < p) out[(long long)r * p + col] = acc[j][e];
    }
}

// 4. y for one 64-row q tile and 64 P columns of one (b, c, h).  Block: 4
// warps, warp w owns q rows 16 w .. 16 w + 15.  Steps: N / 32 steps of
// C S_in, then the k tiles 0 .. qt, through a two-stage ring small enough
// (53 KB) for four blocks per SM.
struct ChunkStage {
  float a[kT * kPitchA];             // C rows (bf16 view) or C Bᵀ rows
  float b[kNC * kPitchB];            // S_in rows (f32) or x rows (bf16 view)
  float fk[kT], ck[kT];              // per k row: B's factor, cum
};

__global__ void __launch_bounds__(128)
ssd_chunk_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const bf16* __restrict__ cm, const float* __restrict__ cum,
                 const float* __restrict__ cb, const float* __restrict__ s_in,
                 bf16* __restrict__ y, int h, int p, int n, int chunk,
                 int ldcb, int vec) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  ChunkStage* stage = reinterpret_cast<ChunkStage*>(smem_raw);
  const long long u = blockIdx.x;    // (b * nc + c) * H + h
  const int hh = (int)(u % h);
  const long long bc = u / h;
  const long long row0 = bc * chunk;
  const int n_pt = (p + kPT - 1) / kPT;
  const int n_qt = (chunk + kT - 1) / kT;
  const int qt = n_qt - 1 - (int)(blockIdx.y / n_pt);  // heaviest first
  const int q0 = qt * kT, p0 = (blockIdx.y % n_pt) * kPT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4, ra = 16 * warp + g;
  const float* cum_c = cum + u * chunk;
  const float* cb_c = cb + bc * chunk * ldcb;
  const float m = cum_c[q0];         // cum at the tile's first row
  const float cq[2] = {q0 + ra < chunk ? cum_c[q0 + ra] : m,
                       q0 + ra + 8 < chunk ? cum_c[q0 + ra + 8] : m};
  const int n_steps = (n + kNC - 1) / kNC;
  const int steps = n_steps + qt + 1;
  float ck = 0.f, dk = 0.f;          // cum and dt of this thread's k row
  auto issue = [&](int st) {
    ChunkStage& s = stage[st & 1];
    if (st < n_steps) {              // C rows and S_in rows
      const int n0 = st * kNC;
      tile_load<bf16, kT, kNC, kPitchC, 128>(
          reinterpret_cast<bf16*>(s.a), cm + (row0 + q0) * n + n0, n,
          chunk - q0, n - n0, vec, cm);
      tile_load<float, kNC, kPT, kPitchB, 128>(
          s.b, s_in + (u * n + n0) * p + p0, p, n - n0, p - p0, vec, s_in);
    } else {                         // C Bᵀ rows and x rows of k tile kt
      const int k0 = (st - n_steps) * kT;
      tile_load<float, kT, kT, kPitchA, 128>(
          s.a, cb_c + (long long)q0 * ldcb + k0, ldcb, chunk - q0,
          chunk - k0, true, cb);
      tile_load<bf16, kT, kPT, kPitchH, 128>(
          reinterpret_cast<bf16*>(s.b), x + ((row0 + k0) * h + hh) * p + p0,
          (long long)h * p, chunk - k0, p - p0, vec, x);
      const int k = k0 + threadIdx.x;
      if (threadIdx.x < kT && k < chunk) {
        ck = cum_c[k];
        dk = dt[(row0 + k) * h + hh];
      }
    }
    cp_commit();
  };

  float acc[8][4] = {};
  issue(0);
  for (int st = 0; st < steps; ++st) {
    const bool diag = st == steps - 1;
    if (st >= n_steps && threadIdx.x < kT) {  // factors, loaded last step
      const bool in = (st - n_steps) * kT + threadIdx.x < chunk;
      stage[st & 1].fk[threadIdx.x] =
          !in ? 0.f : diag ? dk : expf(m - ck) * dk;
      stage[st & 1].ck[threadIdx.x] = in ? ck : 0.f;
    }
    if (st == n_steps) {             // C S_in is complete: times exp(m)
      const float em = expf(m);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= em;
    }
    if (diag) {                      // the tiles below are in: exp(cq - m)
      const float d0 = expf(cq[0] - m), d1 = expf(cq[1] - m);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] *= d0;
        acc[j][1] *= d0;
        acc[j][2] *= d1;
        acc[j][3] *= d1;
      }
    }
    if (st + 1 < steps) {
      issue(st + 1);                 // lands during this step
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const ChunkStage& s = stage[st & 1];
    if (st < n_steps) {
      const bf16* c_s = reinterpret_cast<const bf16*>(s.a);
#pragma unroll
      for (int k8 = 0; k8 < kNC; k8 += 8) {
        const uint32_t a0 = tf32(c_s[ra * kPitchC + k8 + tq]);
        const uint32_t a1 = tf32(c_s[(ra + 8) * kPitchC + k8 + tq]);
        const uint32_t a2 = tf32(c_s[ra * kPitchC + k8 + tq + 4]);
        const uint32_t a3 = tf32(c_s[(ra + 8) * kPitchC + k8 + tq + 4]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t s0, s0l, s1, s1l;   // S_in split, C exact: two products
          tf32_split(s.b[(k8 + tq) * kPitchB + 8 * j + g], s0, s0l);
          tf32_split(s.b[(k8 + tq + 4) * kPitchB + 8 * j + g], s1, s1l);
          mma_tf32(acc[j], a0, a1, a2, a3, s0l, s1l);
          mma_tf32(acc[j], a0, a1, a2, a3, s0, s1);
        }
      }
    } else {
      const bf16* x_s = reinterpret_cast<const bf16*>(s.b);
      const int k0 = (st - n_steps) * kT;
#pragma unroll
      for (int k8 = 0; k8 < kT; k8 += 8) {
        uint32_t a[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = ra + 8 * (e & 1), kk = k8 + tq + 4 * (e / 2);
          float v = s.a[r * kPitchA + kk];
          if (diag) {                // the decay only where k <= q (<= 1)
            const bool keep = q0 + r < chunk && k0 + kk <= q0 + r;
            v = keep ? v * expf(cq[e & 1] - s.ck[kk]) : 0.f;
          }
          tf32_split(v, a[e], al[e]);
        }
        const float f0 = s.fk[k8 + tq], f1 = s.fk[k8 + tq + 4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t b0, b0l, b1, b1l;   // both split: three products
          tf32_split(f0 * f32(x_s[(k8 + tq) * kPitchH + 8 * j + g]), b0,
                     b0l);
          tf32_split(f1 * f32(x_s[(k8 + tq + 4) * kPitchH + 8 * j + g]),
                     b1, b1l);
          mma_tf32(acc[j], al[0], al[1], al[2], al[3], b0, b1);
          mma_tf32(acc[j], a[0], a[1], a[2], a[3], b0l, b1l);
          mma_tf32(acc[j], a[0], a[1], a[2], a[3], b0, b1);
        }
      }
    }
    __syncthreads();                 // the stage is free again
  }

#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = q0 + ra + 8 * (e / 2);
      const int col = p0 + 8 * j + 2 * tq + (e & 1);
      if (r < chunk && col < p)
        y[((row0 + r) * h + hh) * p + col] = __float2bfloat16_rn(acc[j][e]);
    }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// Plain C entry point for ctypes: the four kernels on `stream`, in order.
// Returns the first launch error (0 = all launched); the caller checks
// shapes, dtypes (bf16 x, B, C; f32 dt, a), contiguity and T % chunk == 0,
// and allocates the float32 scratch cum [B, nc, H, Q], cb [B, nc, Q, ldcb]
// and s_in [B, nc, H, N, P].
extern "C" int ssd_scan_bf16_launch(const void* x, const void* dt,
                                    const void* a, const void* bm,
                                    const void* cm, void* y, void* state,
                                    void* cum, void* cb, void* s_in, int b,
                                    int t, int h, int p, int n, int chunk,
                                    int ldcb, void* stream) {
  if (b == 0 || h == 0 || t == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int nc = t / chunk;
  const long long units = (long long)b * nc * h;
  const auto* xb = (const bf16*)x;
  const auto* bb = (const bf16*)bm;
  const auto* cc = (const bf16*)cm;
  // 16-byte rows: B and C need N % 8 == 0, x needs P % 8 == 0
  const int vec = n % 8 == 0 && p % 8 == 0 && aligned16(x) &&
                  aligned16(bm) && aligned16(cm);
  cudaError_t err;

  ssd_cumsum_kernel<<<(unsigned)((units + 7) / 8), 256, 0, s>>>(
      (const float*)dt, (const float*)a, (float*)cum, h, chunk, units);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int n_qt = (chunk + kT - 1) / kT;
  ssd_cb_kernel<<<dim3(b * nc, n_qt * (n_qt + 1) / 2), 128, 0, s>>>(
      bb, cc, (float*)cb, n, chunk, ldcb, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int n_pt = (p + kPT - 1) / kPT;
  const size_t state_smem = 2 * sizeof(StateStage);
  err = cudaFuncSetAttribute(ssd_state_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)state_smem);
  if (err != cudaSuccess) return (int)err;
  ssd_state_kernel<<<dim3(b * h, n_pt * ((n + kNS - 1) / kNS)), 256,
                     state_smem, s>>>(xb, (const float*)dt, bb,
                                      (const float*)cum, (float*)s_in,
                                      (float*)state, h, p, n, chunk, nc, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t chunk_smem = 2 * sizeof(ChunkStage);
  err = cudaFuncSetAttribute(ssd_chunk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)chunk_smem);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_kernel<<<dim3((unsigned)units, n_qt * n_pt), 128, chunk_smem,
                     s>>>(xb, (const float*)dt, cc, (const float*)cum,
                          (const float*)cb, (const float*)s_in, (bf16*)y, h,
                          p, n, chunk, ldcb, vec);
  return (int)cudaGetLastError();
}
