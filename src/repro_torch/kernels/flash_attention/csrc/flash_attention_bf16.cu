// flash_attention_bf16: forward softmax attention for bfloat16 inputs on
// Hopper's tensor cores (sm_90a): wgmma products fed by a TMA ring.
//
// Replaces the TPU kernel `_fa_kernel` of
// src/repro/kernels/flash_attention/flash_attention.py:28 (Pallas), reached
// through `flash_attention_bhsd` and `ops.flash_attention`, for bf16
// inputs.  Same function as the plain version
// `repro_torch/kernels/flash_attention/ops.py::flash_attention_plain`:
// scores q.k / sqrt(hd) in float32, -1e30 outside the causal /
// sliding-window mask, running (m, l, acc) in float32, k tiles outside
// [lo, hi) skipped, output acc / max(l, 1e-30) in bf16.  The one rounding
// the plain version does not make: the softmax weights P are rounded to
// bf16 as the A operand of P V, as the model's plain bf16 path and SDPA do
// (on the TPU an f32 dot at default precision also fed the MXU bf16).
//
// Layout: q and o [B, Tq, H, hd], k and v [B, Tk, KV, hd], contiguous bf16,
// Tq and Tk multiples of 64, hd in {16, 32, 64, 128}.  GQA is read in
// place: q head h reads kv head h / (H / KV).
//
// Bound: at the serving path's shape (qwen3-1.7b prefill, [4, 1024, 16,
// 128] with 8 kv heads, causal) the work is 17.2 GFLOP against about
// 50 MB moved: operations bound it, about 17 us at the tensor cores' bf16
// rate.  So the products must run on the tensor cores and the tile loads
// must hide behind them.
//
// Design: one block = two consumer warpgroups + one producer warp.  Each
// consumer warpgroup owns 64 q rows; when H / KV is even the two take the
// same 64 q positions of two q heads that share a kv head, so every K/V
// tile is loaded once for both (half the K/V traffic); otherwise they take
// two consecutive q tiles of one head.  The producer's one thread loads Q
// once and then K and V tiles of 64 keys with TMA into a ring of kStages
// stages (full / empty mbarriers).  TMA writes each tile in panels of at
// most 64 columns with the widest swizzle the panel allows (128 B, or
// 64 / 32 B for hd 32 / 16), and the wgmma descriptors read the same
// layout.  A consumer runs S = Q Kᵀ (m64n64k16, Q and K from shared
// memory), the online softmax on S in registers (exp2 with the scale
// folded in), and O += P V (m64n{hd}k16, P from registers as bf16, V from
// shared memory with the transpose bit), pipelined inside the warpgroup:
// S of tile j is issued together with P V of tile j - 1, so the tensor
// cores run P V while the softmax of tile j runs on the CUDA cores; O is
// rescaled once P V is in.  A stage is released one tile late, hence
// three stages so that one load is always in flight.  The masks are
// applied only on tiles that straddle the diagonal or the window edge.
// Blocks are numbered so that the q tiles with the most keys (the last
// ones, when causal) start first.
//
// The f32 route stays on exact float32 arithmetic in flash_attention.cu:
// TF32 or bf16 tensor-core products would not meet the 2e-5 (tests) and
// 1e-3 (full-depth model) tolerances that float32 inputs are held to.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;            // q rows per warpgroup, keys per tile
constexpr int kStages = 3;           // k/v tiles in flight
constexpr int kConsumers = 2;        // consumer warpgroups per block
constexpr int kThreads = 128 * kConsumers + 32;   // + one producer warp
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// A [64, HD] bf16 tile in shared memory as TMA writes it: HD cut into
// panels of at most 64 columns, each panel 64 rows of kRowBytes, swizzled
// by the widest pattern the row allows.
template <int HD>
struct Tile {
  static constexpr int kPanel = HD < 64 ? HD : 64;     // columns per panel
  static constexpr int kRowBytes = 2 * kPanel;          // 32, 64 or 128
  static constexpr int kPanelBytes = kTile * kRowBytes;
  static constexpr int kBytes = kTile * HD * 2;
  // wgmma descriptor layout: 1 = 128 B, 2 = 64 B, 3 = 32 B swizzle
  static constexpr uint64_t kLayout =
      kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: one box of the 3-d tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// keep the compiler from moving accesses of wgmma registers across the
// fence / wait instructions, which do not name them
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S[64 x 64] (+)= A[64 x 16] B[16 x 64]: A (q rows) and B (keys) both
// K-major in shared memory.

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O[64 x HD] += P[64 x 16] V[16 x HD]: P in registers, V MN-major in
// shared memory (the transpose bit).  One overload per head dim.

__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// issue S = Q Kᵀ over hd in steps of 16 (32 bytes along a swizzled row)
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[32], uint32_t q_tile,
                                         uint32_t k_tile) {
  using T = Tile<HD>;
  pin(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk * 16 / T::kPanel) * T::kPanelBytes +
                         (kk * 16 % T::kPanel) * 2;
    wgmma_ss(sc, desc(q_tile + off, 16, 8 * T::kRowBytes, T::kLayout),
             desc(k_tile + off, 16, 8 * T::kRowBytes, T::kLayout), kk > 0);
  }
  wgmma_commit();
}

// issue O += P V over the tile's keys in steps of 16
template <int HD>
__device__ __forceinline__ void issue_pv(float (&acc)[HD / 2],
                                         uint32_t (&pa)[4][4],
                                         uint32_t v_tile) {
  using T = Tile<HD>;
  pin(acc);
  pin(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(acc, pa[kk],
             desc(v_tile + kk * 16 * T::kRowBytes, T::kPanelBytes,
                  8 * T::kRowBytes, T::kLayout),
             1);
  wgmma_commit();
}

// the online softmax of one tile in the log2 domain: scores in, P (f32)
// out; m and the per-thread partial l updated, alpha the rescale of O
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int q_row, int k0, int c0,
                                             int causal, int window,
                                             float sl2, int q_first) {
  const bool edge = (causal && k0 + kTile - 1 > q_first) ||
                    (window > 0 && q_first + kTile - 1 - k0 >= window);
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e] * sl2;
      if (edge) {
        const int qp = q_row + 8 * (e / 2);
        const int kp = k0 + 8 * j + c0 + (e & 1);
        if ((causal && kp > qp) || (window > 0 && qp - kp >= window))
          x = kNegInf;
      }
      sc[4 * j + e] = x;
      mx[e / 2] = fmaxf(mx[e / 2], x);
    }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
    const float m_new = fmaxf(m[hf], mx[hf]);
    alpha[hf] = exp2f(m[hf] - m_new);
    m[hf] = m_new;
    l[hf] *= alpha[hf];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(sc[4 * j + e] - m[e / 2]);
      sc[4 * j + e] = p;
      l[e / 2] += p;
    }
}

// P as the bf16 A operand of P V: keys 16 kk .. 16 kk + 15 are
// sc[8 kk .. 8 kk + 7] (the S accumulator layout is the A layout)
__device__ __forceinline__ void to_bf16(const float (&sc)[32],
                                        uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

// The work of consumer warpgroup w of a block: batch, q head, q tile, and
// whether it exists (an odd tile count leaves the last block one tile).
struct Slot {
  int b, head, qt;
  bool valid;
};

__device__ __forceinline__ Slot slot_of(int blk, int w, int bsz, int h,
                                        int kvh, int n_qt) {
  Slot s;
  if (((h / kvh) & 1) == 0) {  // two q heads of one kv head, one q tile
    const int per = bsz * (h / 2);
    const int rest = blk % per;
    s.qt = n_qt - 1 - blk / per;
    s.b = rest / (h / 2);
    s.head = 2 * (rest % (h / 2)) + w;
    s.valid = true;
  } else {                     // one q head, two consecutive q tiles
    const int per = bsz * h;
    const int rest = blk % per;
    s.qt = 2 * ((n_qt + 1) / 2 - 1 - blk / per) + w;
    s.b = rest / h;
    s.head = rest % h;
    s.valid = s.qt < n_qt;
  }
  return s;
}

// the k tiles [lo, hi) that a row of q tile qt can see (the Pallas lo / hi)
__device__ __forceinline__ void k_range(int qt, int n_k, int causal,
                                        int window, int& lo, int& hi) {
  hi = causal ? min(qt + 1, n_k) : n_k;
  lo = window > 0 ? max((qt * kTile - window) / kTile, 0) : 0;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ o, int bsz, int tq, int tk,
                      int h, int kvh, int causal, int window,
                      float sm_scale) {
  using T = Tile<HD>;
  extern __shared__ uint8_t smem_raw[];
  // tiles start on 1024 bytes, the period of the 128 B swizzle
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + kConsumers * T::kBytes;   // [kStages] tiles
  const uint32_t v_s = k_s + kStages * T::kBytes;      // [kStages] tiles
  const uint32_t full = v_s + kStages * T::kBytes;     // [kStages] mbarriers
  const uint32_t empty = full + 8 * kStages;           // [kStages] mbarriers
  const uint32_t q_bar = empty + 8 * kStages;

  const int n_qt = tq / kTile, n_k = tk / kTile;
  const Slot s0 = slot_of(blockIdx.x, 0, bsz, h, kvh, n_qt);
  const Slot s1 = slot_of(blockIdx.x, 1, bsz, h, kvh, n_qt);
  int lo0, hi0, lo1, hi1;
  k_range(s0.qt, n_k, causal, window, lo0, hi0);
  k_range(s1.qt, n_k, causal, window, lo1, hi1);
  // the block loads the union of its warpgroups' k tiles
  const int lo = s1.valid ? min(lo0, lo1) : lo0;
  const int hi = s1.valid ? max(hi0, hi1) : hi0;
  const int n_iter = max(hi - lo, 0);
  const int kh = s0.head / (h / kvh);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * kConsumers);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp == 4 * kConsumers) {  // the producer warp: one thread issues TMA
    if (threadIdx.x % 32 == 0) {
      mbar_expect_tx(q_bar, (s1.valid ? 2 : 1) * T::kBytes);
#pragma unroll
      for (int w = 0; w < kConsumers; ++w) {
        const Slot& sl = w == 0 ? s0 : s1;
        if (!sl.valid) continue;
        for (int p = 0; p < HD / T::kPanel; ++p)
          tma_load(q_s + w * T::kBytes + p * T::kPanelBytes, &tm_q, q_bar,
                   p * T::kPanel, sl.head, sl.b * tq + sl.qt * kTile);
      }
      for (int i = 0; i < n_iter; ++i) {
        const int s = i % kStages;
        // a stage is refilled once both warpgroups have released it
        if (i >= kStages) mbar_wait(empty + 8 * s, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * T::kBytes);
        const int row = s0.b * tk + (lo + i) * kTile;
        for (int p = 0; p < HD / T::kPanel; ++p) {
          tma_load(k_s + s * T::kBytes + p * T::kPanelBytes, &tm_k,
                   full + 8 * s, p * T::kPanel, kh, row);
          tma_load(v_s + s * T::kBytes + p * T::kPanelBytes, &tm_v,
                   full + 8 * s, p * T::kPanel, kh, row);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows r0 and r0 + 8 of its tile, column pairs
  // c0 + 8 j of every accumulator (the wgmma m64nN f32 layout)
  const int wg = warp / 4;
  const Slot me = wg == 0 ? s0 : s1;
  const int my_lo = wg == 0 ? lo0 : lo1, my_hi = wg == 0 ? hi0 : hi1;
  const int lane = threadIdx.x % 32;
  const int r0 = 16 * (warp % 4) + lane / 4;
  const int c0 = 2 * (lane % 4);
  const int q_first = me.qt * kTile;
  const float sl2 = sm_scale * kLog2e;
  const uint32_t q_tile = q_s + wg * T::kBytes;

  float acc[HD / 2], sc[32];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t pa[4][4];

  // this warpgroup's tiles are [i0, i1) of the block's; it waits for and
  // releases the others too, so that every stage sees 256 arrivals
  const int i0 = me.valid ? max(my_lo - lo, 0) : n_iter;
  const int i1 = me.valid ? max(min(my_hi - lo, n_iter), i0) : n_iter;
  for (int i = 0; i < i0; ++i) {
    mbar_wait(full + 8 * (i % kStages), (i / kStages) & 1);
    mbar_arrive(empty + 8 * (i % kStages));
  }
  mbar_wait(q_bar, 0);
  if (i1 > i0) {
    // tile i0: S, softmax, P
    mbar_wait(full + 8 * (i0 % kStages), (i0 / kStages) & 1);
    __syncwarp();
    issue_qk<HD>(sc, q_tile, k_s + (i0 % kStages) * T::kBytes);
    wgmma_wait<0>();
    pin(sc);
    softmax_tile(sc, m, l, alpha, me.qt * kTile + r0, (lo + i0) * kTile, c0,
                 causal, window, sl2, q_first);
    to_bf16(sc, pa);
    for (int i = i0 + 1; i < i1; ++i) {
      const int s = i % kStages, sp = (i - 1) % kStages;
      mbar_wait(full + 8 * s, (i / kStages) & 1);
      __syncwarp();
      // S of tile i runs beside P V of tile i - 1 and the softmax of i
      issue_qk<HD>(sc, q_tile, k_s + s * T::kBytes);
      issue_pv<HD>(acc, pa, v_s + sp * T::kBytes);
      wgmma_wait<1>();
      pin(sc);
      softmax_tile(sc, m, l, alpha, me.qt * kTile + r0, (lo + i) * kTile, c0,
                   causal, window, sl2, q_first);
      wgmma_wait<0>();
      pin(acc);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * j + e] *= alpha[e / 2];
      to_bf16(sc, pa);
      mbar_arrive(empty + 8 * sp);
    }
    issue_pv<HD>(acc, pa, v_s + ((i1 - 1) % kStages) * T::kBytes);
    wgmma_wait<0>();
    pin(acc);
    mbar_arrive(empty + 8 * ((i1 - 1) % kStages));
  }
  for (int i = i1; i < n_iter; ++i) {
    mbar_wait(full + 8 * (i % kStages), (i / kStages) & 1);
    mbar_arrive(empty + 8 * (i % kStages));
  }

  if (!me.valid) return;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    const float den = fmaxf(l[hf], 1e-30f);
    const long long row = (long long)me.b * tq + q_first + r0 + 8 * hf;
    __nv_bfloat16* out = o + (row * h + me.head) * HD + c0;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * hf] / den, acc[4 * j + 2 * hf + 1] / den);
  }
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime so
// that the library needs no link against libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// a [rows, heads, HD] bf16 tensor, read in boxes of 64 rows x 1 head x one
// panel, written to shared memory with the panel's swizzle
template <int HD>
bool make_map(CUtensorMap* map, const void* ptr, int heads, long long rows) {
  using T = Tile<HD>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)HD, (cuuint64_t)heads,
                              (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)HD * 2,
                                 (cuuint64_t)heads * HD * 2};
  const cuuint32_t box[3] = {(cuuint32_t)T::kPanel, 1, (cuuint32_t)kTile};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      T::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : T::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int tq, int tk, int h, int kvh, int causal, int window,
           cudaStream_t stream) {
  using T = Tile<HD>;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map<HD>(&tm_q, q, h, (long long)b * tq) ||
      !make_map<HD>(&tm_k, k, kvh, (long long)b * tk) ||
      !make_map<HD>(&tm_v, v, kvh, (long long)b * tk))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      1024 + (size_t)(kConsumers + 2 * kStages) * T::kBytes + 16 * kStages + 8;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = tq / kTile;
  const int blocks = (h / kvh) % 2 == 0 ? b * (h / 2) * n_qt
                                        : b * h * ((n_qt + 1) / 2);
  const float sm_scale = (float)(1.0 / sqrt((double)HD));
  flash_fwd_bf16_kernel<HD><<<blocks, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, (__nv_bfloat16*)o, b, tq, tk, h, kvh, causal, window,
      sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  window 0 = no window.  Launches on
// `stream` and returns cudaGetLastError() (0 = launched); the caller checks
// shapes, the dtype (bf16), contiguity, 16-byte alignment and that Tq and
// Tk are multiples of 64.
extern "C" int flash_attention_bf16_launch(const void* q, const void* k,
                                           const void* v, void* o, int b,
                                           int tq, int tk, int h, int kvh,
                                           int hd, int causal, int window,
                                           void* stream) {
  if (b == 0 || tq == 0 || h == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 16: return launch<16>(q, k, v, o, b, tq, tk, h, kvh, causal, window, s);
    case 32: return launch<32>(q, k, v, o, b, tq, tk, h, kvh, causal, window, s);
    case 64: return launch<64>(q, k, v, o, b, tq, tk, h, kvh, causal, window, s);
    case 128: return launch<128>(q, k, v, o, b, tq, tk, h, kvh, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
