// Forward prefix attention for the prefill of the [text ; audio] sequence,
// bf16 on the tensor cores of a Hopper card (sm_90a: wgmma, TMA, mbarriers).
//
// Replaces: voicecraft_tpu/ops/flash_attention.py flash_prefix_attention
// (Pallas body _flash_kernel) for bf16 inputs; f32 inputs keep the simple
// kernel of flash_prefix_attention.cu.  Semantics as there: causal over the
// joint sequence, keys valid in [0, x_len) u [x_pad, x_pad + y_len), masked
// logits -1e9, keys past S -inf, m/l/O in f32, output O / max(l, 1e-20)
// rounded once to bf16, rows past S never written.  Numerics are those of
// the JAX package's dense mha: f32 logits and softmax, probs rounded to bf16,
// f32 accumulation.
//
// What bounds it on the H100: one call at S ~ 1.1k, D = 2048 (16 heads of
// 128) is ~2*S^2*D ~ 5 GFLOP (the causal half of both products) against
// ~18 MB of q/k/v/out, so it is bound by the tensor cores and by issuing
// the softmax instructions between the two products, not by memory.  The
// simple kernel did every product as an f32 FMA on the CUDA cores (under 1%
// of the card's bf16 rate).
//
// Design:
//  - One block per (128-row q tile, head, batch row), three warpgroups: two
//    consumers of 64 q rows each and one producer.  setmaxnreg moves
//    registers from the producer (24) to the consumers (240).
//  - One producer thread loads the q tile once, then K and V tiles of 128
//    keys into a ring of 2 stages, with TMA: 3-D maps {D, S, B}, so the
//    hardware zero-fills rows past S and never reads across batch rows.
//    Each stage has full mbarriers (K and V apart, so S = QK^T can start
//    before V lands) and an empty mbarrier the 8 consumer warps arrive on.
//  - S = Q K^T is wgmma m64n128k16 with both operands in shared memory (K is
//    [keys, Dh], Dh-contiguous: K-major for B, no transpose).  The online
//    softmax runs on the accumulator registers, the scale folded with
//    log2(e) into exp2f; P is rounded to bf16 in registers and O += P V is
//    wgmma with A from registers and the V tile [keys, Dh] as an MN-major
//    (transposed) B.
//  - Tiles are Dh columns wide, as boxes of 64 columns under the 128-byte
//    swizzle (Dh 128 takes two boxes); Dh 32 / 16 take the 64 / 32-byte
//    swizzle.  The wgmma descriptors use the same mode.
//  - Key tiles past the causal edge are never loaded.  Tiles wholly in the
//    text padding [x_len, x_pad), or at or past x_pad + y_len, are skipped:
//    their logits are -1e9, whose exp is 0 against any row with a valid key
//    (rows without one are padding).  Only tiles that cross the diagonal or
//    an edge (x_len, x_pad, x_pad + y_len, S) compute the mask.
//  - The q tile is the grid's slowest index, in reverse, so the longest
//    blocks start first and the short ones fill the tail of the last wave.
#include "sm90.cuh"

namespace vc {
namespace sm90 {

constexpr int BQ = 128;                     // q rows per block
constexpr int BK = 128;                     // keys per K/V tile
constexpr int STAGES = 2;                   // K/V ring depth
constexpr int CONSUMER_WGS = BQ / 64;       // a consumer warpgroup per 64 rows
constexpr int CONSUMER_WARPS = 4 * CONSUMER_WGS;
constexpr int THREADS = 128 * (CONSUMER_WGS + 1);
// setmaxnreg: a block starts with the launch bound's registers a thread
// (65536 / 384 -> 168); the producer warpgroup drops to 24 and the consumers
// take what it frees
constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS =
    (THREADS * LAUNCH_REGS - 128 * PRODUCER_REGS) / (128 * CONSUMER_WGS) / 8 * 8;
constexpr float LOG2E = 1.4426950408889634f;

// shared-memory layout for one head dim: the q tile, then K[0..STAGES),
// then V[0..STAGES), each as NBOX boxes of [rows][BOX] bf16 (SW bytes a
// row, swizzled), then the mbarriers
template <int DH>
struct Layout {
  static constexpr int SW = DH * 2 < 128 ? DH * 2 : 128;  // swizzle bytes
  static constexpr int BOX = SW / 2;                       // columns a box
  static constexpr int NBOX = DH / BOX;
  static constexpr int Q_BYTES = BQ * DH * 2;
  static constexpr int KV_BYTES = BK * DH * 2;
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;  // + alignment
  static_assert(BYTES <= 227 * 1024, "shared memory of a block");
};

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle mode of SW bytes
template <int SW>
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  constexpr uint64_t mode = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | mode << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundary
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S[64 x 128] (+)= A[64 x 16] B[16 x 128]; A and B from shared memory, both
// K-major; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// O[64 x 16] += A[64 x 16] B[16 x 16]; A from registers (bf16 pairs), B
// from shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// O[64 x 32] += A[64 x 16] B[16 x 32]; A from registers (bf16 pairs), B
// from shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// O[64 x 64] += A[64 x 16] B[16 x 64]; A from registers (bf16 pairs), B
// from shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// O[64 x 128] += A[64 x 16] B[16 x 128]; A from registers (bf16 pairs), B
// from shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// a key tile with no valid key: wholly in the text padding or past the audio
__device__ __forceinline__ bool skip_tile(int k0, int x_len, int x_pad,
                                          int y_len) {
  return (k0 >= x_len && k0 + BK <= x_pad) || k0 >= x_pad + y_len;
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_prefix_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const int* __restrict__ x_lens,
                         const int* __restrict__ y_lens,
                         __nv_bfloat16* __restrict__ out, int S, int H,
                         int x_pad, float scale_log2) {
  using L = Layout<DH>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + STAGES;
  uint64_t* empty = bars + 1 + 2 * STAGES;
  auto k_tile = [&](int st) { return smem + L::Q_BYTES + st * L::KV_BYTES; };
  auto v_tile = [&](int st) {
    return smem + L::Q_BYTES + (STAGES + st) * L::KV_BYTES;
  };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int x_len = x_lens[b];
  const int y_len = y_lens[b];
  const int n_kt = (min(q0 + BQ, S) + BK - 1) / BK;  // causal edge

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&empty[st], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMER_WGS) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS)
                 : "memory");
    if (threadIdx.x % 128 == 0) {
      const int col = h * DH;
      mbar_expect_tx(q_full, L::Q_BYTES);
      for (int i = 0; i < L::NBOX; ++i)
        tma_load(smem + i * BQ * L::SW, &tm_q, q_full, col + i * L::BOX, q0, b);
      int n = 0;
      for (int kt = 0; kt < n_kt; ++kt) {
        if (skip_tile(kt * BK, x_len, x_pad, y_len)) continue;
        const int st = n % STAGES;
        mbar_wait(&empty[st], ((n / STAGES) & 1) ^ 1);
        mbar_expect_tx(&k_full[st], L::KV_BYTES);
        for (int i = 0; i < L::NBOX; ++i)
          tma_load(k_tile(st) + i * BK * L::SW, &tm_k, &k_full[st],
                   col + i * L::BOX, kt * BK, b);
        mbar_expect_tx(&v_full[st], L::KV_BYTES);
        for (int i = 0; i < L::NBOX; ++i)
          tma_load(v_tile(st) + i * BK * L::SW, &tm_v, &v_full[st],
                   col + i * L::BOX, kt * BK, b);
        ++n;
      }
    }
  } else {
    // ---- consumers: 64 q rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS)
                 : "memory");
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    // accumulator element 4*j + 2*i + c is row r0 + 8*i, column 8*j + c0 + c
    const int r0 = q0 + wg * 64 + (t / 32) * 16 + lane / 4;
    const int c0 = 2 * (lane % 4);
    const uint8_t* q_wg = smem + wg * 64 * L::SW;
    const float masked = kNegInf * LOG2E;

    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float o[DH / 2];
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;

    mbar_wait(q_full, 0);
    int n = 0;
    for (int kt = 0; kt < n_kt; ++kt) {
      const int k0 = kt * BK;
      if (skip_tile(k0, x_len, x_pad, y_len)) continue;
      const int st = n % STAGES;
      const uint32_t phase = (n / STAGES) & 1;

      // S = Q K^T
      mbar_wait(&k_full[st], phase);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int box = kk * 16 / L::BOX;
        const int off = (kk * 16 % L::BOX) * 2;
        wgmma_ss(s, desc<L::SW>(q_wg + box * BQ * L::SW + off, 16, 8 * L::SW),
                 desc<L::SW>(k_tile(st) + box * BK * L::SW + off, 16, 8 * L::SW),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // scale to log2 units; the mask only where the tile crosses an edge
      const bool unmasked =
          (k0 + BK <= x_len || (k0 >= x_pad && k0 + BK <= x_pad + y_len)) &&
          k0 + BK - 1 <= q0 && k0 + BK <= S;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * j + e] * scale_log2;
          if (!unmasked) {
            const int key = k0 + 8 * j + c0 + (e & 1);
            const int row = r0 + 8 * (e >> 1);
            const bool valid =
                key < x_len || (key >= x_pad && key < x_pad + y_len);
            if (key >= S)
              x = -INFINITY;
            else if (!valid || key > row)
              x = masked;
          }
          s[4 * j + e] = x;
        }
      }

      // online softmax; a row lives in the 4 lanes of a quad
      float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = m[i];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[i] = exp2f(m[i] - mx);
        m[i] = mx;
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[4 * j + e] - m[e >> 1]);
          s[4 * j + e] = p;
          rsum[e >> 1] += p;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rsum[i];
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
      }
      // P in bf16 as wgmma A fragments: keys 16*kk .. 16*kk + 15
      uint32_t p[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      }

      // O += P V
      mbar_wait(&v_full[st], phase);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(o, p[kk],
                 desc<L::SW>(v_tile(st) + kk * 16 * L::SW, BK * L::SW, 8 * L::SW));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      ++n;
    }

    const int D = H * DH;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int row = r0 + 8 * i;
      if (row >= S) continue;
      const float denom = fmaxf(l[i], 1e-20f);
      __nv_bfloat16* dst =
          out + (static_cast<size_t>(b) * S + row) * D + h * DH + c0;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
            o[4 * j + 2 * i] / denom, o[4 * j + 2 * i + 1] / denom);
    }
  }
}

// ---- host side ----------------------------------------------------------------

// [B, S, D] bf16 as {D, S, B} (innermost first); a box is BOX columns x 128
// rows x 1 batch row, zero-filled past S
template <int DH>
static bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int D) {
  using L = Layout<DH>;
  static_assert(BQ == BK, "one box shape serves q, k and v");
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(L::BOX), BK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = L::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : L::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          const int* x_lens, const int* y_lens, void* out,
                          int B, int S, int H, int x_pad, float scale,
                          cudaStream_t stream) {
  using L = Layout<DH>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_prefix_sm90_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::BYTES);
  if (attr != cudaSuccess) return attr;
  if (encode_tiled() == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap mq, mk, mv;
  const int D = H * DH;
  if (!make_map<DH>(&mq, q, B, S, D) || !make_map<DH>(&mk, k, B, S, D) ||
      !make_map<DH>(&mv, v, B, S, D))
    return cudaErrorInvalidValue;
  const dim3 grid(H, B, (S + BQ - 1) / BQ);
  flash_prefix_sm90_kernel<DH><<<grid, THREADS, L::BYTES, stream>>>(
      mq, mk, mv, x_lens, y_lens, static_cast<__nv_bfloat16*>(out), S, H,
      x_pad, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace sm90

// the bf16 path of vc_flash_prefix_attention (flash_prefix_attention.cu)
cudaError_t flash_prefix_attention_sm90(const void* q, const void* k,
                                        const void* v, const int* x_lens,
                                        const int* y_lens, void* out, int B,
                                        int S, int H, int Dh, int x_pad,
                                        float scale, cudaStream_t st) {
  switch (Dh) {
    case 16: return sm90::launch<16>(q, k, v, x_lens, y_lens, out, B, S, H, x_pad, scale, st);
    case 32: return sm90::launch<32>(q, k, v, x_lens, y_lens, out, B, S, H, x_pad, scale, st);
    case 64: return sm90::launch<64>(q, k, v, x_lens, y_lens, out, B, S, H, x_pad, scale, st);
    case 128: return sm90::launch<128>(q, k, v, x_lens, y_lens, out, B, S, H, x_pad, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace vc
