// The decode-step feed-forward block for bf16 activations on a Hopper card
// (sm_90a: TMA, mbarriers, mma.sync), in one cooperative launch:
//
//   out = relu(x @ w1 * s1 + b1) @ w2 * s2 + b2
//
// Replaces: voicecraft_tpu/ops/fused_decode.py:58 fused_ffn (Pallas body
// _ffn_kernel) for bf16 x with bf16 or fp8-e4m3 weights; f32 x keeps the
// simple kernel of fused_ffn.cu.  Numerics are _ffn_kernel's: both products
// in f32, s1, b1 and relu in f32, the hidden vector rounded to bf16 before
// the second product, s2 and b2 in f32, one rounding of the output.
//
// What bounds it on the H100: x is B <= 8 decode rows, so each weight is
// used B times (4B flops against 2 or 1 bytes), far below the card's
// flop/byte balance.  The bound is the weight stream, 2*D*F elements: 67.1
// MB in bf16 or 33.6 MB in fp8 at giga830M (D 2048, F 8192), 0.020 / 0.010
// ms at 3.35 TB/s.  The design keeps that stream full from the first w1
// tile to the last w2 tile, on every SM at once:
//  - F is cut into 64-column tiles; the grid is up to 128 blocks, one an SM,
//    each owning a contiguous run of tiles (one at giga830M: w1[:, f0:f0+64]
//    and w2[f0:f0+64, :], 512 KB of bf16).
//  - One producer thread streams a block's tiles through a ring of 16 KB
//    stages (as many as shared memory holds: 11 at B = 8, 13 at B = 1)
//    with 2-D TMA loads of 64 x 64 boxes and mbarrier completion; the w2
//    boxes follow the w1 boxes through the same ring, so w2 arrives while
//    the hidden tile is being finished.  Up to 208 KB of loads are in
//    flight on every SM.
//  - Eight (bf16) or sixteen (fp8) consumer warps run both products on the
//    tensor cores as mma.sync m16n8k16 with the operands swapped: a weight
//    tile, transposed, is the 16-row A operand and the 8 rows of x (or of
//    the hidden tile) the n = 8 B operand, accumulating in f32.  A is built
//    from 32-bit (bf16) or 16-bit (fp8) shared-memory loads and byte
//    permutes, not ldmatrix: a thread's two A rows are two adjacent weight
//    columns, which makes the same code serve both weight types.  fp8
//    weights are widened to bf16 in registers (exact: every e4m3 value is a
//    bf16 value).  The loops over a stage are unrolled and alternate two
//    accumulators, so loads, widening and mma of several steps overlap.
//  - The hidden tile never leaves the SM: the k-group sums of x @ w1 meet
//    in shared memory, are scaled, biased, relu'd and rounded to bf16, and
//    feed the second product from registers.
//  - Each block writes its [B, D] f32 partial of out to device memory (1 MB
//    at B = 1, mostly held in L2), meets the others at a grid barrier, then
//    sums D/n_blocks columns of every partial in a fixed order, applies s2
//    and b2 and writes out: deterministic, and every SM shares the sum.
//    The barrier needs every block resident: the launch is cooperative, so
//    the CUDA driver refuses it otherwise, and the barrier's counter is
//    left at zero.  (Thread-block clusters of 8 reduced through distributed
//    shared memory were tried first: the H100 could not hold all 16 such
//    clusters at once, so the last ran as a second wave.)
//  - One launch, no host sync and no allocation: capturable in a CUDA graph.
#include "sm90.cuh"

namespace vc {
namespace ffn90 {

using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_addr;

constexpr int ROWS = 8;             // decode rows a call: the mma's n
constexpr int TILE_F = 64;          // hidden columns a tile
constexpr int BOX = 64;             // a TMA box is 64 x 64 elements
constexpr int MAX_BLOCKS = 128;      // a block an SM, all resident
constexpr int MAX_KGROUPS = 4;      // warps splitting x @ w1's k-steps
constexpr int STAGE_BYTES = 16384;
constexpr int MAX_STAGES = 14;
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr int X_STRIDE_PAD = 8;     // bf16 a row of x: no bank conflicts
constexpr int H_STRIDE = TILE_F + 8;

template <typename W>
struct WeightType;
// boxes of 128-byte (bf16) or 64-byte (fp8) rows under the swizzle of that
// width; fp8 has twice the weights a byte to widen and multiply, so twice
// the consumer warps to hide their latency (a stage has 8 / 16 m-tiles)
template <>
struct WeightType<__nv_bfloat16> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr CUtensorMapSwizzle kSwizzle = CU_TENSOR_MAP_SWIZZLE_128B;
  static constexpr int kConsumerWarps = 8;
};
template <>
struct WeightType<__nv_fp8_e4m3> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr CUtensorMapSwizzle kSwizzle = CU_TENSOR_MAP_SWIZZLE_64B;
  static constexpr int kConsumerWarps = 16;
};

// a block's threads: the consumer warps and one producer warp
template <typename W>
__host__ __device__ constexpr int threads() {
  return 32 * (WeightType<W>::kConsumerWarps + 1);
}

// shared memory besides the ring: x, the k-group sums of the hidden tile,
// the hidden tile in bf16, the mbarriers
static size_t fixed_smem_bytes(int B, int D) {
  return 1024 /* ring alignment */ +
         sizeof(__nv_bfloat16) * B * static_cast<size_t>(D + X_STRIDE_PAD) +
         sizeof(float) * MAX_KGROUPS * ROWS * TILE_F +
         sizeof(__nv_bfloat16) * ROWS * H_STRIDE +
         sizeof(uint64_t) * 2 * MAX_STAGES;
}

// a box load that leaves L2 to the partials: the weights are read once
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "l"(policy)
      : "memory");
}

// d[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two e4m3 values (low byte first) as two bf16, exactly
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t v) {
  const __half2 h(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(v & 0xffffu), __NV_E4M3));
  const float2 f = __half22float2(h);
  const __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// The A fragment of one m16n8k16 step comes from a 64 x 64 box of a
// row-major weight matrix (rows = the contraction k, columns = the output
// m), k rows kr..kr+15, output columns mc..mc+15.  A thread (g = lane / 4,
// t = lane % 4) takes the fragment's rows g and g + 8 from columns mc + 2g
// and mc + 2g + 1, and its k pairs {2t, 2t+1} and {2t+8, 2t+9} from four box
// rows; the accumulator's rows g / g + 8 are then output columns mc + 2g /
// mc + 2g + 1.  load_raw reads the four rows' two columns (free of bank
// conflicts under the TMA swizzle), make_a builds the fragment from them.
__device__ __forceinline__ void load_raw(const uint8_t* box, int kr, int mc,
                                         int g, int t, uint32_t (&w)[4],
                                         __nv_bfloat16) {
  const int cb = (mc + 2 * g) * 2;  // byte in the 128-byte row
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = kr + 2 * t + (i & 1) + 8 * (i >> 1);
    const int off = r * 128 + ((((cb >> 4) ^ (r & 7)) << 4) | (cb & 15));
    w[i] = *reinterpret_cast<const uint32_t*>(box + off);
  }
}

__device__ __forceinline__ void load_raw(const uint8_t* box, int kr, int mc,
                                         int g, int t, uint32_t (&w)[4],
                                         __nv_fp8_e4m3) {
  const int cb = mc + 2 * g;  // byte in the 64-byte row
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = kr + 2 * t + (i & 1) + 8 * (i >> 1);
    const int off = r * 64 + ((((cb >> 4) ^ ((r >> 1) & 3)) << 4) | (cb & 15));
    w[i] = *reinterpret_cast<const uint16_t*>(box + off);
  }
}

__device__ __forceinline__ void make_a(const uint32_t (&w)[4], uint32_t (&a)[4],
                                       __nv_bfloat16) {
  a[0] = __byte_perm(w[0], w[1], 0x5410);
  a[1] = __byte_perm(w[0], w[1], 0x7632);
  a[2] = __byte_perm(w[2], w[3], 0x5410);
  a[3] = __byte_perm(w[2], w[3], 0x7632);
}

__device__ __forceinline__ void make_a(const uint32_t (&w)[4], uint32_t (&a)[4],
                                       __nv_fp8_e4m3) {
  // bytes {k, k+1} of column c, then of column c + 1
  const uint32_t lo = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t hi = __byte_perm(w[2], w[3], 0x5140);
  a[0] = e4m3x2_to_bf16x2(lo);
  a[1] = e4m3x2_to_bf16x2(lo >> 16);
  a[2] = e4m3x2_to_bf16x2(hi);
  a[3] = e4m3x2_to_bf16x2(hi >> 16);
}

template <int CW>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(32 * CW) : "memory");
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// the block's %globaltimer stamp k (ns) into trace[block][k], when traced
__device__ __forceinline__ void stamp(long long* trace, int k) {
  if (trace == nullptr) return;
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  trace[blockIdx.x * 4 + k] = t;
}

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// A grid barrier for the (cooperative, hence co-resident) grid.  The
// counter runs to 2n: every block arrives once and passes once it reads n
// or more (grid_wait, one thread between two __syncthreads), then adds its
// departure (grid_depart, after it passed); the last to depart resets the
// counter to 0, when every block has passed.
__device__ __forceinline__ void grid_wait(unsigned int* bar, unsigned int n) {
  __threadfence();
  atomicAdd(bar, 1u);
  const long long start = clock64();
  while (ld_acquire(bar) < n)
    if (clock64() - start > (1ll << 32)) __trap();
}

__device__ __forceinline__ void grid_depart(unsigned int* bar, unsigned int n) {
  if (atomicAdd(bar, 1u) == 2 * n - 1) atomicExch(bar, 0u);
}

template <typename W>
__global__ void __launch_bounds__(threads<W>(), 1)
ffn_sm90_kernel(const __grid_constant__ CUtensorMap tm_w1,
                const __grid_constant__ CUtensorMap tm_w2,
                const __nv_bfloat16* __restrict__ x,
                const float* __restrict__ s1,
                const __nv_bfloat16* __restrict__ b1,
                const float* __restrict__ s2,
                const __nv_bfloat16* __restrict__ b2,
                float* __restrict__ part, unsigned int* __restrict__ bar,
                __nv_bfloat16* __restrict__ out, int B, int D, int F,
                int stages, long long* __restrict__ trace) {
  if (threadIdx.x == 0) stamp(trace, 0);
  constexpr int BOX_BYTES = BOX * BOX * static_cast<int>(sizeof(W));
  constexpr int NB = STAGE_BYTES / BOX_BYTES;  // boxes a stage: 2 bf16, 4 fp8
  constexpr int KS = NB * (BOX / 16);          // 16-row steps a full stage
  constexpr int CW = WeightType<W>::kConsumerWarps;
  constexpr int KG = CW / 4;                   // k-groups of x @ w1
  constexpr int THREADS = threads<W>();
  static_assert(KG <= MAX_KGROUPS && KS % KG == 0 && KS % CW == 0, "split");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int xstride = D + X_STRIDE_PAD;
  __nv_bfloat16* xs =
      reinterpret_cast<__nv_bfloat16*>(ring + stages * STAGE_BYTES);
  float* red = reinterpret_cast<float*>(xs + B * xstride);  // [KG, ROWS, TILE_F]
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(
      red + MAX_KGROUPS * ROWS * TILE_F);  // [ROWS, H_STRIDE]
  uint64_t* full = reinterpret_cast<uint64_t*>(hs + ROWS * H_STRIDE);
  uint64_t* empty = full + MAX_STAGES;

  const int n_blocks = gridDim.x;
  const int n_tiles = F / TILE_F;
  const int t_begin = blockIdx.x * n_tiles / n_blocks;
  const int t_end = (blockIdx.x + 1) * n_tiles / n_blocks;
  const int n_stage = (D + NB * BOX - 1) / (NB * BOX);  // a matrix a tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* my_part = part + static_cast<size_t>(blockIdx.x) * B * D;  // [B, D]

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // x in bf16, 16 bytes at a time
  for (int i = threadIdx.x; i < B * D / 8; i += THREADS) {
    const int b = i / (D / 8), d = (i % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(xs + b * xstride + d) =
        *reinterpret_cast<const uint4*>(x + b * D + d);
  }
  if (t_begin == t_end)  // a block with no tile adds zeros
    for (int i = threadIdx.x; i < B * D; i += THREADS) my_part[i] = 0.f;
  __syncthreads();

  if (warp == CW) {
    // ---- producer: one thread streams w1 then w2 boxes of every tile ----
    if (lane == 0) {
      uint64_t evict_first;
      asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                   : "=l"(evict_first));
      int n = 0;
      for (int tile = t_begin; tile < t_end; ++tile) {
        const int f0 = tile * TILE_F;
        for (int mat = 0; mat < 2; ++mat) {
          for (int s = 0; s < n_stage; ++s, ++n) {
            const int st = n % stages;
            mbar_wait(&empty[st], ((n / stages) & 1) ^ 1);
            const int r0 = s * NB * BOX;
            const int nbox = min(NB, (D - r0) / BOX);
            mbar_expect_tx(&full[st], nbox * BOX_BYTES);
            for (int i = 0; i < nbox; ++i) {
              uint8_t* dst = ring + st * STAGE_BYTES + i * BOX_BYTES;
              if (mat == 0)  // w1[r0 + 64i : +64, f0 : f0 + 64]
                tma_load_2d(dst, &tm_w1, &full[st], f0, r0 + i * BOX, evict_first);
              else           // w2[f0 : f0 + 64, r0 + 64i : +64]
                tma_load_2d(dst, &tm_w2, &full[st], r0 + i * BOX, f0, evict_first);
            }
          }
        }
      }
    }
    __syncwarp();
  } else {
    // ---- consumers ----
    const int g = lane / 4, t = lane % 4;
    int n = 0;
    for (int tile = t_begin; tile < t_end; ++tile) {
      const int f0 = tile * TILE_F;
      // h^T[64, 8] = w1^T x^T: warp (mt, kg) takes hidden columns
      // 16mt..16mt+15 and every KG-th k-step, into two accumulators so that
      // consecutive mma do not wait on each other
      const int mt = warp % 4, kg = warp / 4;
      float acc[2][4] = {};
      for (int s = 0; s < n_stage; ++s, ++n) {
        const int st = n % stages;
        mbar_wait(&full[st], (n / stages) & 1);
        const int r0 = s * NB * BOX;
        const int nks = min(NB, (D - r0) / BOX) * (BOX / 16);
        const uint8_t* stage = ring + st * STAGE_BYTES;
        uint32_t w[KS / KG][4], xb[KS / KG][2];
#pragma unroll
        for (int u = 0; u < KS / KG; ++u) {
          const int ks = KG * u + kg;
          if (ks < nks) {
            load_raw(stage + (ks / 4) * BOX_BYTES, (ks % 4) * 16, mt * 16, g,
                     t, w[u], W());
            const __nv_bfloat16* xr = xs + g * xstride + r0 + ks * 16 + 2 * t;
            xb[u][0] = g < B ? ld_pair(xr) : 0u;  // x has B rows
            xb[u][1] = g < B ? ld_pair(xr + 8) : 0u;
          }
        }
#pragma unroll
        for (int u = 0; u < KS / KG; ++u) {
          if (KG * u + kg < nks) {
            uint32_t a[4];
            make_a(w[u], a, W());
            mma_bf16(acc[u & 1], a, xb[u]);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
      }
      // accumulator rows g / g + 8 = hidden columns 16mt + 2g / + 1, its
      // columns 2t / 2t + 1 = rows of x
      float* r = red + kg * ROWS * TILE_F + mt * 16 + 2 * g;
      r[2 * t * TILE_F] = acc[0][0] + acc[1][0];
      r[(2 * t + 1) * TILE_F] = acc[0][1] + acc[1][1];
      r[2 * t * TILE_F + 1] = acc[0][2] + acc[1][2];
      r[(2 * t + 1) * TILE_F + 1] = acc[0][3] + acc[1][3];
      consumer_sync<CW>();
      for (int i = threadIdx.x; i < ROWS * TILE_F; i += 32 * CW) {
        const int b = i / TILE_F, c = i % TILE_F;
        float h = 0.f;
        if (b < B) {
          for (int k = 0; k < KG; ++k) h += red[k * ROWS * TILE_F + i];
          h = h * (s1 != nullptr ? s1[f0 + c] : 1.f) + __bfloat162float(b1[f0 + c]);
          h = fmaxf(h, 0.f);
        }
        hs[b * H_STRIDE + c] = __float2bfloat16_rn(h);  // rounded before w2
      }
      consumer_sync<CW>();
      // the hidden tile as the B operand of the 4 k-steps of the second product
      uint32_t hb[4][2];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const __nv_bfloat16* hr = hs + g * H_STRIDE + kk * 16 + 2 * t;
        hb[kk][0] = ld_pair(hr);
        hb[kk][1] = ld_pair(hr + 8);
      }

      // out^T[n, 8] partial = w2^T h^T: 16-column m-tiles j of a stage,
      // warp w takes j = w, w + CW, ...
      const bool first = tile == t_begin;
      for (int s = 0; s < n_stage; ++s, ++n) {
        const int st = n % stages;
        mbar_wait(&full[st], (n / stages) & 1);
        const int n0 = s * NB * BOX;
        const int n_mt = min(NB, (D - n0) / BOX) * (BOX / 16);
        const uint8_t* stage = ring + st * STAGE_BYTES;
#pragma unroll
        for (int u = 0; u < KS / CW; ++u) {
          const int j = warp + u * CW;
          if (j < n_mt) {
            const uint8_t* box = stage + (j / 4) * BOX_BYTES;
            uint32_t w[4][4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              load_raw(box, kk * 16, (j % 4) * 16, g, t, w[kk], W());
            float c[2][4] = {};
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              uint32_t a[4];
              make_a(w[kk], a, W());
              mma_bf16(c[kk & 1], a, hb[kk]);
            }
            const int col = n0 + j * 16 + 2 * g;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int b = 2 * t + e;
              if (b < B) {
                float2* p = reinterpret_cast<float2*>(my_part + b * D + col);
                float2 v = make_float2(c[0][e] + c[1][e], c[0][2 + e] + c[1][2 + e]);
                if (!first) {
                  const float2 o = *p;
                  v.x += o.x;
                  v.y += o.y;
                }
                *p = v;
              }
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
      }
    }
  }

  // ---- every partial is written: block i sums out columns of slice i ----
  __syncthreads();
  if (threadIdx.x == 0) {
    stamp(trace, 1);
    grid_wait(bar, n_blocks);
    stamp(trace, 2);
  }
  __syncthreads();
  if (threadIdx.x == 32 * CW) grid_depart(bar, n_blocks);  // idle
  // slice i in 4-column groups; R lanes of a warp split the n_blocks
  // partials of a group (partials r, r + R, ...) and a shuffle tree adds
  // their sums: a fixed order
  const int Q = D / 4;
  const int q0 = blockIdx.x * Q / n_blocks;
  const int nq = (blockIdx.x + 1) * Q / n_blocks - q0;
  const int G = B * nq;
  constexpr int T = 32 * CW;
  int R = 1;
  while (2 * R * G <= T && 2 * R <= n_blocks && 2 * R <= 32) R *= 2;
  const float4* p4 = reinterpret_cast<const float4*>(part);
  for (int base = 0; base < G && threadIdx.x < T; base += T / R) {
    const int gi = base + threadIdx.x / R, r = threadIdx.x % R;
    const int b = gi / max(nq, 1), q = q0 + gi % max(nq, 1);
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (gi < G) {
#pragma unroll 16
      for (int k = r; k < n_blocks; k += R) {
        const float4 u = __ldcg(p4 + (static_cast<size_t>(k) * B + b) * Q + q);
        v[0] += u.x;
        v[1] += u.y;
        v[2] += u.z;
        v[3] += u.w;
      }
    }
    for (int o = R / 2; o > 0; o /= 2)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] += __shfl_xor_sync(0xffffffffu, v[e], o);
    if (gi < G && r == 0) {
      const int c = 4 * q;
      __nv_bfloat162 o2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float y[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int cc = c + 2 * e + h;
          y[h] = v[2 * e + h] * (s2 != nullptr ? s2[cc] : 1.f) +
                 __bfloat162float(b2[cc]);
        }
        o2[e] = __floats2bfloat162_rn(y[0], y[1]);
      }
      *reinterpret_cast<uint2*>(out + b * D + c) =
          *reinterpret_cast<const uint2*>(o2);
    }
  }
  if (trace != nullptr) {
    __syncthreads();
    if (threadIdx.x == 0) stamp(trace, 3);
  }
}

// [rows, cols] row-major as {cols, rows}, 64 x 64 boxes under the swizzle
template <typename W>
static bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(W)};
  const cuuint32_t box[2] = {BOX, BOX};
  const cuuint32_t elem[2] = {1, 1};
  return sm90::encode_tiled()(map, WeightType<W>::kMap, 2, const_cast<void*>(ptr),
                              dims, strides, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE,
                              WeightType<W>::kSwizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename W>
static cudaError_t launch(const void* x, const void* w1, const float* s1,
                          const void* b1, const void* w2, const float* s2,
                          const void* b2, float* part, unsigned int* bar,
                          void* out, int B, int D, int F, int n_blocks,
                          long long* trace, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ffn_sm90_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_LIMIT);
  if (attr != cudaSuccess) return attr;
  if (sm90::encode_tiled() == nullptr) return cudaErrorSymbolNotFound;
  const size_t fixed = fixed_smem_bytes(B, D);
  const int stages = min(MAX_STAGES, static_cast<int>((SMEM_LIMIT - fixed) / STAGE_BYTES));
  if (stages < 2) return cudaErrorInvalidValue;
  CUtensorMap m1, m2;
  if (!make_map<W>(&m1, w1, D, F) || !make_map<W>(&m2, w2, F, D))
    return cudaErrorInvalidValue;
  // cooperative: the CUDA driver refuses the launch unless every block can
  // be resident at once, which the grid barrier needs
  cudaLaunchAttribute coop;
  coop.id = cudaLaunchAttributeCooperative;
  coop.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_blocks);
  cfg.blockDim = dim3(threads<W>());
  cfg.dynamicSmemBytes = fixed + stages * STAGE_BYTES;
  cfg.stream = stream;
  cfg.attrs = &coop;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, ffn_sm90_kernel<W>, m1, m2, static_cast<const __nv_bfloat16*>(x),
      s1, static_cast<const __nv_bfloat16*>(b1), s2,
      static_cast<const __nv_bfloat16*>(b2), part, bar,
      static_cast<__nv_bfloat16*>(out), B, D, F, stages, trace);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace ffn90

// the bf16 path of vc_fused_ffn (fused_ffn.cu).  x/out: [B, D] bf16 with
// 1 <= B <= 8; w1: [D, F], w2: [F, D] bf16 or fp8 e4m3 (w_dtype); D and F
// multiples of 64, D <= 2048 (the widest preset); n_blocks up to 128 (blocks
// past the last 64-column tile add zeros); part: f32 scratch
// [n_blocks, B, D]; bar: one zeroed uint32, left zeroed (calls that share it
// must not overlap in time); trace: null, or int64 [n_blocks, 4] that gets
// each block's %globaltimer ns at its start, its main loop's end, the
// barrier's passing and its end.
cudaError_t fused_ffn_sm90(const void* x, const void* w1, const float* s1,
                          const void* b1, const void* w2, const float* s2,
                          const void* b2, float* part, unsigned int* bar,
                          void* out, int B, int D, int F, int n_blocks,
                          int w_dtype, long long* trace, cudaStream_t st) {
  using namespace ffn90;
  if (B < 1 || B > ROWS || D < BOX || D % BOX || D > 2048 || F < TILE_F ||
      F % TILE_F || n_blocks < 1 || n_blocks > MAX_BLOCKS)
    return cudaErrorInvalidValue;
  switch (w_dtype) {
    case kBF16:
      return launch<__nv_bfloat16>(x, w1, s1, b1, w2, s2, b2, part, bar, out,
                                   B, D, F, n_blocks, trace, st);
    case kFP8E4M3:
      return launch<__nv_fp8_e4m3>(x, w1, s1, b1, w2, s2, b2, part, bar, out,
                                   B, D, F, n_blocks, trace, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace vc
