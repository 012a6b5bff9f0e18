// The decode-step feed-forward block in one pass over the weights:
//
//   out = relu(x @ w1 * s1 + b1) @ w2 * s2 + b2
//
// Replaces: voicecraft_tpu/ops/fused_decode.py fused_ffn (Pallas body
// _ffn_kernel).  Numerics follow that kernel: f32 accumulation, scale and
// bias applied in f32, the hidden activation cast to x's dtype before the
// second product, and the per-output-channel scales s1/s2 of fp8 e4m3
// weights (absent -> 1).
//
// What bounds it on the H100: x is a handful of decode rows, so each weight
// byte is used B times; at B <= 8 the block is a pair of GEMVs bound by the
// bytes of w1 and w2 (2*D*F elements; 64 MB in bf16 at giga830M), far below
// the card's flop/byte balance point.  The design keeps the hidden tile out
// of device memory, streams each weight exactly once with 16-byte loads, and
// spreads F over enough blocks (64 hidden columns each) to keep ~all SMs
// loading.
//
// Design: pass 1, one block per 64-column tile of F: x is staged in shared
// memory as f32; 8 threads cover a tile row of w1 with 8 consecutive
// columns each and 32 such row groups split D, reduced in a fixed order
// through shared memory into the hidden tile; relu, then the tile times
// w2[tile, :] into an f32 partial [n_tiles, B, D].  Pass 2 sums the partials
// over the tiles in tile order and applies s2 and b2: deterministic, no
// atomics.  Any F and D are taken; ragged tiles are masked.
#include "common.cuh"

namespace vc {

constexpr int FFN_THREADS = 256;
constexpr int FFN_TILE_F = 64;                              // hidden columns per block
constexpr int FFN_MAX_ROWS = 8;                             // decode rows per call
constexpr int FFN_COLS = 8;                                 // consecutive columns per thread
constexpr int FFN_COL_GROUPS = FFN_TILE_F / FFN_COLS;       // threads per w1 tile row
constexpr int FFN_ROW_GROUPS = FFN_THREADS / FFN_COL_GROUPS;  // w1 rows per pass

// shared memory (floats): xs [B*D] | red [ROW_GROUPS*B*TILE_F] | hs [B*TILE_F]
static size_t ffn_smem_bytes(int B, int D) {
  return sizeof(float) * (static_cast<size_t>(B) * D +
                          static_cast<size_t>(FFN_ROW_GROUPS) * B * FFN_TILE_F +
                          static_cast<size_t>(B) * FFN_TILE_F);
}

template <typename T, typename W>
__global__ void __launch_bounds__(FFN_THREADS)
ffn_tile_kernel(const T* __restrict__ x, const W* __restrict__ w1,
                const float* __restrict__ s1, const T* __restrict__ b1,
                const W* __restrict__ w2, float* __restrict__ partial, int B,
                int D, int F, bool vec1, bool vec2) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* red = xs + B * D;
  float* hs = red + FFN_ROW_GROUPS * B * FFN_TILE_F;

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int f0 = tile * FFN_TILE_F;
  const int tf = min(FFN_TILE_F, F - f0);  // valid hidden columns of this tile

  for (int i = tid; i < B * D; i += FFN_THREADS) xs[i] = to_float(x[i]);
  __syncthreads();

  // ---- h[b, f0 + c] = sum_d x[b, d] * w1[d, f0 + c] ----
  const int cg = tid % FFN_COL_GROUPS;
  const int rg = tid / FFN_COL_GROUPS;
  const int c0 = cg * FFN_COLS;
  const int nc = max(0, min(FFN_COLS, tf - c0));
  float acc[FFN_MAX_ROWS][FFN_COLS];
#pragma unroll
  for (int b = 0; b < FFN_MAX_ROWS; ++b)
#pragma unroll
    for (int c = 0; c < FFN_COLS; ++c) acc[b][c] = 0.f;

#pragma unroll 4
  for (int d = rg; d < D; d += FFN_ROW_GROUPS) {
    float w[FFN_COLS];
    load8_masked(w1 + static_cast<size_t>(d) * F + f0 + c0, nc, vec1, w);
#pragma unroll
    for (int b = 0; b < FFN_MAX_ROWS; ++b) {
      if (b < B) {
        const float xv = xs[b * D + d];
#pragma unroll
        for (int c = 0; c < FFN_COLS; ++c) acc[b][c] = fmaf(xv, w[c], acc[b][c]);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < FFN_MAX_ROWS; ++b) {
    if (b < B) {
#pragma unroll
      for (int c = 0; c < FFN_COLS; ++c)
        red[(rg * B + b) * FFN_TILE_F + c0 + c] = acc[b][c];
    }
  }
  __syncthreads();

  for (int i = tid; i < B * FFN_TILE_F; i += FFN_THREADS) {
    const int b = i / FFN_TILE_F, c = i % FFN_TILE_F;
    float h = 0.f;
    if (c < tf) {
      for (int g = 0; g < FFN_ROW_GROUPS; ++g) h += red[(g * B + b) * FFN_TILE_F + c];
      const int f = f0 + c;
      h = h * (s1 != nullptr ? s1[f] : 1.f) + to_float(b1[f]);
      h = fmaxf(h, 0.f);
      h = to_float(from_float<T>(h));  // cast to x's dtype before the 2nd dot
    }
    hs[b * FFN_TILE_F + c] = h;
  }
  __syncthreads();

  // ---- partial[tile, b, :] = h[b, tile] @ w2[tile, :] ----
  const int n_groups = (D + FFN_COLS - 1) / FFN_COLS;
  for (int g = tid; g < n_groups; g += FFN_THREADS) {
    const int col = g * FFN_COLS;
    const int ncol = min(FFN_COLS, D - col);
#pragma unroll
    for (int b = 0; b < FFN_MAX_ROWS; ++b)
#pragma unroll
      for (int c = 0; c < FFN_COLS; ++c) acc[b][c] = 0.f;
#pragma unroll 4
    for (int f = 0; f < tf; ++f) {
      float w[FFN_COLS];
      load8_masked(w2 + static_cast<size_t>(f0 + f) * D + col, ncol, vec2, w);
#pragma unroll
      for (int b = 0; b < FFN_MAX_ROWS; ++b) {
        if (b < B) {
          const float hv = hs[b * FFN_TILE_F + f];
#pragma unroll
          for (int c = 0; c < FFN_COLS; ++c) acc[b][c] = fmaf(hv, w[c], acc[b][c]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < FFN_MAX_ROWS; ++b) {
      if (b < B) {
        float* dst = partial + (static_cast<size_t>(tile) * B + b) * D + col;
#pragma unroll
        for (int c = 0; c < FFN_COLS; ++c)
          if (c < ncol) dst[c] = acc[b][c];
      }
    }
  }
}

template <typename T>
__global__ void ffn_reduce_kernel(const float* __restrict__ partial,
                                  const float* __restrict__ s2,
                                  const T* __restrict__ b2, T* __restrict__ out,
                                  int n_tiles, int B, int D) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * D) return;
  const int c = i % D;
  float acc = 0.f;
  for (int t = 0; t < n_tiles; ++t)  // fixed order: deterministic
    acc += partial[static_cast<size_t>(t) * B * D + i];
  out[i] = from_float<T>(acc * (s2 != nullptr ? s2[c] : 1.f) + to_float(b2[c]));
}

template <typename T, typename W>
static cudaError_t launch_ffn(const void* x, const void* w1, const float* s1,
                              const void* b1, const void* w2, const float* s2,
                              const void* b2, float* partial, void* out, int B,
                              int D, int F, cudaStream_t st) {
  const int n_tiles = (F + FFN_TILE_F - 1) / FFN_TILE_F;
  const size_t smem = ffn_smem_bytes(B, D);
  cudaError_t e = cudaFuncSetAttribute(ffn_tile_kernel<T, W>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  ffn_tile_kernel<T, W><<<n_tiles, FFN_THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(w1), s1,
      static_cast<const T*>(b1), static_cast<const W*>(w2), partial, B, D, F,
      F % FFN_COLS == 0, D % FFN_COLS == 0);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int n = B * D;
  ffn_reduce_kernel<T><<<(n + 255) / 256, 256, 0, st>>>(
      partial, s2, static_cast<const T*>(b2), static_cast<T*>(out), n_tiles, B, D);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch_w(int w_dtype, const void* x, const void* w1,
                              const float* s1, const void* b1, const void* w2,
                              const float* s2, const void* b2, float* partial,
                              void* out, int B, int D, int F, cudaStream_t st) {
  switch (w_dtype) {
    case kF32:
      return launch_ffn<T, float>(x, w1, s1, b1, w2, s2, b2, partial, out, B, D, F, st);
    case kBF16:
      return launch_ffn<T, __nv_bfloat16>(x, w1, s1, b1, w2, s2, b2, partial, out, B, D, F, st);
    case kFP8E4M3:
      return launch_ffn<T, __nv_fp8_e4m3>(x, w1, s1, b1, w2, s2, b2, partial, out, B, D, F, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace vc

extern "C" {

// x/out: [B, D] (x_dtype f32|bf16); w1: [D, F], w2: [F, D] (w_dtype
// f32|bf16|fp8 e4m3, row-major); s1: [F], s2: [D] f32 or null; b1: [F],
// b2: [D] in x_dtype; partial: f32 scratch [ceil(F/tile_f), B, D].
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int vc_fused_ffn(const void* x, const void* w1, const void* s1, const void* b1,
                 const void* w2, const void* s2, const void* b2, void* partial,
                 void* out, int B, int D, int F, int tile_f, int x_dtype,
                 int w_dtype, void* stream) {
  if (tile_f != vc::FFN_TILE_F || B < 1 || B > vc::FFN_MAX_ROWS || D < 1 || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* s1f = static_cast<const float*>(s1);
  const float* s2f = static_cast<const float*>(s2);
  float* part = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (x_dtype) {
    case vc::kF32:
      e = vc::dispatch_w<float>(w_dtype, x, w1, s1f, b1, w2, s2f, b2, part, out, B, D, F, st);
      break;
    case vc::kBF16:
      e = vc::dispatch_w<__nv_bfloat16>(w_dtype, x, w1, s1f, b1, w2, s2f, b2, part, out, B, D, F, st);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // extern "C"
