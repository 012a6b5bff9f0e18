// The decode-step feed-forward block for f32 activations, the check kernel
// of the bf16 path (fused_ffn_sm90.cu), in one pass over the weights:
//
//   out = relu(x @ w1 * s1 + b1) @ w2 * s2 + b2
//
// Replaces: voicecraft_tpu/ops/fused_decode.py:58 fused_ffn (Pallas body
// _ffn_kernel) for f32 x with f32 or fp8 e4m3 weights.  Numerics follow that
// kernel: f32 accumulation, scale and bias applied in f32, and the
// per-output-channel scales s1/s2 of fp8 weights (absent -> 1).  The C entry
// point at the bottom routes bf16 x to fused_ffn_sm90.cu.
//
// What bounds it on the H100: the bytes of w1 and w2 (2*D*F elements).  This
// is PR 1's simple design, kept for the f32 checks: it streams each weight
// once with 16-byte loads, keeps the hidden tile out of device memory and
// spreads F over blocks of 64 hidden columns, but keeps few loads in flight
// and reduces over blocks in a second launch.
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

// fused_ffn_sm90.cu
cudaError_t fused_ffn_sm90(const void* x, const void* w1, const float* s1,
                          const void* b1, const void* w2, const float* s2,
                          const void* b2, float* part, unsigned int* bar,
                          void* out, int B, int D, int F, int n_blocks,
                          int w_dtype, long long* trace, cudaStream_t st);

}  // namespace vc

extern "C" {

// x/out: [B, D]; w1: [D, F], w2: [F, D] row-major; s1: [F], s2: [D] f32 or
// null (fp8 weights); b1: [F], b2: [D] in x's dtype.  f32 x (x_dtype) with
// f32 or fp8 e4m3 weights (w_dtype) runs the kernels above: grid =
// ceil(F / 64) tiles, barrier and trace unused.  bf16 x with bf16 or fp8
// weights runs fused_ffn_sm90 (its note says what it takes): grid = its
// block count, barrier its zeroed grid-barrier counter, trace null or its
// per-block timeline.  scratch: the f32 partials [grid, B, D].  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int vc_fused_ffn(const void* x, const void* w1, const void* s1, const void* b1,
                 const void* w2, const void* s2, const void* b2, void* scratch,
                 void* barrier, void* out, int B, int D, int F, int grid,
                 int x_dtype, int w_dtype, void* trace, void* stream) {
  const float* s1f = static_cast<const float*>(s1);
  const float* s2f = static_cast<const float*>(s2);
  float* part = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (x_dtype == vc::kBF16) {
    e = vc::fused_ffn_sm90(x, w1, s1f, b1, w2, s2f, b2, part,
                           static_cast<unsigned int*>(barrier), out, B, D, F,
                           grid, w_dtype, static_cast<long long*>(trace), st);
  } else if (x_dtype == vc::kF32 && B >= 1 && B <= vc::FFN_MAX_ROWS && D >= 1 &&
             F >= 1 && grid == (F + vc::FFN_TILE_F - 1) / vc::FFN_TILE_F) {
    if (w_dtype == vc::kF32)
      e = vc::launch_ffn<float, float>(x, w1, s1f, b1, w2, s2f, b2, part, out,
                                       B, D, F, st);
    else if (w_dtype == vc::kFP8E4M3)
      e = vc::launch_ffn<float, __nv_fp8_e4m3>(x, w1, s1f, b1, w2, s2f, b2,
                                               part, out, B, D, F, st);
  }
  return static_cast<int>(e);
}

}  // extern "C"
