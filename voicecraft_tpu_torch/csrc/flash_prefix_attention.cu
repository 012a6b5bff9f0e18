// Forward-only prefix attention with an online softmax, for the prefill of
// the [text ; audio] sequence.
//
// Replaces: voicecraft_tpu/ops/flash_attention.py flash_prefix_attention
// (Pallas body _flash_kernel).  Same semantics: causal over the joint
// sequence, keys valid in [0, x_len) u [x_pad, x_pad + y_len), masked logits
// -1e9, m/l/acc in f32, key tiles past the causal edge skipped, output
// acc / max(l, 1e-20) in q's dtype.
//
// What bounds it on the H100: at the prefill shapes (S ~ 1.1k, D = 2048,
// 16 heads of 128) the work is ~2*S^2*D flops per layer against ~4*S*D
// bytes of q/k/v/out, far above the card's ~295 flop/byte balance point, so
// it is compute bound.  This first version does its products on the CUDA
// cores in f32 (no tensor cores), which makes shared-memory loads the
// limiting instruction slot; wgmma/TMA are work for a later version.
//
// Design: one block per (q tile of 16 rows, head, batch row); 4 warps, each
// owning 4 query rows.  K/V tiles of 32 keys are staged in shared memory as
// f32 straight from the [B, S, D] layout (head h = columns h*Dh ...), so
// nothing is transposed.  A lane owns one key of the tile for the logits
// (the k row is padded to Dh+1 floats so the 32 lanes hit 32 banks) and
// Dh/32 output columns for the p@v update; the softmax max and sum are warp
// reductions.  Any S is taken: the ragged edge is masked here.
#include "common.cuh"

namespace vc {

constexpr int FA_BQ = 16;                     // query rows per block
constexpr int FA_BK = 32;                     // keys per tile (one per lane)
constexpr int FA_WARPS = 4;
constexpr int FA_THREADS = 32 * FA_WARPS;
constexpr int FA_RPW = FA_BQ / FA_WARPS;      // query rows per warp

template <typename T, int DH>
__global__ void __launch_bounds__(FA_THREADS)
flash_prefix_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ x_lens,
                    const int* __restrict__ y_lens, T* __restrict__ out,
                    int S, int H, int x_pad, float scale) {
  constexpr int DPL = (DH + 31) / 32;         // output columns per lane
  __shared__ float qs[FA_BQ][DH];
  __shared__ float ks[FA_BK][DH + 1];
  __shared__ float vs[FA_BK][DH];

  const int q0 = blockIdx.x * FA_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int D = H * DH;
  const size_t base = static_cast<size_t>(b) * S * D + static_cast<size_t>(h) * DH;
  const int x_len = x_lens[b];
  const int y_len = y_lens[b];

  for (int i = tid; i < FA_BQ * DH; i += FA_THREADS) {
    const int r = i / DH, c = i % DH, qp = q0 + r;
    qs[r][c] = qp < S ? to_float(q[base + static_cast<size_t>(qp) * D + c]) * scale
                      : 0.f;
  }

  float m[FA_RPW], l[FA_RPW], acc[FA_RPW][DPL];
#pragma unroll
  for (int r = 0; r < FA_RPW; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  // causal: keys beyond the block's last query row contribute nothing
  const int k_end = min(q0 + FA_BQ, S);
  for (int k0 = 0; k0 < k_end; k0 += FA_BK) {
    __syncthreads();  // the previous tile is consumed (and qs is ready)
    for (int i = tid; i < FA_BK * DH; i += FA_THREADS) {
      const int r = i / DH, c = i % DH, kp = k0 + r;
      const bool in = kp < S;
      const size_t off = base + static_cast<size_t>(kp) * D + c;
      ks[r][c] = in ? to_float(k[off]) : 0.f;
      vs[r][c] = in ? to_float(v[off]) : 0.f;
    }
    __syncthreads();

    const int kp = k0 + lane;  // this lane's key
    const bool k_valid =
        kp < x_len || (kp >= x_pad && kp < x_pad + y_len);
    float s[FA_RPW];
#pragma unroll
    for (int r = 0; r < FA_RPW; ++r) s[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float kd = ks[lane][d];
#pragma unroll
      for (int r = 0; r < FA_RPW; ++r) s[r] = fmaf(qs[warp * FA_RPW + r][d], kd, s[r]);
    }

#pragma unroll
    for (int r = 0; r < FA_RPW; ++r) {
      const int qp = q0 + warp * FA_RPW + r;
      float logit = (k_valid && kp <= qp) ? s[r] : kNegInf;
      if (kp >= S) logit = -INFINITY;  // past the ragged edge: no such key
      const float m_new = fmaxf(m[r], warp_max(logit));
      const float alpha = expf(m[r] - m_new);
      const float p = expf(logit - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
#pragma unroll 4
      for (int j = 0; j < FA_BK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < DH) acc[r][i] = fmaf(pj, vs[j][d], acc[r][i]);
        }
      }
      m[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < FA_RPW; ++r) {
    const int qp = q0 + warp * FA_RPW + r;
    if (qp >= S) continue;
    const float denom = fmaxf(l[r], 1e-20f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < DH)
        out[base + static_cast<size_t>(qp) * D + d] = from_float<T>(acc[r][i] / denom);
    }
  }
}

template <typename T, int DH>
static cudaError_t launch_flash(const void* q, const void* k, const void* v,
                                const int* x_lens, const int* y_lens, void* out,
                                int B, int S, int H, int x_pad, float scale,
                                cudaStream_t stream) {
  const dim3 grid((S + FA_BQ - 1) / FA_BQ, H, B);
  flash_prefix_kernel<T, DH><<<grid, FA_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), x_lens, y_lens, static_cast<T*>(out), S, H,
      x_pad, scale);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch_dh(const void* q, const void* k, const void* v,
                               const int* x_lens, const int* y_lens, void* out,
                               int B, int S, int H, int Dh, int x_pad,
                               float scale, cudaStream_t st) {
  switch (Dh) {
    case 16: return launch_flash<T, 16>(q, k, v, x_lens, y_lens, out, B, S, H, x_pad, scale, st);
    case 32: return launch_flash<T, 32>(q, k, v, x_lens, y_lens, out, B, S, H, x_pad, scale, st);
    case 64: return launch_flash<T, 64>(q, k, v, x_lens, y_lens, out, B, S, H, x_pad, scale, st);
    case 128: return launch_flash<T, 128>(q, k, v, x_lens, y_lens, out, B, S, H, x_pad, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace vc

extern "C" {

// q/k/v/out: [B, S, H*Dh] contiguous, dtype f32 or bf16 (dtype code);
// x_lens/y_lens: [B] int32 on the device.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int vc_flash_prefix_attention(const void* q, const void* k, const void* v,
                              const void* x_lens, const void* y_lens, void* out,
                              int B, int S, int H, int Dh, int x_pad,
                              float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int* xl = static_cast<const int*>(x_lens);
  const int* yl = static_cast<const int*>(y_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case vc::kF32:
      e = vc::dispatch_dh<float>(q, k, v, xl, yl, out, B, S, H, Dh, x_pad, scale, st);
      break;
    case vc::kBF16:
      e = vc::dispatch_dh<__nv_bfloat16>(q, k, v, xl, yl, out, B, S, H, Dh, x_pad, scale, st);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

const char* vc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
