// The recurrence of Kimi Delta Attention (voicecraft_tpu_torch/ops/kda.py,
// whose plain version is the arithmetic this kernel keeps): per lane and
// head a state S [dk, dv] in f32 and, for each of the lane's tokens,
//
//     S <- S * exp(g)[:, None];  u = beta (v - S^T k);  S <- S + k u^T;
//     o = S^T q * scale
//
// in f32 in that order.  One call advances B lanes by their first lens[b]
// of T tokens (T = 1: a decode step; a refill's prefill: the lane's real
// tokens packed), reading each lane's state and writing it back in place.
//
// Replaces no TPU kernel: the JAX package has no linear attention.
//
// What bounds it on the H100.  A decode step reads and writes the state
// once: 2 * 4 dk dv bytes a lane and head (134 MB at 32 lanes, 32 heads of
// 128 x 128: 40 us at 3.35 TB/s); q, k, v, g, beta and o are 1% of that.
// The work, ~4 f32 operations an element, is half an operation a byte, far
// below the CUDA cores' ~20 a byte.  So the design reads each state
// element once and writes it once, coalesced:
//  - the update is independent across the value columns: column j needs
//    only S[:, j], k, q, g, beta and v_j.  So a thread owns one column of
//    one (lane, head), all dk rows of it in registers, and a warp owns 32
//    adjacent columns: each row's load and store is one 128-byte line;
//  - a block is one warp; the grid is (dv / 32, heads, lanes), 4,096 warps
//    at the cell's decode shape, and each thread issues its dk loads at
//    once, so enough bytes are in flight to keep HBM busy;
//  - across tokens (a prefill) the state stays in registers: it is read
//    once before the first token and written once after the last; the
//    token's k, q and exp(g) are staged in shared memory (read as float4
//    broadcasts), and the next token's inputs are fetched while this one
//    is computed.  The two dot products over dk keep 4 partial sums, so
//    their chains of dependent adds are a quarter as long.
#include "common.cuh"

namespace vc {
namespace kda {

constexpr int COLS = 32;  // value columns a block (one warp) owns

template <typename T, int DK>
__global__ void __launch_bounds__(COLS)
    kda_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ g,
               const float* __restrict__ beta, float* __restrict__ state,
               const long long* __restrict__ lens, float* __restrict__ out,
               int n_tok, int H, int DV, float scale) {
  constexpr int PER = (DK + 31) / 32;  // elements of k / q / g a lane stages
  __shared__ __align__(16) float sk[DK];
  __shared__ __align__(16) float sq[DK];
  __shared__ __align__(16) float se[DK];
  const int lane = threadIdx.x;
  const int j = blockIdx.x * COLS + lane;
  const int h = blockIdx.y, b = blockIdx.z;
  long long n = n_tok;
  if (lens != nullptr) n = min(n, max(0LL, lens[b]));
  const int len = static_cast<int>(n);

  float* st = state + (static_cast<size_t>(b) * H + h) * DK * DV + j;
  float s[DK];
#pragma unroll
  for (int i = 0; i < DK; ++i) s[i] = st[static_cast<size_t>(i) * DV];

  // token t's inputs: [B, T, H, DK] for q / k / g, [B, T, H, DV] for v and
  // o, [B, T, H] for beta
  const size_t row0 = static_cast<size_t>(b) * n_tok * H + h;
  float pk[PER], pq[PER], pg[PER], pv = 0.f, pb = 0.f;
  auto fetch = [&](int t) {
    const size_t r = row0 + static_cast<size_t>(t) * H;
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int i = lane + 32 * p;
      if (i < DK) {
        pk[p] = to_float(k[r * DK + i]);
        pq[p] = to_float(q[r * DK + i]);
        pg[p] = g[r * DK + i];
      }
    }
    pv = to_float(v[r * DV + j]);
    pb = beta[r];
  };
  if (len > 0) fetch(0);

  for (int t = 0; t < len; ++t) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int i = lane + 32 * p;
      if (i < DK) {
        sk[i] = pk[p];
        sq[i] = pq[p];
        se[i] = expf(pg[p]);
      }
    }
    const float vj = pv, bt = pb;
    __syncwarp();
    if (t + 1 < len) fetch(t + 1);

    // S <- S * exp(g);  S^T k
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int i = 0; i < DK; i += 4) {
      const float4 e = *reinterpret_cast<const float4*>(se + i);
      const float4 kk = *reinterpret_cast<const float4*>(sk + i);
      s[i] *= e.x;
      s[i + 1] *= e.y;
      s[i + 2] *= e.z;
      s[i + 3] *= e.w;
      a0 = fmaf(s[i], kk.x, a0);
      a1 = fmaf(s[i + 1], kk.y, a1);
      a2 = fmaf(s[i + 2], kk.z, a2);
      a3 = fmaf(s[i + 3], kk.w, a3);
    }
    const float u = bt * (vj - ((a0 + a1) + (a2 + a3)));
    // S <- S + k u;  S^T q
    float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
#pragma unroll
    for (int i = 0; i < DK; i += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(sk + i);
      const float4 qq = *reinterpret_cast<const float4*>(sq + i);
      s[i] = fmaf(kk.x, u, s[i]);
      s[i + 1] = fmaf(kk.y, u, s[i + 1]);
      s[i + 2] = fmaf(kk.z, u, s[i + 2]);
      s[i + 3] = fmaf(kk.w, u, s[i + 3]);
      o0 = fmaf(s[i], qq.x, o0);
      o1 = fmaf(s[i + 1], qq.y, o1);
      o2 = fmaf(s[i + 2], qq.z, o2);
      o3 = fmaf(s[i + 3], qq.w, o3);
    }
    out[(row0 + static_cast<size_t>(t) * H) * DV + j] =
        ((o0 + o1) + (o2 + o3)) * scale;
    __syncwarp();
  }
  for (int t = len; t < n_tok; ++t)
    out[(row0 + static_cast<size_t>(t) * H) * DV + j] = 0.f;

#pragma unroll
  for (int i = 0; i < DK; ++i) st[static_cast<size_t>(i) * DV] = s[i];
}

template <typename T, int DK>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* g, const float* beta, float* state,
                   const long long* lens, float* out, int B, int n_tok, int H,
                   int DV, float scale, cudaStream_t st) {
  const dim3 grid(DV / COLS, H, B);
  kda_kernel<T, DK><<<grid, COLS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), g, beta, state, lens, out, n_tok, H, DV,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int DK, const void* q, const void* k, const void* v,
                     const float* g, const float* beta, float* state,
                     const long long* lens, float* out, int B, int n_tok,
                     int H, int DV, float scale, cudaStream_t st) {
#define VC_KDA_LAUNCH(D) \
  launch<T, D>(q, k, v, g, beta, state, lens, out, B, n_tok, H, DV, scale, st)
  switch (DK) {
    case 16: return VC_KDA_LAUNCH(16);
    case 32: return VC_KDA_LAUNCH(32);
    case 64: return VC_KDA_LAUNCH(64);
    case 128: return VC_KDA_LAUNCH(128);
    default: return cudaErrorInvalidValue;
  }
#undef VC_KDA_LAUNCH
}

}  // namespace kda
}  // namespace vc

extern "C" {

// q / k: [B, T, H, DK] and v: [B, T, H, DV], f32 or bf16 (dtype code);
// g: [B, T, H, DK] f32; beta: [B, T, H] f32; state: [B, H, DK, DV] f32,
// read and written in place; lens: [B] int64 on the device, or null (every
// lane takes all T tokens); out: [B, T, H, DV] f32.  All contiguous.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int vc_kda_recurrent(const void* q, const void* k, const void* v,
                     const void* g, const void* beta, void* state,
                     const void* lens, void* out, int B, int n_tok, int H,
                     int DK, int DV, float scale, int dtype, void* stream) {
  if (B < 1 || n_tok < 1 || H < 1 || DV < 32 || DV % vc::kda::COLS ||
      B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* gf = static_cast<const float*>(g);
  const auto* bf = static_cast<const float*>(beta);
  auto* sf = static_cast<float*>(state);
  const auto* ln = static_cast<const long long*>(lens);
  auto* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case vc::kF32:
      return static_cast<int>(vc::kda::dispatch<float>(
          DK, q, k, v, gf, bf, sf, ln, of, B, n_tok, H, DV, scale, st));
    case vc::kBF16:
      return static_cast<int>(vc::kda::dispatch<__nv_bfloat16>(
          DK, q, k, v, gf, bf, sf, ln, of, B, n_tok, H, DV, scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
