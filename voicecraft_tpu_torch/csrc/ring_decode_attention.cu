// Decode attention of the continuous-batching engine over its fp8 KV slab,
// the slab read in place: one query per lane against the keys its ring mask
// allows, plus the lane's own k/v as one more softmax term
// (voicecraft_tpu_torch/ops/ring_attention.py, whose plain version is the
// arithmetic this kernel keeps).
//
// Replaces no TPU kernel: the JAX engine (voicecraft_tpu/inference/
// engine.py _ring_attention) leaves the slab's .astype to XLA, which fuses
// it into the products.  Eager PyTorch upcast the layer's whole [B, S_max,
// H, Dh] slab to bf16 instead, one copy per layer and step, and read the
// copy back through cuBLAS.
//
// What bounds it on the H100: the fp8 slab's bytes, K and V of the allowed
// keys read once (at most 2 B S_max H Dh bytes a layer: 136 MB at B 32,
// S_max 1,040, H 16, Dh 128, 40.7 us at 3.35 TB/s).  The work, 4 Dh f32
// operations a key and head, is 2 operations a byte, a tenth of the 20 a
// byte at which the CUDA cores' 67 TFLOP/s would bind.  What the design
// does about the bound:
//  - nothing is written but the [B, H Dh] output: fp8 pairs become f32 in
//    registers (cvt.rn.f16x2.e4m3x2, exact), never an upcast slab;
//  - only the keys that the ring mask allows are loaded (text, prompt and
//    the lane's last t_b ring slots: about 45% of the slab at the cell's
//    geometry).  A masked key's weight in the reference's f32 softmax is
//    exp(-1e9 - max) = 0 exactly, so skipping it changes nothing;
//  - one block of 256 threads per (head, lane), the 16 heads of a lane
//    launched side by side so that the slab's 2 KB rows are read whole
//    across them; Dh / 16 threads share a key, one 16-byte load each, and
//    each thread keeps 4 keys' loads in flight (16 KB a block, ~4 blocks an
//    SM), enough outstanding bytes to keep HBM busy.
// The rounding points are ops/attention.py:_attend_one's: logits q . k in
// f32, times the scale, NEG_INF where masked; the own key's logit as an
// extra term; an f32 softmax whose probabilities are rounded to q's dtype
// before p . v; p . v summed in f32, the own term added in f32, one
// rounding.  So a (lane, head)'s S_max logits stay in shared memory between
// two passes, pass 1 over K and pass 2 over V with the rounded
// probabilities: each byte of the slab is still read once.  (A split over
// blocks that normalises after p . v would not keep those points.)
#include "common.cuh"

namespace vc {
namespace ring {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;  // keys a thread has in flight

// 16 consecutive fp8 e4m3 values (one 16-byte load) as f32, exactly
__device__ __forceinline__ void fp8x16(const uint4 u, float (&o)[16]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const __half2_raw r = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(w[i] >> (16 * j)), __NV_E4M3);
      const float2 f = __half22float2(__half2(r));
      o[4 * i + 2 * j] = f.x;
      o[4 * i + 2 * j + 1] = f.y;
    }
  }
}

// 16 consecutive elements of q's dtype as f32 (16-byte aligned)
template <typename T>
__device__ __forceinline__ void load16(const T* p, float (&o)[16]) {
  float a[8], b[8];
  load8(p, a);
  load8(p + 8, b);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    o[i] = a[i];
    o[8 + i] = b[i];
  }
}

// one lane's ring geometry (ops/attention.py:_ring_valid)
struct Lane {
  long long x_len, prefix_len, t, gstep;
  int g_mod;  // gstep mod W, in [0, W)
};

// _ring_valid's key j: text [0, x_len), prompt [x_pad, x_pad + prefix_len),
// or ring slot r = j - y_start last written age = 1 + ((gstep - 1 - r) mod W)
// steps ago, which belongs to the lane iff age <= t and gstep >= age
__device__ __forceinline__ bool key_valid(int j, const Lane& l, int x_pad,
                                          int y_start, int W) {
  if (j < l.x_len) return true;
  if (j >= x_pad && j < x_pad + l.prefix_len) return true;
  if (j < y_start) return false;
  int a = (l.g_mod - 1 - (j - y_start)) % W;
  if (a < 0) a += W;
  const long long age = 1 + a;
  return age <= l.t && l.gstep >= age;
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS, 4)
ring_decode_kernel(const T* __restrict__ q, const uint8_t* __restrict__ k,
                   const uint8_t* __restrict__ v, const T* __restrict__ k_new,
                   const T* __restrict__ v_new, long long q_stride,
                   long long kn_stride, long long vn_stride,
                   const long long* __restrict__ x_lens,
                   const long long* __restrict__ prefix_lens,
                   const long long* __restrict__ t_lane,
                   const long long* __restrict__ gstep, T* __restrict__ out,
                   int S, int H, int x_pad, int y_start, int W, float scale) {
  constexpr int TPK = DH / 16;          // threads that share a key
  constexpr int KPS = THREADS / TPK;    // keys one sweep of the block covers
  extern __shared__ float p_s[];        // [S]: logits, then probabilities
  __shared__ float red_s[WARPS];
  __shared__ float part_s[WARPS][DH];
  __shared__ float self_s;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int sub = tid % TPK;            // this thread's 16 of the head's Dh
  const int grp = tid / TPK;            // this thread's key in a sweep

  Lane ln;
  ln.x_len = x_lens[b];
  ln.prefix_len = prefix_lens[b];
  ln.t = t_lane[b];
  ln.gstep = *gstep;
  ln.g_mod = static_cast<int>(((ln.gstep % W) + W) % W);

  float qf[16];
  load16(q + b * q_stride + h * DH + sub * 16, qf);
  const size_t row = static_cast<size_t>(H) * DH;  // bytes of one key, all heads
  const size_t head0 = static_cast<size_t>(b) * S * row +
                       static_cast<size_t>(h) * DH + sub * 16;
  const uint8_t* kb = k + head0;
  const uint8_t* vb = v + head0;

  // pass 1: the allowed keys' logits (NEG_INF elsewhere) and their max
  float m = kNegInf;
  for (int j0 = 0; j0 < S; j0 += KPS * UNROLL) {
    uint4 kr[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * KPS + grp;
      ok[u] = j < S && key_valid(j, ln, x_pad, y_start, W);
      if (ok[u]) kr[u] = *reinterpret_cast<const uint4*>(kb + j * row);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * KPS + grp;
      float s = 0.f;
      if (ok[u]) {
        float kf[16];
        fp8x16(kr[u], kf);
#pragma unroll
        for (int i = 0; i < 16; ++i) s = fmaf(qf[i], kf[i], s);
      }
#pragma unroll
      for (int o = TPK / 2; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (sub == 0 && j < S) {
        const float l = ok[u] ? s * scale : kNegInf;
        p_s[j] = l;
        m = fmaxf(m, l);
      }
    }
  }
  // the lane's own key, the softmax's last term (every group of warp 0
  // computes it; thread 0 keeps it)
  if (warp == 0) {
    float kf[16];
    load16(k_new + b * kn_stride + h * DH + sub * 16, kf);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) s = fmaf(qf[i], kf[i], s);
#pragma unroll
    for (int o = TPK / 2; o > 0; o >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, o);
    if (tid == 0) self_s = s * scale;
  }
  m = warp_max(m);
  if (lane == 0) red_s[warp] = m;
  __syncthreads();                      // p_s, self_s and red_s written
  float mx = self_s;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, red_s[w]);
  __syncthreads();                      // red_s read before it is reused

  // the f32 softmax's sum, then its probabilities rounded to T
  float sum = 0.f;
  for (int j = tid; j < S; j += THREADS) sum += expf(p_s[j] - mx);
  sum = warp_sum(sum);
  if (lane == 0) red_s[warp] = sum;
  __syncthreads();
  float tot = expf(self_s - mx);
#pragma unroll
  for (int w = 0; w < WARPS; ++w) tot += red_s[w];
  for (int j = tid; j < S; j += THREADS)
    p_s[j] = to_float(from_float<T>(expf(p_s[j] - mx) / tot));
  const float p_self = to_float(from_float<T>(expf(self_s - mx) / tot));
  __syncthreads();

  // pass 2: p . v over the allowed keys in f32
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int j0 = 0; j0 < S; j0 += KPS * UNROLL) {
    uint4 vr[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * KPS + grp;
      ok[u] = j < S && key_valid(j, ln, x_pad, y_start, W);
      if (ok[u]) vr[u] = *reinterpret_cast<const uint4*>(vb + j * row);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
      const float p = p_s[j0 + u * KPS + grp];
      float vf[16];
      fp8x16(vr[u], vf);
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
    }
  }
  // the threads of a warp that hold the same columns, then the warps
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int o = 16; o >= TPK; o >>= 1)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
  }
  if (lane < TPK) {
#pragma unroll
    for (int i = 0; i < 16; ++i) part_s[warp][sub * 16 + i] = acc[i];
  }
  __syncthreads();
  for (int d = tid; d < DH; d += THREADS) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += part_s[w][d];
    a += p_self * to_float(v_new[b * vn_stride + h * DH + d]);
    out[(static_cast<size_t>(b) * H + h) * DH + d] = from_float<T>(a);
  }
}

template <typename T, int DH>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          const void* k_new, const void* v_new,
                          long long q_stride, long long kn_stride,
                          long long vn_stride, const long long* x_lens,
                          const long long* prefix_lens,
                          const long long* t_lane, const long long* gstep,
                          void* out, int B, int S, int H, int x_pad,
                          int y_start, int W, float scale,
                          cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(S) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ring_decode_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  ring_decode_kernel<T, DH><<<dim3(H, B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const uint8_t*>(k),
      static_cast<const uint8_t*>(v), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), q_stride, kn_stride, vn_stride, x_lens,
      prefix_lens, t_lane, gstep, static_cast<T*>(out), S, H, x_pad, y_start,
      W, scale);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch(int Dh, const void* q, const void* k,
                            const void* v, const void* k_new,
                            const void* v_new, long long q_stride,
                            long long kn_stride, long long vn_stride,
                            const long long* x_lens,
                            const long long* prefix_lens,
                            const long long* t_lane, const long long* gstep,
                            void* out, int B, int S, int H, int x_pad,
                            int y_start, int W, float scale,
                            cudaStream_t st) {
#define VC_RING_LAUNCH(D)                                                   \
  launch<T, D>(q, k, v, k_new, v_new, q_stride, kn_stride, vn_stride,      \
               x_lens, prefix_lens, t_lane, gstep, out, B, S, H, x_pad,    \
               y_start, W, scale, st)
  switch (Dh) {
    case 16: return VC_RING_LAUNCH(16);
    case 32: return VC_RING_LAUNCH(32);
    case 64: return VC_RING_LAUNCH(64);
    case 128: return VC_RING_LAUNCH(128);
    default: return cudaErrorInvalidValue;
  }
#undef VC_RING_LAUNCH
}

}  // namespace ring
}  // namespace vc

extern "C" {

// q: [B, 1, H*Dh] and k_new / v_new: [B, 1, H, Dh], f32 or bf16 (dtype
// code), each lane's row contiguous and `*_stride` elements after the last
// one's (a packed qkv product's views), 16-byte aligned.  k / v: the layer's
// fp8 e4m3 slab [B, S, H, Dh], contiguous.  x_lens / prefix_lens / t_lane:
// [B] int64, gstep: one int64, all on the device.  out: [B, 1, H*Dh] of q's
// dtype, contiguous.  Launches on `stream` and returns cudaGetLastError()
// (0 on success).
int vc_ring_decode_attention(const void* q, const void* k, const void* v,
                             const void* k_new, const void* v_new,
                             long long q_stride, long long kn_stride,
                             long long vn_stride, const void* x_lens,
                             const void* prefix_lens, const void* t_lane,
                             const void* gstep, void* out, int B, int S,
                             int H, int Dh, int x_pad, int y_start, int W,
                             float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || W < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xl = static_cast<const long long*>(x_lens);
  const auto* pl = static_cast<const long long*>(prefix_lens);
  const auto* tl = static_cast<const long long*>(t_lane);
  const auto* gs = static_cast<const long long*>(gstep);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case vc::kF32:
      return static_cast<int>(vc::ring::dispatch<float>(
          Dh, q, k, v, k_new, v_new, q_stride, kn_stride, vn_stride, xl, pl,
          tl, gs, out, B, S, H, x_pad, y_start, W, scale, st));
    case vc::kBF16:
      return static_cast<int>(vc::ring::dispatch<__nv_bfloat16>(
          Dh, q, k, v, k_new, v_new, q_stride, kn_stride, vn_stride, xl, pl,
          tl, gs, out, B, S, H, x_pad, y_start, W, scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
