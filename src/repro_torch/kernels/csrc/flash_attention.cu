// Flash attention forward for Hopper (sm_90a): blocked online-softmax
// attention for the LM substrate's attention without a KV cache (dense
// prefill, the encoder, the teacher-forced decoder, cross attention).
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py:
//   flash_fwd_kernel <- _flash_fwd_kernel (flash_attention_bh, launched
//   there through pl.pallas_call; the GQA wrapper is flash_attention).
//
// Function: o[b, s, h] = sum_t softmax_t(q[b, s, h] . k[b, t, g] / sqrt(hd))
// v[b, t, g] over the unmasked keys t, with g = h / (H / KV) (jnp.repeat's
// head mapping) and, when causal, the mask t <= s aligned top-left from
// position 0 (the TPU kernel's q_pos / k_pos, jnp.tril(ones((S, T)))), for
// any S and T, S != T included. As in the TPU kernel, q is scaled by
// 1/sqrt(hd) on load, inputs are converted to float32, the running max,
// sum and accumulator are float32, and the output is acc / max(l, 1e-30)
// in q's type (float32 or bf16).
//
// Design (simple first): one block of 256 threads per (64-row query tile,
// head, batch). The query tile, one 64-key tile (K, then V in the same
// buffer) and the 64 x 64 probability tile live in shared memory in
// float32; each thread owns a 4 x 4 patch of the score tile (rows
// ty + 16 r, keys tx + 16 c) and 4 x hd/16 accumulators in registers, and
// the 16 threads of a row group reduce the row max and sum with warp
// shuffles. Ragged query and key tiles are masked here (rows past S are
// neither loaded nor stored, keys past T get probability 0 and zero V
// rows), nothing is padded. A causal tile stops at its last query row:
// the key tiles past it are wholly masked and, since key 0 is unmasked
// for every row, leave m, l and acc unchanged in the TPU kernel too. The
// tiles go out longest first (grid.x reversed) so that the causal tail
// does not trail. The strides of q, k, v and o are arguments, so the
// model's (B, S, H, hd) layout is read and written in place with no
// transposes; hd up to 256 runs in the next of 16/32/64/80/128/256
// (zero-filled past hd).
//
// What bounds it on this card: the products. At the qwen2-7b prefill
// shape (B 4, S 4096, H 28, KV 4, hd 128, causal, bf16) one call needs
// 4 * BH * hd * (unmasked pairs) = 4.8e11 FLOPs and moves 0.26 GB, so the
// least time is the FLOPs at the bf16 tensor-core rate, 0.49 ms at
// 989 TFLOP/s. This kernel does its products as float32 FMAs from shared
// memory on the CUDA cores (67 TFLOP/s peak) with one shared load per two
// FMAs in the score loop, so it sits one to two orders of magnitude
// above that bound; wgmma on bf16 tiles fed by TMA is the redesign that
// closes the gap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per shared-memory tile
constexpr int kThreads = 256;  // 16 row groups x 16 lanes
constexpr int kPS = kBK + 1;   // padded row stride of the probability tile

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long sq[3], sk[3], sv[3], so[3];  // batch, sequence, head strides
  int S, T, H, KV, hd, causal;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as astype does
}

// rows [r0, r0 + kBK or kBQ) of a (rows, hd) slice at stride `rs` into a
// float32 tile of row stride HD + 1; zero past `n` rows and past hd
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long rs, int n, int hd,
                                          float scale) {
  constexpr int QS = HD + 1;
  for (int i = threadIdx.x; i < ROWS * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i - r * HD;
    float x = 0.f;
    if (r < n && d < hd) x = to_f32(src[(long long)r * rs + d]) * scale;
    dst[r * QS + d] = x;
  }
}

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Args a) {
  constexpr int QS = HD + 1;   // padded row stride of the Q and K/V tiles
  constexpr int NC = HD / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // kBQ x QS
  float* KVs = Qs + kBQ * QS;    // kBK x QS: K, then V
  float* Ps = KVs + kBK * QS;    // kBQ x kPS

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (a.H / a.KV);
  const T* Q = (const T*)a.q + b * a.sq[0] + h * a.sq[2] +
               (long long)q0 * a.sq[1];
  const T* K = (const T*)a.k + b * a.sk[0] + g * a.sk[2];
  const T* V = (const T*)a.v + b * a.sv[0] + g * a.sv[2];
  T* O = (T*)a.o + b * a.so[0] + h * a.so[2];

  const int q_end = min(q0 + kBQ, a.S);
  const int k_end = a.causal ? min(a.T, q_end) : a.T;
  load_tile<T, HD, kBQ>(Qs, Q, a.sq[1], q_end - q0, a.hd, a.scale);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    const int kn = min(kBK, a.T - k0);
    load_tile<T, HD, kBK>(KVs, K + (long long)k0 * a.sk[1], a.sk[1], kn,
                          a.hd, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qa[r] = Qs[(ty + 16 * r) * QS + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kb[c] = KVs[(tx + 16 * c) * QS + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qa[r], kb[c], s[r][c]);
    }

    // mask, then the online-softmax update of each row's m, l and acc
    float alpha[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qp = q0 + ty + 16 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx + 16 * c;
        const bool ok = kp < a.T && (!a.causal || kp <= qp);
        s[r][c] = ok ? s[r][c] : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
      const float mn = fmaxf(m[r], group_max(mx));
      const float base = mn == -INFINITY ? 0.f : mn;
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - base);  // masked: exp(-inf) = 0
        rs += s[r][c];
      }
      alpha[r] = expf(m[r] - base);
      l[r] = l[r] * alpha[r] + group_sum(rs);
      m[r] = mn;
    }
    __syncthreads();  // every thread is done with the K tile

#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        Ps[(ty + 16 * r) * kPS + tx + 16 * c] = s[r][c];
    load_tile<T, HD, kBK>(KVs, V + (long long)k0 * a.sv[1], a.sv[1], kn,
                          a.hd, 1.f);
    __syncthreads();

#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha[r];
    for (int j = 0; j < kn; ++j) {
      float p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = Ps[(ty + 16 * r) * kPS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = KVs[j * QS + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(p[r], vv, acc[r][c]);
      }
    }
    __syncthreads();  // before the next tile overwrites K/V and P
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qp = q0 + ty + 16 * r;
    if (qp >= a.S) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    T* orow = O + (long long)qp * a.so[1];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < a.hd) store(orow + d, acc[r][c] / lc);
    }
  }
}

constexpr size_t smem_bytes(int hd) {
  return sizeof(float) * ((size_t)(kBQ + kBK) * (hd + 1) + kBQ * kPS);
}

template <typename T, int HD>
cudaError_t launch(const Args& a, int B, cudaStream_t s) {
  const size_t bytes = smem_bytes(HD);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.H, B);
  flash_fwd_kernel<T, HD><<<grid, kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const Args& a, int B, cudaStream_t s) {
  if (a.hd <= 16) return launch<T, 16>(a, B, s);
  if (a.hd <= 32) return launch<T, 32>(a, B, s);
  if (a.hd <= 64) return launch<T, 64>(a, B, s);
  if (a.hd <= 80) return launch<T, 80>(a, B, s);
  if (a.hd <= 128) return launch<T, 128>(a, B, s);
  if (a.hd <= 256) return launch<T, 256>(a, B, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* fa_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// o (B, S, H, hd) from q (B, S, H, hd) and k, v (B, T, KV, hd), each with
// unit stride along hd and the batch, sequence and head strides given in
// elements (strides: q, k, v, o, three each). dtype 0 is float32 and 1 is
// bf16, for all four tensors. The wrapper checks shapes, KV | H, the
// grid's limits and 1 <= hd <= 256.
extern "C" int fa_forward(int device, int dtype, const void* q, const void* k,
                          const void* v, void* o, const long long* strides,
                          int B, int S, int T, int H, int KV, int hd,
                          int causal, float scale, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.so[i] = strides[9 + i];
  }
  a.S = S;
  a.T = T;
  a.H = H;
  a.KV = KV;
  a.hd = hd;
  a.causal = causal;
  a.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch_hd<float>(a, B, s);
  if (dtype == 1) return (int)launch_hd<__nv_bfloat16>(a, B, s);
  return (int)cudaErrorInvalidValue;
}
