// Flash attention forward for Hopper (sm_90a) on the tensor cores through
// mma.sync: float32 q, k, v at every head dim up to 256 (3xTF32 products),
// and bf16 inputs that flash_attention_wgmma.cu does not take (head dims
// other than 64/128/256, layouts TMA cannot read). It serves the LM
// substrate's attention without a KV cache in float32 (the full-width LM
// pins: qwen2-7b at hd 128, whisper-base at hd 64).
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py:
//   flash_fwd_mma <- _flash_fwd_kernel (flash_attention_bh, launched there
//   through pl.pallas_call; the GQA wrapper is flash_attention),
// for the inputs the wrapper routes here; flash_attention.cu's SIMT
// flash_fwd_kernel computes the same function and runs only when asked
// for (flash_attention_cuda(..., simt=True)).
//
// Function: o[b, s, h] = sum_t softmax_t(q[b, s, h] . k[b, t, g] / sqrt(hd))
// v[b, t, g] over the unmasked keys t, with g = h / (H / KV) (jnp.repeat's
// head mapping) and, when causal, the mask t <= s aligned top-left from
// position 0, for any S and T. The running max, sum and accumulator are
// float32 and the output is acc / max(l, 1e-30) in q's type. float32: q is
// scaled by 1/sqrt(hd) on load and the softmax is exp of the scores, as in
// flash_fwd_kernel. bf16: the scores are float32 sums of the exact bf16
// products, scaled after the product in log2 units, and the probabilities
// are rounded to bf16 for the PV product while the row sum adds them in
// float32, as flash_fwd_wgmma does.
//
// Numbers (float32): one TF32 product keeps 10 mantissa bits, errors of
// about 1e-3 in the output against a float32 tolerance of 2e-5. So each
// float32 operand x is split as hi = rna(x), lo = rna(x - hi), both TF32
// (cvt.rna.tf32.f32's rounding, done as an integer add and mask), and every
// product is hi.hi + hi.lo + lo.hi (lo.lo, about 2^-22 of the product, is
// dropped): three m16n8k8 TF32 mma.sync into one float32 accumulator, the
// small products first.
//
// What bounds it on this card: the products. At the float32 pin shape
// (B 2, S 2048, H 28, KV 4, hd 128, causal) one call needs 4 * B * H * hd *
// (unmasked pairs) = 6.016e10 FLOPs and moves 134 MB. Float32-accurate
// products on the tensor cores cost three TF32 products each, so the least
// time is 3 * 6.016e10 FLOPs at 495 TFLOP/s = 0.3646 ms (the bytes: 0.040
// ms at 3.35 TB/s). flash_fwd_kernel does them as float32 FMAs on the CUDA
// cores (67 TFLOP/s peak, 0.8979 ms at best). The design:
//   - one block of 4 warps per (64-row query tile, head, batch); each warp
//     owns 16 query rows; tiles go out longest first (grid.x reversed) and
//     a causal tile stops at its last query row;
//   - Q is loaded, scaled and split into hi/lo once per block, straight
//     into each warp's A fragments: held in registers up to hd 128, in
//     shared memory in fragment order past it (one 16-byte load per
//     fragment and part on every key tile);
//   - K and V tiles go into shared memory through a 2-stage cp.async ring,
//     16 bytes a thread when the wrapper says every K/V base and stride
//     allows it, else element loads (vec = 0): keys past T and hd past its
//     value (to the head-dim bucket, below) are zero-filled. Keys per
//     tile: float32 32 up to hd 128 and 16 past it (two blocks an SM:
//     registers at hd 128, shared memory at hd 256); bf16 64, and 32 past
//     hd 128;
//   - S = Q K^T by mma.sync m16n8k8 TF32 (3xTF32; K split on the fragment
//     load) or m16n8k16 bf16; rows padded by 4 floats / 8 bf16 keep every
//     fragment load free of bank conflicts;
//   - the online softmax runs on the accumulator fragments in registers:
//     a thread holds rows g and g + 8 (g = lane / 4), and each row's 4
//     lanes reduce the max with two shuffles; the row sum stays per thread
//     and is reduced once at the end; masks only on tiles that cross the
//     warp's diagonal or T;
//   - O += P V with no shuffle: the accumulator's columns (2t, 2t + 1) are
//     taken as the m16n8k8 A fragment's (t, t + 4), which relabels the
//     contracted keys, so V's B fragment is read from key rows 2t and
//     2t + 1 of each 8-key step; for bf16 the accumulator pairs are the
//     m16n8k16 A fragment as they stand and V comes through ldmatrix.trans;
//   - n-tiles of 8 keys past the warp's last visible key are skipped, so
//     the diagonal tile costs about half;
//   - every head dim runs the smallest of the buckets 32, 64, 80, 128 and
//     256 that holds it, its columns past hd zero-filled on load and never
//     written, so every hd loop is a constant (no guard in the unrolled
//     loops).
// Registers and spills of each instantiation (-Xptxas -v, printed by
// chip_smoke.py): PERF.md's table, row 8b; at hd 128 float32 255
// registers, no spill. Measured alternatives (tools/time_flash.py on
// edited copies, PERF.md §6): cvt.rna instead of the add and mask, 64- or
// 16-key tiles at hd 128 and Q's fragments in shared memory at hd 128
// were slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                // query rows per block
constexpr int kWarps = 4;              // 16 query rows each
constexpr int kThreads = 32 * kWarps;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long sq[3], sk[3], sv[3], so[3];  // batch, sequence, head strides
  int S, T, H, KV, hd, causal, vec;
  float scale;  // 1/sqrt(hd): float32 q on load
  float sl2;    // log2(e)/sqrt(hd): bf16 scores after the product
};

// the tile shape of one instantiation: T's mma depth, K/V row padding and
// keys per tile at head-dim bucket HDB (float32: 32 keys to hd 128, 16 past
// it; bf16: 64 to hd 128, 32 past it; PERF.md §6 has the alternatives
// timed)
template <typename T, int HDB>
struct Cfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int KSTEP = F32 ? 8 : 16;  // hd per mma
  static constexpr int PAD = F32 ? 4 : 8;     // elements past each K/V row
  static constexpr int BK = F32 ? (HDB <= 128 ? 32 : 16)
                                : (HDB <= 128 ? 64 : 32);
  static constexpr int NB = BK / 8;           // 8-key n-tiles of S
  // Q's A fragments: in registers up to hd 128 (read once), else in
  // shared memory (read on every key tile)
  static constexpr bool QREG = HDB <= 128;
  static constexpr int NQ = QREG ? HDB / KSTEP : 1;  // Q fragments held
  static constexpr int NP = F32 ? 2 : 1;             // hi, lo
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (src is then unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x rounded to TF32, to nearest with ties away from zero: cvt.rna.tf32.f32's
// rounding of a finite x, as an integer add of half the dropped ulp and a
// mask (2 instructions; the cvt compiles to about 5 with its inf/NaN tests)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, both TF32, to within about 2^-22 |x|
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32: d += ah.bh + ah.bl + al.bh, the small products first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two 8 x 8 bf16 matrices, transposed: lanes 0-15 address rows 0-15
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&b)[2],
                                              const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(smem_u32(row)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (16 rows x BK keys of this warp) = Q K^T over HDB columns: s[n] is the
// m16n8 accumulator of keys 8n..8n+7; Q's fragment of hd step kk from qr
// (registers) or qf (shared memory). FULL: every n-tile is computed; else
// those at n >= n_lim are left 0 (the caller masks them).
template <typename T, int HDB, bool FULL>
__device__ __forceinline__ void scores(
    float (&s)[Cfg<T, HDB>::NB][4],
    const uint32_t (&qr)[Cfg<T, HDB>::NQ][Cfg<T, HDB>::NP][4],
    const uint32_t* qf, int q_lo, const T* ks, int n_lim, int lane) {
  using C = Cfg<T, HDB>;
  constexpr int NKQ = HDB / C::KSTEP;
  constexpr int ld = HDB + C::PAD;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < C::NB; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NKQ; ++kk) {
    uint32_t ah[4], al[4];
    if constexpr (C::QREG) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ah[e] = qr[kk][0][e];
        if constexpr (C::F32) al[e] = qr[kk][1][e];
      }
    } else {
      const uint4 qa = reinterpret_cast<const uint4*>(qf)[kk * 32 + lane];
      ah[0] = qa.x, ah[1] = qa.y, ah[2] = qa.z, ah[3] = qa.w;
      if constexpr (C::F32) {
        const uint4 qb =
            reinterpret_cast<const uint4*>(qf + q_lo)[kk * 32 + lane];
        al[0] = qb.x, al[1] = qb.y, al[2] = qb.z, al[3] = qb.w;
      }
    }
#pragma unroll
    for (int n = 0; n < C::NB; ++n) {
      if (!FULL && n >= n_lim) break;
      if constexpr (C::F32) {
        const float* kr = ks + (n * 8 + g) * ld + kk * 8 + t;
        uint32_t bh[2], bl[2];
        split(kr[0], bh[0], bl[0]);
        split(kr[4], bh[1], bl[1]);
        mma_3xtf32(s[n], ah, al, bh, bl);
      } else {
        const uint32_t* kr = reinterpret_cast<const uint32_t*>(
            ks + (n * 8 + g) * ld + kk * 16 + 2 * t);
        const uint32_t b[2] = {kr[0], kr[4]};
        mma_bf16(s[n], ah, b);
      }
    }
  }
}

// hd runs padded to HDB: columns past a.hd are zero-filled on load (their
// products are exact zeros) and never written, so every hd loop bound below
// is a constant
template <typename T, int HDB>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma(const Args a) {
  using C = Cfg<T, HDB>;
  constexpr bool F32 = C::F32;
  constexpr int BK = C::BK;
  constexpr int NB = C::NB;
  constexpr int NO = HDB / 8;  // 8-column n-tiles of O
  extern __shared__ __align__(16) unsigned char smem[];

  constexpr int ld = HDB + C::PAD;      // K/V row stride (elements)
  constexpr int nkq = HDB / C::KSTEP;   // hd steps of S
  // Q fragments (unless held in registers): float32 hi then lo, kBQ * HDB
  // words each; bf16 kBQ * HDB halves. Then the ring: stage s holds K at
  // kv + 2 s BK ld, V after it.
  uint32_t* qf = reinterpret_cast<uint32_t*>(smem);
  const int q_lo = kBQ * HDB;       // offset of the lo words (float32)
  T* kv = reinterpret_cast<T*>(
      qf + (C::QREG ? 0 : F32 ? 2 * kBQ * HDB : kBQ * HDB / 2));

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const T* Q = (const T*)a.q + b * a.sq[0] + h * a.sq[2];
  const T* K = (const T*)a.k + b * a.sk[0] + kvh * a.sk[2];
  const T* V = (const T*)a.v + b * a.sv[0] + kvh * a.sv[2];
  T* O = (T*)a.o + b * a.so[0] + h * a.so[2];

  const int q_end = min(q0 + kBQ, a.S);
  const int k_end = a.causal ? min(a.T, q_end) : a.T;
  const int ntiles = (k_end + BK - 1) / BK;
  const T zero = from_f32<T>(0.f);

  // Q: rows past S and columns past hd are 0; element (r, d) goes to its
  // warp's A fragment of hd step d / KSTEP at (lane, register): in this
  // thread's registers, or in shared memory at the fragment's slot
  uint32_t qr[C::NQ][C::NP][4];
  if constexpr (C::QREG) {
#pragma unroll
    for (int kk = 0; kk < C::NQ; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + w * 16 + g + 8 * (e & 1);
        const T* qrow = Q + (long long)(row < a.S ? row : 0) * a.sq[1];
        if constexpr (F32) {
          const int d = kk * 8 + t + 4 * (e >> 1);
          const float x = row < a.S && d < a.hd ? qrow[d] * a.scale : 0.f;
          split(x, qr[kk][0][e], qr[kk][1][e]);
        } else {
          const int d = kk * 16 + 2 * t + 8 * (e >> 1);
          __nv_bfloat162 x2;
          x2.x = row < a.S && d < a.hd ? qrow[d] : zero;
          x2.y = row < a.S && d + 1 < a.hd ? qrow[d + 1] : zero;
          qr[kk][0][e] = *reinterpret_cast<uint32_t*>(&x2);
        }
      }
  }
  for (int i = threadIdx.x; !C::QREG && i < kBQ * HDB; i += kThreads) {
    const int r = i / HDB, d = i - r * HDB;
    const bool ok = q0 + r < a.S && d < a.hd;
    const T x = ok ? Q[(long long)(q0 + r) * a.sq[1] + d] : zero;
    const int rw = r >> 4, rg = r & 7, up = (r >> 3) & 1;
    const int kk = d / C::KSTEP, c = d - kk * C::KSTEP;
    if constexpr (F32) {
      // m16n8k8 A: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
      const int slot = ((rw * nkq + kk) * 32 + rg * 4 + (c & 3)) * 4 + up +
                       2 * (c >> 2);
      uint32_t hi, lo;
      split(to_f32(x) * a.scale, hi, lo);
      qf[slot] = hi;
      qf[q_lo + slot] = lo;
    } else {
      // m16n8k16 A: a0 (g, 2t..2t+1), a1 (g + 8, ..), a2 (g, 2t+8..2t+9),
      // a3 (g + 8, ..); the lower column in the low half
      const int slot = ((rw * nkq + kk) * 32 + rg * 4 + ((c & 7) >> 1)) * 4 +
                       up + 2 * (c >> 3);
      reinterpret_cast<T*>(qf)[2 * slot + (c & 1)] = x;
    }
  }
  auto load_tile = [&](int j, int st) {
    const int k0 = j * BK;
    T* ks = kv + 2 * st * BK * ld;
    T* vs = ks + BK * ld;
    if (a.vec) {
      // HDB / EPC chunks a row; those past T or past hd are zero-filled,
      // nothing read
      constexpr int EPC = 16 / sizeof(T);  // elements per 16 bytes
      constexpr int cpr = HDB / EPC;
      const T* kt = K + k0 * a.sk[1];
      const T* vt = V + k0 * a.sv[1];
      for (int i = threadIdx.x; i < BK * cpr; i += kThreads) {
        const int r = i / cpr, c = (i - r * cpr) * EPC;
        const bool ok = k0 + r < a.T && c < a.hd;
        const int rr = ok ? r : 0, cc = ok ? c : 0;
        cp_async16(ks + r * ld + c, kt + rr * a.sk[1] + cc, ok);
        cp_async16(vs + r * ld + c, vt + rr * a.sv[1] + cc, ok);
      }
    } else {
      for (int i = threadIdx.x; i < BK * HDB; i += kThreads) {
        const int r = i / HDB, c = i - r * HDB;
        const bool ok = k0 + r < a.T && c < a.hd;
        ks[r * ld + c] = ok ? K[(long long)(k0 + r) * a.sk[1] + c] : zero;
        vs[r * ld + c] = ok ? V[(long long)(k0 + r) * a.sv[1] + c] : zero;
      }
    }
  };

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row0 = q0 + w * 16 + g;  // this thread's rows: row0, row0 + 8
  const int w_first = q0 + w * 16, w_last = w_first + 15;
  const uint32_t* qw = qf + w * nkq * 128;  // this warp's fragments

  load_tile(0, 0);
  cp_async_commit();
  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      load_tile(j + 1, (j + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = j * BK;
    const T* ks = kv + 2 * (j & 1) * BK * ld;
    const T* vs = ks + BK * ld;
    // keys of the tile a row of this warp can see: n-tiles past them are
    // skipped (none for a warp whose rows all lie past S)
    int vis = a.T - k0;
    if (a.causal) vis = min(vis, w_last + 1 - k0);
    const int n_lim = w_first >= a.S ? 0 : max(0, min(NB, (vis + 7) / 8));
    const bool edge = k0 + BK > a.T || (a.causal && k0 + BK - 1 > w_first);

    float s[NB][4];
    if (n_lim == NB)
      scores<T, HDB, true>(s, qr, qw, q_lo, ks, n_lim, lane);
    else
      scores<T, HDB, false>(s, qr, qw, q_lo, ks, n_lim, lane);

    // mask, then the online-softmax update of rows row0 and row0 + 8
    if (edge) {
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + n * 8 + 2 * t + (i & 1);
          const int row = row0 + 8 * (i >> 1);
          if (key >= a.T || (a.causal && key > row)) s[n][i] = -INFINITY;
        }
    }
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NB; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * rr], s[n][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = 0.f;
      if constexpr (F32) {
        const float mn = fmaxf(m[rr], mx);
        const float base = mn == -INFINITY ? 0.f : mn;
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[n][2 * rr + e] = expf(s[n][2 * rr + e] - base);  // masked: 0
            sum += s[n][2 * rr + e];
          }
        alpha[rr] = expf(m[rr] - base);
        m[rr] = mn;
      } else {
        const float mn = fmaxf(m[rr], mx * a.sl2);  // log2 units
        const float base = mn == -INFINITY ? 0.f : mn;
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[n][2 * rr + e] = exp2f(s[n][2 * rr + e] * a.sl2 - base);
            sum += s[n][2 * rr + e];
          }
        alpha[rr] = exp2f(m[rr] - base);
        m[rr] = mn;
      }
      l[rr] = l[rr] * alpha[rr] + sum;  // this thread's share of the row
    }

#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    if constexpr (F32) {
      // P's columns (2t, 2t + 1) of key step jj as the A fragment's
      // (t, t + 4): V's B fragment is key rows 2t and 2t + 1 of the step
#pragma unroll
      for (int jj = 0; jj < NB; ++jj) {
        if (jj >= n_lim) break;
        uint32_t ah[4], al[4];
        split(s[jj][0], ah[0], al[0]);
        split(s[jj][2], ah[1], al[1]);
        split(s[jj][1], ah[2], al[2]);
        split(s[jj][3], ah[3], al[3]);
        const float* vr = vs + (jj * 8 + 2 * t) * ld + g;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          uint32_t bh[2], bl[2];
          split(vr[n * 8], bh[0], bl[0]);
          split(vr[n * 8 + ld], bh[1], bl[1]);
          mma_3xtf32(o[n], ah, al, bh, bl);
        }
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < NB / 2; ++jj) {
        if (2 * jj >= n_lim) break;
        const uint32_t pa[4] = {pack_bf16(s[2 * jj][0], s[2 * jj][1]),
                                pack_bf16(s[2 * jj][2], s[2 * jj][3]),
                                pack_bf16(s[2 * jj + 1][0], s[2 * jj + 1][1]),
                                pack_bf16(s[2 * jj + 1][2], s[2 * jj + 1][3])};
        const T* vr = vs + (jj * 16 + (lane & 15)) * ld;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          uint32_t bb[2];
          ldsm_x2_trans(bb, vr + n * 8);
          mma_bf16(o[n], pa, bb);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float lt = l[rr];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = row0 + 8 * rr;
    if (row >= a.S) continue;
    const float lc = fmaxf(lt, 1e-30f);
    T* orow = O + (long long)row * a.so[1];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = n * 8 + 2 * t;
      if (d < a.hd) orow[d] = from_f32<T>(o[n][2 * rr] / lc);
      if (d + 1 < a.hd) orow[d + 1] = from_f32<T>(o[n][2 * rr + 1] / lc);
    }
  }
}

template <typename T, int HDB>
constexpr size_t smem_bytes() {
  using C = Cfg<T, HDB>;
  const size_t q = C::QREG ? 0 : C::F32 ? 2 * kBQ * HDB * 4 : kBQ * HDB * 2;
  return q + 4 * (size_t)C::BK * (HDB + C::PAD) * sizeof(T);
}

template <typename T, int HDB>
cudaError_t launch(const Args& a, int B, cudaStream_t s) {
  constexpr size_t bytes = smem_bytes<T, HDB>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_mma<T, HDB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.H, B);
  flash_fwd_mma<T, HDB><<<grid, kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

// the smallest bucket that holds hd (the served head dims 64, 80, 128 and
// 256 fill theirs)
template <typename T>
cudaError_t launch_hd(const Args& a, int B, cudaStream_t s) {
  if (a.hd <= 32) return launch<T, 32>(a, B, s);
  if (a.hd <= 64) return launch<T, 64>(a, B, s);
  if (a.hd <= 80) return launch<T, 80>(a, B, s);
  if (a.hd <= 128) return launch<T, 128>(a, B, s);
  if (a.hd <= 256) return launch<T, 256>(a, B, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* fam_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// o (B, S, H, hd) from q (B, S, H, hd) and k, v (B, T, KV, hd), each with
// unit stride along hd and the batch, sequence and head strides given in
// elements (strides: q, k, v, o, three each). dtype 0 is float32 and 1 is
// bf16, for all four tensors. vec = 1 loads K and V 16 bytes a thread: the
// wrapper sets it only when k's and v's base addresses, their strides and
// hd * element size are multiples of 16 bytes. The wrapper checks shapes,
// KV | H, the grid's limits and 1 <= hd <= 256.
extern "C" int fam_forward(int device, int dtype, const void* q,
                           const void* k, const void* v, void* o,
                           const long long* strides, int B, int S, int T,
                           int H, int KV, int hd, int causal, float scale,
                           float sl2, int vec, void* stream) {
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
  a.vec = vec;
  a.scale = scale;
  a.sl2 = sl2;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch_hd<float>(a, B, s);
  if (dtype == 1) return (int)launch_hd<__nv_bfloat16>(a, B, s);
  return (int)cudaErrorInvalidValue;
}
