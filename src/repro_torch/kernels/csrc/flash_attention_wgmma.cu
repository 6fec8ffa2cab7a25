// Flash attention forward for Hopper (sm_90a) on the tensor cores: bf16
// q, k, v at head dims 64, 128 and 256, for the LM substrate's attention
// without a KV cache (dense prefill, the encoder, the teacher-forced
// decoder, cross attention).
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py:
//   flash_fwd_wgmma <- _flash_fwd_kernel (flash_attention_bh, launched
//   there through pl.pallas_call; the GQA wrapper is flash_attention),
// for the inputs the wrapper routes here; flash_attention.cu's
// flash_fwd_kernel computes the same function for the rest (float32, other
// head dims, strides TMA cannot take).
//
// Function: o[b, s, h] = sum_t softmax_t(q[b, s, h] . k[b, t, g] / sqrt(hd))
// v[b, t, g] over the unmasked keys t, with g = h / (H / KV) and, when
// causal, the mask t <= s aligned top-left from position 0, for any S and
// T. The running max, sum and accumulator are float32 and the output is
// acc / max(l, 1e-30) rounded to bf16. Numbers: the scores are float32
// sums of the exact bf16 products (tensor-core accumulation), scaled by
// 1/sqrt(hd) after the product (folded with log2 e into exp2), so q is
// never rounded after scaling; the probabilities are rounded to bf16 for
// the PV product, as SDPA does, while the row sum adds them in float32.
//
// What bounds it on this card: the products. At the qwen2-7b prefill
// shape (B 4, S 4096, H 28, KV 4, hd 128, causal) one call needs
// 4 * B * H * hd * (unmasked pairs) = 4.8e11 FLOPs and moves 0.26 GB: the
// least time is the FLOPs at the bf16 tensor-core rate, 0.49 ms at
// 989 TFLOP/s. The design puts both products on wgmma and keeps the
// tensor cores fed:
//   - grid (H, B, query tiles): one block per 128-row query tile of one
//     head; query heads that share a KV head are neighbours in launch
//     order (their K/V tiles are shared in L2) and the longest causal
//     tiles go out first;
//   - three warpgroups: a producer whose one thread issues TMA loads
//     (setmaxnreg.dec), two consumers of 64 query rows each
//     (setmaxnreg.inc);
//   - Q is loaded once; K and V tiles (128 keys for hd <= 128, 64 for hd
//     256) arrive through a 2-stage ring guarded by full and empty
//     mbarriers, so the next tile's copy overlaps this tile's math;
//   - every tile lands in shared memory in 64-column panels with the
//     128-byte swizzle, which the wgmma descriptors read directly: S = Q K^T
//     takes both operands from shared memory (both K-major), O += P V
//     takes P from registers (the S accumulator's layout, pair by pair, is
//     the A fragment of a k16 slice) and V as an MN-major B operand (the
//     transpose bit), with the descriptor's leading-byte offset stepping
//     between the 64-column panels of hd;
//   - the online softmax stays in registers: each thread holds two rows of
//     the accumulator, the row max needs shuffles over a quad of lanes
//     only, and the row sum is reduced across the quad once at the end;
//     masks are applied only on the tile that crosses the diagonal and on
//     the last key tile when T is ragged.
// Rows past S and keys past T come back zero-filled from TMA; keys past T
// get probability 0 and rows past S are not stored. A fully masked tile
// row leaves m, l and acc unchanged, as in the TPU kernel. Pingpong
// scheduling between the consumers and persistent blocks are not done yet.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at
                   // run time (cudaGetDriverEntryPoint), so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;            // query rows per block
constexpr int kThreads = 384;       // producer + two consumer warpgroups
constexpr int kStages = 2;          // K/V ring depth
constexpr int kPanel = 64;          // bf16 columns per 128-byte swizzle panel
constexpr int kProducerRegs = 40;   // setmaxnreg budgets: 128 * 40 +
constexpr int kConsumerRegs = 232;  // 256 * 232 = 384 * 168 registers
constexpr int kConsumers = 256;     // arrivals that free a ring stage

template <int HD>
struct Tile {
  static constexpr int BK = HD <= 128 ? 128 : 64;  // keys per K/V tile
  static constexpr int PANELS = HD / kPanel;
  static constexpr uint32_t Q_BYTES = kBQ * HD * 2;
  static constexpr uint32_t KV_BYTES = BK * HD * 2;  // one K or one V tile
  static constexpr uint32_t SMEM = Q_BYTES + kStages * 2 * KV_BYTES;
};

struct Params {
  void* o;
  long long so[3];  // o's batch, sequence and head strides (elements)
  int S, T, H, KV, causal;
  float scale_log2;  // log2(e) / sqrt(hd)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spin until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
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

// one box of a rank-4 tensor map into shared memory, completion counted
// in bytes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading-byte offset, stride-byte offset (bytes), layout B128
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
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

// keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence/commit/wait points
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 64, float32) = A (64 x 16) . B (64 x 16)^T, A and B bf16 in
// shared memory (K-major, 128-byte swizzle); D is overwritten when
// accumulate is 0
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 128, float32) = A (64 x 16) . B (128 x 16)^T, A and B bf16 in
// shared memory (K-major, 128-byte swizzle); D is overwritten when
// accumulate is 0
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 64, float32) += A (64 x 16, bf16 in registers) . B (16 x 64),
// B bf16 in shared memory with N contiguous (MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// D (64 x 128, float32) += A (64 x 16, bf16 in registers) . B (16 x 128),
// B bf16 in shared memory with N contiguous (MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// D (64 x 256, float32) += A (64 x 16, bf16 in registers) . B (16 x 256),
// B bf16 in shared memory with N contiguous (MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const Params p) {
  using Tl = Tile<HD>;
  constexpr int BK = Tl::BK;
  extern __shared__ uint8_t smem_raw[];
  // q loaded; full[s] (K and V of stage s landed); empty[s] (both
  // consumers are done with stage s)
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];

  // the swizzle atoms (8 rows of 128 bytes) start on 1024-byte boundaries
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + Tl::Q_BYTES;  // stage s: K, then V
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);
  const uint32_t bar_empty = smem_u32(&bars[1 + kStages]);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // longest first
  const int g = h / (p.H / p.KV);
  const int q_end = min(q0 + kBQ, p.S);
  const int k_end = p.causal ? min(p.T, q_end) : p.T;
  const int n_tiles = (k_end + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // -- producer: one thread keeps the ring full ---------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, Tl::Q_BYTES);
#pragma unroll
      for (int c = 0; c < Tl::PANELS; ++c)
        tma_load(sQ + c * (kBQ * 128), &tm_q, bar_q, c * kPanel, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        mbar_wait(bar_empty + 8 * s, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * Tl::KV_BYTES);
        const uint32_t sK = sKV + s * (2 * Tl::KV_BYTES);
        const uint32_t sV = sK + Tl::KV_BYTES;
#pragma unroll
        for (int c = 0; c < Tl::PANELS; ++c) {
          tma_load(sK + c * (BK * 128), &tm_k, bar_full + 8 * s, c * kPanel,
                   i * BK, g, b);
          tma_load(sV + c * (BK * 128), &tm_v, bar_full + 8 * s, c * kPanel,
                   i * BK, g, b);
        }
      }
    }
  } else {
    // -- consumers: 64 query rows each ----------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = wg - 1;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int wg_row0 = q0 + 64 * cw;
    // this thread's rows of the accumulator: row0 and row0 + 8
    const int row0 = wg_row0 + 16 * warp + (lane >> 2);
    const int col0 = 2 * (lane & 3);
    // tiles this warpgroup needs: none when all its rows are past S
    const int my_end =
        p.causal ? min(p.T, min(wg_row0 + 64, p.S)) : p.T;
    const int n_mine = wg_row0 >= p.S ? 0 : (my_end + BK - 1) / BK;
    const float sl2 = p.scale_log2;

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // row max, log2 units
    float l[2] = {0.f, 0.f};              // this thread's share of the sum
    const uint32_t sQw = sQ + cw * (64 * 128);

    mbar_wait(bar_q, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      mbar_wait(bar_full + 8 * s, (i / kStages) & 1);
      if (i < n_mine) {
        const uint32_t sK = sKV + s * (2 * Tl::KV_BYTES);
        const uint32_t sV = sK + Tl::KV_BYTES;

        // S = Q K^T over hd in k16 slices; both operands K-major
        float sc[BK / 2];
        hold(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;  // k16 slice in its panel
          wgmma_ss(sc,
                   sw128_desc(sQw + (kk / 4) * (kBQ * 128) + off, 16, 1024),
                   sw128_desc(sK + (kk / 4) * (BK * 128) + off, 16, 1024),
                   kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        hold(sc);

        // masks: keys past T on the last tile, t > s on the diagonal tile
        const int k0 = i * BK;
        if (k0 + BK > p.T || (p.causal && k0 + BK - 1 > wg_row0)) {
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = k0 + 8 * j + col0 + (e & 1);
              const int row = row0 + 8 * (e >> 1);
              if (key >= p.T || (p.causal && key > row))
                sc[4 * j + e] = -INFINITY;
            }
        }

        // online softmax, in log2 units: m holds max(score) * scale * log2 e
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
          mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
        float base[2], alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float mn = fmaxf(m[r], mx[r] * sl2);
          base[r] = mn == -INFINITY ? 0.f : mn;  // a row masked so far
          alpha[r] = ex2(m[r] - base[r]);
          m[r] = mn;
        }
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
          const int r = (j >> 1) & 1;
          sc[j] = ex2(fmaf(sc[j], sl2, -base[r]));  // masked: exp2(-inf) = 0
          rs[r] += sc[j];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
        for (int j = 0; j < HD / 2; ++j) o[j] *= alpha[(j >> 1) & 1];

        // P in bf16 as the A fragments of BK / 16 k16 slices
        uint32_t pa[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);

        // O += P V: V is (keys, hd) with hd contiguous, an MN-major B
        hold(o);
        hold(pa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs(o, pa[kk],
                   sw128_desc(sV + kk * (16 * 128), BK * 128, 1024), 1);
        wgmma_commit();
        wgmma_wait_all();
        hold(o);
        hold(pa);
      }
      mbar_arrive(bar_empty + 8 * s);
    }

    // epilogue: o / max(l, 1e-30) in bf16, rows past S not stored
    __nv_bfloat16* O = (__nv_bfloat16*)p.o + (long long)b * p.so[0] +
                       (long long)h * p.so[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const float lc = fmaxf(lr, 1e-30f);
      const int row = row0 + 8 * r;
      if (row >= p.S) continue;
      __nv_bfloat16* orow = O + (long long)row * p.so[1] + col0;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(o[4 * j + 2 * r] / lc, o[4 * j + 2 * r + 1] / lc);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled lookup_encoder() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t e = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
  cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                          cudaEnableDefault, &found);
#endif
  if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
  return reinterpret_cast<EncodeTiled>(fn);
}

// error codes past the CUDA runtime's: no encoder, or the encoder refused
// a map (kEncodeFailed + its CUresult)
constexpr int kNoEncoder = 100000;
constexpr int kEncodeFailed = 100001;

// a rank-4 map over (hd, rows, heads, batch) of a bf16 tensor with unit
// stride along hd; boxes of 64 columns x `box_rows` rows, 128-byte swizzle,
// out-of-range rows zero-filled
int encode(CUtensorMap* map, const void* ptr, int hd, int rows, int heads,
           int batch, const long long* st, int box_rows) {
  static const EncodeTiled enc = lookup_encoder();
  if (enc == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st[1] * 2, (cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kPanel, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(ptr), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const Params& p,
           const long long* strides, int B, cudaStream_t stream) {
  using Tl = Tile<HD>;
  CUtensorMap tq, tk, tv;
  int rc = encode(&tq, q, HD, p.S, p.H, B, strides, kBQ);
  if (rc == 0) rc = encode(&tk, k, HD, p.T, p.KV, B, strides + 3, Tl::BK);
  if (rc == 0) rc = encode(&tv, v, HD, p.T, p.KV, B, strides + 6, Tl::BK);
  if (rc != 0) return rc;
  const int bytes = (int)Tl::SMEM + 1024;  // + alignment slack
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(p.H, B, (p.S + kBQ - 1) / kBQ);
  flash_fwd_wgmma<HD><<<grid, kThreads, bytes, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* faw_error_string(int err) {
  if (err == kNoEncoder)
    return "the driver has no cuTensorMapEncodeTiled entry point";
  if (err >= kEncodeFailed) return "cuTensorMapEncodeTiled refused a map";
  return cudaGetErrorString((cudaError_t)err);
}

// o (B, S, H, hd) from q (B, S, H, hd) and k, v (B, T, KV, hd), all bf16
// with unit stride along hd, hd in {64, 128, 256}; the batch, sequence and
// head strides in elements (q, k, v, o, three each), each a multiple of 8
// (16 bytes) and the base pointers 16-byte aligned, as TMA needs. The
// wrapper checks all of this, KV | H and the grid's limits.
extern "C" int faw_forward(int device, const void* q, const void* k,
                           const void* v, void* o, const long long* strides,
                           int B, int S, int T, int H, int KV, int hd,
                           int causal, float scale_log2, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Params p;
  p.o = o;
  for (int i = 0; i < 3; ++i) p.so[i] = strides[9 + i];
  p.S = S;
  p.T = T;
  p.H = H;
  p.KV = KV;
  p.causal = causal;
  p.scale_log2 = scale_log2;
  cudaStream_t s = (cudaStream_t)stream;
  if (hd == 64) return launch<64>(q, k, v, p, strides, B, s);
  if (hd == 128) return launch<128>(q, k, v, p, strides, B, s);
  if (hd == 256) return launch<256>(q, k, v, p, strides, B, s);
  return (int)cudaErrorInvalidValue;
}
