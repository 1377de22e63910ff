// int8-weight x bf16-activation matrix product, hand-written for Hopper (sm_90a).
//
//   y[m, n] = bf16( scale[n] * sum_k x[m, k] * q[k, n] ),  f32 accumulation
//
// x [M, K] bf16 and q [K, N] int8 are contiguous (q is one layer's slice of
// the port's [in, out] weight layout, never transposed); scale [1, N] bf16
// is q's per-output-channel scale (the reference reduces it over the
// contraction axis, so it factors out of the sum); y [M, N] bf16.
//
// What it replaces: not a pallas_call. The JAX package computes
// ``x @ dequant(w)`` (agentainer_tpu/ops/quant.py::dequant, called from
// agentainer_tpu/models/llama.py:327-330 for the layer weights and :357 for
// lm_head) and XLA fuses the int8 -> bf16 convert and the scale into the
// consuming dot, so no dense weight ever reaches device memory. Written out
// in PyTorch (q.to(bf16) * scale, then a matmul) the same product reads 1 B,
// writes 2 B and reads 2 B again per weight: 5 B against bf16 serving's 2 B.
// This kernel is that fusion: int8 tiles go to shared memory as they are
// stored and are widened to bf16 in registers on their way into the tensor
// cores.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): the larger of
// (K*N + 2N + 2MK + 2MN) bytes / 3.35 TB/s and 2MKN FLOPs / 989 TFLOP/s.
// A decode step (M = 8) and the verify rounds (M = 24, 40, 72) are bounded
// by the weight bytes (w_gate 4096 x 14336: about 17.6 us); a 256-row
// prefill chunk by its FLOPs (w_gate: about 30.4 us).
//
// Design (w8a16_grouped_kernel<BM>, one body for every M and E; the wrapper's plan picks
// the token tile BM and the split from the shape):
//   - a block owns BN = 128 output channels x BM tokens (BM = 8, 24, 40,
//     72, 128 or 256, the wgmma N) and a range of the contraction. A ring of
//     up to 16 stages is kept full by TMA, issued by one thread of a
//     producer warp(group): the q tile [64][128] int8 as stored and the x
//     tile [BM][64] bf16, both with 128-byte swizzle, completing on the
//     stage's mbarrier (rows past M and columns past N arrive as zeros).
//     The ring is as deep as 227 KB of shared memory allows, rounded down
//     to a multiple of the stage pairs (16 stages at BM <= 40, 12 at 72, 5
//     at 256), so a decode block keeps 128 KB of weights in flight;
//   - consumer warpgroups of 64 output channels each: a warp reads its 16
//     channels of the int8 tile with ldmatrix.trans at the swizzled address
//     (16-bit pairs: two k values of two neighbouring channels per thread)
//     and widens them in registers (byte -> f32 through the 2^23 magic
//     number, exact, then the high half of each f32 is its bf16) into
//     wgmma's register-sourced A fragment: the weight is A (channel 2g as
//     fragment row g and 2g + 1 as row g + 8, which the epilogue undoes),
//     the tokens are B, read by wgmma.mma_async m64nBMk16 straight from the
//     swizzled x tile (x is K-major, wgmma's own B layout), f32
//     accumulators in registers. A register-sourced wgmma reads its A
//     registers until it completes, so a warpgroup waits for its stage's
//     products before it widens the next stage (widening into registers the
//     products still read gives wrong sums); other warpgroups keep the
//     tensor cores busy meanwhile;
//   - up to 72 tokens (decode, verify) the bound is the weight bytes, and
//     one stage's ldmatrix -> widen -> wgmma chain takes longer than its 8 KB
//     take to stream at an SM's share of 3.35 TB/s: four consumer
//     warpgroups in two pairs take alternate stages, each pair its own
//     partial sums. At 128 and 256 tokens two consumer warpgroups take every
//     stage with m64n128 / m64n256 products, so a 256-row prefill chunk
//     widens each weight tile once. Every warp of a block is compiled under
//     the launch bound's register cap (65536 / 32 / warps on the fullest SM
//     sub-partition: 96 for 17 warps, 168 for 12), which sets these counts;
//     setmaxnreg hands the two-consumer blocks' producer registers to their
//     consumers;
//   - the scale is applied once in the epilogue, in f32, before the one
//     rounding to bf16;
//   - a weight with few 128-column tiles (wk at decode: 8) does not fill
//     132 SMs, so its contraction is split (the wrapper picks the split
//     count from the shape alone) over the blocks of one thread-block
//     cluster, at most 8. After the main loop each block leaves its f32
//     partial tiles (one per stage pair) in its own shared memory; behind a
//     cluster barrier each block sums its share of the tile's outputs over
//     the cluster's blocks in rank order, and over a block's pairs in order,
//     through distributed shared memory, scales, rounds and stores. One
//     launch per call, no workspace, no atomics, and no block waits for
//     another that might not be resident (a cluster runs all together or
//     not at all): the result is the same bits on every run and in a
//     replayed CUDA graph, fixed by the shape alone.
//
// The grouped product (the same kernel; the 2-D product above is its case
// E = 1 with a shared x):
//
//   y[e, m, n] = bf16( scale[e, n] * sum_k x_e[m, k] * q[e, k, n] ),  e < E
//
// q [E, K, N] int8 is an expert stack (one layer's slice of the port's [L, E,
// K, N] leaf), scale [E, 1, N] bf16, y [E, M, N] bf16, and x_e is either one
// x [M, K] shared by every expert or x [E, M, K], one per expert. What it
// replaces: not a pallas_call either; XLA's fusion of the int8 convert into
// the reference's expert einsums (agentainer_tpu/models/llama.py:143-145,
// shared x for gate and up and per-expert input for down; :229-231, the
// routed path's per-expert buffers). All E experts run in one launch: q is
// contiguous [E * K, N], so the 2-D weight map serves it with expert e's
// contraction tiles at row e * K + k0 (K % 64 == 0: a tile never crosses
// experts); a per-expert x is contiguous [E * M, K] and its map gives expert
// e's tile at row e * M + m0 (a tile that runs past row M reads the next
// expert's rows, which feed only output rows that are never stored; past the
// last expert TMA fills zeros); blockIdx.z carries the expert and the token
// tile, e * ceil(M / BM) + i. Bound on an H100 SXM: the larger of (E K N +
// 2 E N + 2 M K [E times for per-expert x] + 2 E M N) bytes / 3.35 TB/s and
// 2 E M K N FLOPs / 989 TFLOP/s: at Mixtral-8x7B's decode (M = 8) each of a
// layer's three stacks is 469.8 MB of int8, about 0.140 ms.
//
// A wait on an mbarrier that has not completed after about 10 s of clock
// traps: a fault in the schedule ends the kernel with an error rather than
// hanging the card.

#include <cuda.h>  // CUtensorMap; cuTensorMapEncodeTiled is looked up at run time, nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>
#include <unordered_map>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BN = 128;                    // output channels per block
constexpr int BK = 64;                     // contraction depth per stage
constexpr int Q_TILE = BK * BN;            // bytes of one int8 weight tile
constexpr int X_ROW = 2 * BK;              // bytes of one staged x row (the 128-byte swizzle span)
constexpr int MAX_STAGES = 16;
constexpr int PART_ROW = BN + 4;           // floats of one token row of a partial tile
constexpr size_t MAX_SMEM = 232448;        // dynamic shared memory a block may use on sm_90
constexpr int MAX_SPLITS = 8;              // portable cluster size
constexpr long long WAIT_LIMIT = 20000000000LL;  // clock cycles (~10 s) before a stuck wait traps

template <int BM>
__host__ __device__ constexpr int stage_bytes() {
  return Q_TILE + BM * X_ROW;
}
// Consumer warpgroups of a block, each 64 output channels: up to 72 tokens
// four, in two pairs that take alternate stages (two widen + wgmma chains
// in flight); beyond, two on every stage. Besides them one producer: a warp
// beside four consumers (17 warps, 96 registers each, enough for an
// m64n72 accumulator), a warpgroup beside two (12 warps, 168 registers;
// setmaxnreg moves the producer's share to the consumers).
template <int BM>
__host__ __device__ constexpr int consumers() {
  return BM <= 72 ? 4 : 2;
}
// As many stages as 227 KB hold, at most MAX_STAGES, and a multiple of the
// stage pairs: then every round of a slot goes to the same pair, which has
// seen the slot's previous round complete before it waits on the next. (A
// pair that waits on a slot whose previous round went to the other pair may
// find that round's fill still in flight, and a parity wait cannot tell one
// round from the round before it: it would return at once and read the slot
// before its bytes land.)
template <int BM>
__host__ __device__ constexpr int stages() {
  const int fit = (int)((MAX_SMEM - 1024) / (stage_bytes<BM>() + 16));
  const int n = fit < MAX_STAGES ? fit : MAX_STAGES;
  return n - n % (consumers<BM>() / 2);
}
template <int BM>
__host__ __device__ constexpr int threads() {
  return 128 * consumers<BM>() + (consumers<BM>() == 2 ? 128 : 32);
}
template <int BM>
__host__ __device__ constexpr size_t smem_bytes() {  // 1024 bytes to align the ring, the ring, two mbarriers a stage
  return 1024 + (size_t)stages<BM>() * (stage_bytes<BM>() + 16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers, TMA, clusters ---------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > WAIT_LIMIT) __trap();
  }
}

// box at coordinates (c0 innermost, c1) of the tensor map -> shared memory,
// completing `bytes` of the barrier's transaction count
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], "
      "[%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {  // every thread of every block of the cluster
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// -- fragments -------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Four int8 b0..b3 (b0 in the low byte) -> bf16 pairs even = (b0, b2) and
// odd = (b1, b3), the first of each pair in the low half. Each byte, biased
// to unsigned, becomes the low mantissa byte of 2^23: (2^23 + b + 128) -
// (2^23 + 128) = b exactly in f32, and an integer of magnitude <= 128 has
// no mantissa bits below bf16's, so the f32's high half is its bf16.
__device__ __forceinline__ void widen_i8x4(uint32_t r, uint32_t& even, uint32_t& odd) {
  const uint32_t u = r ^ 0x80808080u;
  constexpr uint32_t kTwo23 = 0x4B000000u;
  constexpr float kBias = 8388736.0f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, kTwo23, 0x7650)) - kBias;
  const float f1 = __uint_as_float(__byte_perm(u, kTwo23, 0x7651)) - kBias;
  const float f2 = __uint_as_float(__byte_perm(u, kTwo23, 0x7652)) - kBias;
  const float f3 = __uint_as_float(__byte_perm(u, kTwo23, 0x7653)) - kBias;
  even = __byte_perm(__float_as_uint(f0), __float_as_uint(f2), 0x7632);
  odd = __byte_perm(__float_as_uint(f1), __float_as_uint(f3), 0x7632);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

// -- wgmma -------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {  // every committed group has completed
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Shared-memory descriptor of a K-major operand in 128-byte-swizzled rows
// of 64 bf16 (what TMA wrote): start address, leading offset 16 B (unused
// by this layout), 1024 B between groups of 8 rows, swizzle mode 128 B.
// The tile base is 1024-byte aligned; the k16 slice kk starts kk * 32
// bytes in, and the hardware applies the swizzle to the address it forms.
__device__ __forceinline__ uint64_t kmajor_sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d[64 x BM] += a (64 x 16, registers) * b (16 x BM, shared memory, desc).
// Per thread: d[4i + j] is (row 16w + g, column 8i + 2t + j) and d[4i + 2 + j]
// is row 16w + g + 8, for warp w of the warpgroup, g = lane / 4, t = lane % 4.
template <int BM>
__device__ __forceinline__ void wgmma_rs(float (&d)[BM / 2], const uint32_t (&a)[4], uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_rs<8>(float (&d)[4], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<24>(float (&d)[12], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, {%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<40>(float (&d)[20], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19"
      "}, {%20, %21, %22, %23}, %24, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<72>(float (&d)[36], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35"
      "}, {%36, %37, %38, %39}, %40, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}


template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// One block: output channels [blockIdx.y * BN, +BN) of tokens [m0, +BM) of
// a product whose weight tiles start at row q_row0 of q's map and whose x
// tile starts at row x_row of x's map; scale and out are the product's own
// (already offset to its expert). Contraction tiles [s * steps / splits,
// (s + 1) * steps / splits) of steps = K / BK, split s being the block's
// rank in its cluster of (splits, 1, 1).
template <int BM>
__device__ __forceinline__ void w8a16_block(const CUtensorMap* q_map, const CUtensorMap* x_map,
                                            const bf16* __restrict__ scale, bf16* __restrict__ out,
                                            int M, int N, int K, int splits, int m0, int q_row0,
                                            int x_row) {
  constexpr int STAGES = stages<BM>();
  constexpr int STAGE = stage_bytes<BM>();
  constexpr int WGS = consumers<BM>();
  constexpr int PAIRS = WGS / 2;  // stage pairs: pair p takes the stages s with s % PAIRS == p
  static_assert(BM % 8 == 0 && BM <= 256, "wgmma takes 8..256 tokens in steps of 8");
  static_assert(STAGES % PAIRS == 0, "each slot's rounds all go to one pair");
  static_assert((size_t)PAIRS * BM * PART_ROW * 4 <= (size_t)STAGES * STAGE, "the partials reuse the ring");
  static_assert(smem_bytes<BM>() <= MAX_SMEM, "stages do not fit in shared memory");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the ring on a 1024-byte boundary (the 128-byte swizzle repeats every 8 rows)
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* ring = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t ring_s = smem_u32(ring);
  const uint32_t full0 = ring_s + STAGES * STAGE;  // full[s] at full0 + 8 s, empty[s] after them
  const uint32_t empty0 = full0 + 8 * STAGES;

  const int split = (int)cluster_rank();
  const int n0 = blockIdx.y * BN;
  const int steps = K / BK;
  const int s_begin = (int)((long long)steps * split / splits);
  const int n_steps = (int)((long long)steps * (split + 1) / splits) - s_begin;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);  // the producer's arrive + the tile bytes
      mbar_init(empty0 + 8 * s, 8);  // one arrive per warp of the pair that reads the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * WGS) {
    // the producer warp(group): one thread issues every load
    if (WGS == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 4 * WGS && lane == 0) {
      for (int step = 0; step < n_steps; ++step) {
        const int slot = step % STAGES;
        const uint32_t round = (uint32_t)(step / STAGES);
        mbar_wait(empty0 + 8 * slot, (round & 1) ^ 1);  // round 0 passes: the ring starts empty
        const uint32_t bar = full0 + 8 * slot;
        const uint32_t dst = ring_s + slot * STAGE;
        const int k0 = (s_begin + step) * BK;
        mbar_arrive_expect_tx(bar, STAGE);
        tma_load_2d(dst, q_map, n0, q_row0 + k0, bar);
        tma_load_2d(dst + Q_TILE, x_map, k0, x_row, bar);
      }
    }
    if (splits > 1) {  // the consumers' two cluster barriers count every thread
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // consumer warpgroup wg: output channels 64 (wg % 2) .. + 63 of the
  // block, i.e. 16-byte chunks cw = 4 (wg % 2) .. + 3 of each 128-byte q
  // row, one per warp; pair wg / 2 takes every PAIRS-th stage
  if (WGS == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp >> 2, pair = wg >> 1;
  const int cw = 4 * (wg & 1) + (warp & 3);
  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
  // ldmatrix.x4.trans: lane gives row lane % 8 of matrix lane / 8, which is
  // k row 8 (lane / 8) + lane % 8 of a 32-deep half tile; that row's chunk
  // cw sits at chunk cw ^ (k % 8) under the swizzle
  const int r = lane & 7;
  const uint32_t q_lane = (uint32_t)(((lane >> 3) * 8 + r) * BN + ((cw ^ r) << 4));

  for (int step = pair; step < n_steps; step += PAIRS) {
    const int slot = step % STAGES;
    mbar_wait(full0 + 8 * slot, (uint32_t)(step / STAGES) & 1);
    const uint32_t qs = ring_s + slot * STAGE;
    uint32_t raw0[4], raw1[4];
    ldsm_x4_trans(raw0, qs + q_lane);            // k 0..31: matrices k 0-7, 8-15, 16-23, 24-31
    ldsm_x4_trans(raw1, qs + q_lane + 32 * BN);  // k 32..63
    uint32_t a[4][4];                            // A fragments of the four k16 slices
    widen_i8x4(raw0[0], a[0][0], a[0][1]);
    widen_i8x4(raw0[1], a[0][2], a[0][3]);
    widen_i8x4(raw0[2], a[1][0], a[1][1]);
    widen_i8x4(raw0[3], a[1][2], a[1][3]);
    widen_i8x4(raw1[0], a[2][0], a[2][1]);
    widen_i8x4(raw1[1], a[2][2], a[2][3]);
    widen_i8x4(raw1[2], a[3][0], a[3][1]);
    widen_i8x4(raw1[3], a[3][2], a[3][3]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<BM>(acc, a[kk], kmajor_sw128_desc(qs + Q_TILE + kk * 32));
    wgmma_commit();
    // a register-sourced wgmma reads its A registers until it completes, so
    // the next stage's widening waits for it (the other warpgroups keep the
    // tensor cores busy meanwhile); then the stage goes back to the producer
    wgmma_wait_all();
    if (lane == 0) mbar_arrive(empty0 + 8 * slot);
  }

  // fragment row g / g + 8 of warp cw is output channel 16 cw + 2g / 2g + 1
  // of the block; column 8i + 2t + j is token 8i + 2t + j of the tile
  const int g = lane >> 2, t = lane & 3;
  const int c = 16 * cw + 2 * g;
  if (PAIRS == 1 && splits == 1) {
    const int n = n0 + c;
    if (n < N) {
      const float s0 = __bfloat162float(scale[n]), s1 = __bfloat162float(scale[n + 1]);
#pragma unroll
      for (int i = 0; i < BM / 8; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int m = m0 + 8 * i + 2 * t + j;
          if (m < M) {
            *reinterpret_cast<uint32_t*>(out + (size_t)m * N + n) =
                pack_bf16(acc[4 * i + j] * s0, acc[4 * i + 2 + j] * s1);
          }
        }
      }
    }
    return;
  }
  // Partial tiles [BM][PART_ROW] f32 in the ring, one per stage pair; then
  // each block of the cluster sums its share of the tile's outputs over the
  // cluster's blocks in rank order, and within a block over its pairs in
  // order, through distributed shared memory.
  constexpr int CT = 128 * WGS;  // consumer threads
  asm volatile("bar.sync 1, %0;\n" ::"n"(CT) : "memory");  // every product has read the ring
  float* part = reinterpret_cast<float*>(ring) + pair * BM * PART_ROW;
#pragma unroll
  for (int i = 0; i < BM / 8; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      *reinterpret_cast<float2*>(part + (8 * i + 2 * t + j) * PART_ROW + c) =
          make_float2(acc[4 * i + j], acc[4 * i + 2 + j]);
    }
  }
  if (splits > 1) {
    cluster_sync();  // every split's partials are written
  } else {
    asm volatile("bar.sync 1, %0;\n" ::"n"(CT) : "memory");
  }
  const int groups = BM * (BN / 4);  // 4-channel groups of the tile
  const int u_end = (int)((long long)groups * (split + 1) / splits);
  const float* part0 = reinterpret_cast<const float*>(ring);
  for (int u = (int)((long long)groups * split / splits) + threadIdx.x; u < u_end; u += CT) {
    const int row = u / (BN / 4), col = 4 * (u % (BN / 4));
    const int m = m0 + row, n = n0 + col;
    if (m >= M || n >= N) continue;  // N % 16 == 0: a group is all in or all out
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int rank = 0; rank < splits; ++rank) {
#pragma unroll
      for (int p = 0; p < PAIRS; ++p) {
        const float4 v = ld_cluster_f4(smem_u32(part0 + (p * BM + row) * PART_ROW + col), (uint32_t)rank);
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
    }
    const uint2 sc = *reinterpret_cast<const uint2*>(scale + n);
    const __nv_bfloat162 s01 = *reinterpret_cast<const __nv_bfloat162*>(&sc.x);
    const __nv_bfloat162 s23 = *reinterpret_cast<const __nv_bfloat162*>(&sc.y);
    *reinterpret_cast<uint2*>(out + (size_t)m * N + n) =
        make_uint2(pack_bf16(sum.x * __low2float(s01), sum.y * __high2float(s01)),
                   pack_bf16(sum.z * __low2float(s23), sum.w * __high2float(s23)));
  }
  if (splits > 1) cluster_sync();  // no block leaves while another still reads its partials
}

// grid (splits, ceil(N / BN), E * m_tiles), m_tiles = ceil(M / BM), clusters
// of (splits, 1, 1): block (s, j, e * m_tiles + i) computes expert e's output
// channels [j * BN, +BN) of tokens [i * BM, +BM), split s of the
// contraction. q's map is [E * K, N]; x's is [E * M, K] when x_per_expert,
// else [M, K]. The 2-D product is the case E = 1 with a shared x.
template <int BM>
__global__ void __launch_bounds__(threads<BM>(), 1) w8a16_grouped_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap x_map,
    const bf16* __restrict__ scale, bf16* __restrict__ out, int M, int N, int K, int splits,
    int m_tiles, int x_per_expert) {
  const int e = (int)blockIdx.z / m_tiles;
  const int m0 = ((int)blockIdx.z - e * m_tiles) * BM;
  w8a16_block<BM>(&q_map, &x_map, scale + (size_t)e * N, out + (size_t)e * M * N, M, N, K, splits,
                  m0, e * K, x_per_expert ? e * M + m0 : m0);
}

// Raise kernel Kern's dynamic shared-memory limit on the current device to
// at least smem bytes, once per device (the attribute is per device; the
// engine's eager warmup sets it before the same shapes are captured into a
// graph).
constexpr int kMaxDevices = 64;

template <auto Kern>
cudaError_t raise_smem_limit(size_t smem) {
  static std::atomic<size_t> granted[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::atomic<size_t>* gr = dev < kMaxDevices ? &granted[dev] : nullptr;
  if (gr != nullptr && smem <= gr->load(std::memory_order_relaxed)) return cudaSuccess;
  err = cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess || gr == nullptr) return err;
  size_t prev = gr->load(std::memory_order_relaxed);
  while (prev < smem && !gr->compare_exchange_weak(prev, smem)) {
  }
  return cudaSuccess;
}

// -- tensor maps ---------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {  // cuTensorMapEncodeTiled from the libcuda that the runtime loaded
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                       : nullptr;
  }();
  return fn;
}

// A tensor map is a function of its address, shape and box alone, so one
// keyed by all of them is valid whenever the key matches: a weight's map is
// made once (weights never move), an activation's once per buffer and shape
// (the caching allocator hands the same buffers out again). The cache is
// emptied when it grows past MAP_CACHE entries.
struct MapKey {
  uint64_t ptr, rows, cols;
  uint32_t box_rows, elem_bytes;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && rows == o.rows && cols == o.cols && box_rows == o.box_rows &&
           elem_bytes == o.elem_bytes;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    uint64_t h = k.ptr * 0x9E3779B97F4A7C15ull;
    h ^= (k.rows * 0xC2B2AE3D27D4EB4Full) + (h << 6) + (h >> 2);
    h ^= (k.cols * 0x165667B19E3779F9ull) + (h << 6) + (h >> 2);
    h ^= ((uint64_t)k.box_rows << 8 | k.elem_bytes) + (h << 6) + (h >> 2);
    return (size_t)h;
  }
};
constexpr size_t MAP_CACHE = 4096;

// Row-major [rows, cols] of elem_bytes-byte elements (1: int8, 2: bf16), box
// [box_rows, 128 bytes of columns], 128-byte swizzle, zeros past the edges.
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, uint64_t rows, uint64_t cols,
                       uint32_t box_rows, uint32_t elem_bytes) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  const MapKey key{reinterpret_cast<uint64_t>(ptr), rows, cols, box_rows, elem_bytes};
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return cudaSuccess;
  }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem_bytes};
  const cuuint32_t box[2] = {128 / elem_bytes, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(
      map, elem_bytes == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
      const_cast<void*>(ptr), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
  if (cache.size() >= MAP_CACHE) cache.clear();
  cache.emplace(key, *map);
  return cudaSuccess;
}

// The launch of w8a16_grouped_kernel<BM> over `grid` in clusters of `splits` blocks
// along x (attr is the cluster attribute it points at).
template <int BM>
cudaLaunchConfig_t launch_config(cudaLaunchAttribute* attr, int splits, dim3 grid, cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)splits;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads<BM>());
  cfg.dynamicSmemBytes = smem_bytes<BM>();
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int BM>
cudaError_t launch_grouped(const bf16* x, const int8_t* q, const bf16* scale, bf16* out, int E, int M,
                           int N, int K, int x_per_expert, int splits, cudaStream_t stream) {
  cudaError_t err = raise_smem_limit<&w8a16_grouped_kernel<BM>>(smem_bytes<BM>());
  if (err != cudaSuccess) return err;
  const int m_tiles = (M + BM - 1) / BM;
  if ((long long)E * m_tiles > 65535) return cudaErrorInvalidValue;  // gridDim.z
  CUtensorMap q_map, x_map;
  err = tensor_map(&q_map, q, (uint64_t)E * K, (uint64_t)N, BK, 1);
  if (err != cudaSuccess) return err;
  err = tensor_map(&x_map, x, (uint64_t)(x_per_expert ? E : 1) * M, (uint64_t)K, BM, 2);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const dim3 grid((unsigned)splits, (unsigned)((N + BN - 1) / BN), (unsigned)(E * m_tiles));
  const cudaLaunchConfig_t cfg = launch_config<BM>(&attr, splits, grid, stream);
  err = cudaLaunchKernelEx(&cfg, w8a16_grouped_kernel<BM>, q_map, x_map, scale, out, M, N, K, splits, m_tiles,
                           x_per_expert);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int BM>
int max_clusters(int splits) {
  if (raise_smem_limit<&w8a16_grouped_kernel<BM>>(smem_bytes<BM>()) != cudaSuccess) return -1;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<BM>(&attr, splits, dim3((unsigned)splits), nullptr);
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, w8a16_grouped_kernel<BM>, &cfg) == cudaSuccess ? n : -1;
}

}  // namespace

extern "C" {

// x [M, K] (x_per_expert 0) or [E, M, K] (1) bf16, q [E, K, N] int8, scale
// [E, N] bf16, out [E, M, N] bf16, all contiguous and 16-byte aligned;
// block_m and splits as above, E * ceil(M / block_m) <= 65535. One launch.
// Returns a cudaError_t.
int atpu_w8a16_grouped_matmul(const void* x, const void* q, const void* scale, void* out, int E, int M,
                              int N, int K, int x_per_expert, int block_m, int splits, void* stream) {
  if (E <= 0 || M < 0 || N <= 0 || K <= 0 || K % BK != 0 || N % 16 != 0) return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > MAX_SPLITS || splits > K / BK) return (int)cudaErrorInvalidValue;
  if (x_per_expert != 0 && x_per_expert != 1) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const int8_t* qb = static_cast<const int8_t*>(q);
  const bf16* sb = static_cast<const bf16*>(scale);
  bf16* ob = static_cast<bf16*>(out);
  switch (block_m) {
    case 8: return (int)launch_grouped<8>(xb, qb, sb, ob, E, M, N, K, x_per_expert, splits, s);
    case 24: return (int)launch_grouped<24>(xb, qb, sb, ob, E, M, N, K, x_per_expert, splits, s);
    case 40: return (int)launch_grouped<40>(xb, qb, sb, ob, E, M, N, K, x_per_expert, splits, s);
    case 72: return (int)launch_grouped<72>(xb, qb, sb, ob, E, M, N, K, x_per_expert, splits, s);
    case 128: return (int)launch_grouped<128>(xb, qb, sb, ob, E, M, N, K, x_per_expert, splits, s);
    case 256: return (int)launch_grouped<256>(xb, qb, sb, ob, E, M, N, K, x_per_expert, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x [M, K] bf16, q [K, N] int8, scale [N] bf16, out [M, N] bf16, all
// contiguous and 16-byte aligned. block_m is 8, 24, 40, 72, 128 or 256;
// K % 64 == 0, N % 16 == 0, 1 <= splits <= min(8, K / 64). One launch.
// Returns a cudaError_t. The grouped product at E = 1 with a shared x.
int atpu_w8a16_matmul(const void* x, const void* q, const void* scale, void* out, int M, int N,
                      int K, int block_m, int splits, void* stream) {
  return atpu_w8a16_grouped_matmul(x, q, scale, out, 1, M, N, K, 0, block_m, splits, stream);
}

// Clusters of `splits` blocks of the block_m body that the current device
// runs at once (cudaOccupancyMaxActiveClusters), or -1: what the wrapper's
// CLUSTERS_PER_WAVE assumes of an H100.
int atpu_w8a16_max_clusters(int block_m, int splits) {
  if (splits < 1 || splits > MAX_SPLITS) return -1;
  switch (block_m) {
    case 8: return max_clusters<8>(splits);
    case 24: return max_clusters<24>(splits);
    case 40: return max_clusters<40>(splits);
    case 72: return max_clusters<72>(splits);
    case 128: return max_clusters<128>(splits);
    case 256: return max_clusters<256>(splits);
    default: return -1;
  }
}

}  // extern "C"
