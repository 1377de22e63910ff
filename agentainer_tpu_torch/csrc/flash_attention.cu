// Flash attention over the KV arena, hand-written for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of agentainer_tpu/ops/pallas_attention.py:
//   flash_prefill              (body _prefill_kernel)        -> atpu_flash_prefill
//   flash_decode               (body _decode_kernel)         -> atpu_flash_decode
//   fused_paged_flash_prefill  (body _paged_prefill_kernel)  -> atpu_paged_flash_prefill
//   fused_paged_flash_decode   (body _paged_decode_kernel)   -> atpu_paged_flash_decode
//
// All four compute what the TPU kernels compute, with the same rules:
//   - query row at position pos sees arena slot j iff j <= pos and j < S;
//   - the G = H / KV query heads of a group share every staged K/V tile
//     (K/V is read once per kv head, never repeated per query head);
//   - online softmax with f32 (m, l, acc) and scale 1/sqrt(hd);
//   - finite NEG_INF = -1e30; masked scores contribute p = 0;
//   - KV tiles wholly past the block's largest position are never loaded;
//   - slots past S are zero-filled when a tile straddles the arena end;
//   - a row with l == 0 (no visible slot: pos < 0) divides by 1 -> zeros;
//   - inputs bf16 or f32, f32 accumulation, output in q's dtype.
//
// One kernel body, two addressing policies. The paged kernels compute the
// dense kernels' function; only the address of slot j changes:
//   DenseArena: k[b, j, h, :]                      (arena [B, S, KV, hd])
//   PagedArena: pool[table[b, j / ps], j % ps, h, :] (pool [P, ps, KV, hd],
//               table [B, n_blocks] int32, S = n_blocks * ps)
// prefill_kernel and decode_kernel are templated on the policy, so the tile
// loop, the GQA packing and the masking exist once, and on the same K/V
// values the paged and dense kernels are bit-identical (the served paged
// path's greedy text equals the dense path's). A paged block stages its
// lane's table row in shared memory once and looks the page up for every
// 16-byte load, so any page size works and, unlike the reference, no
// page-size gate sends a pool through a gathered dense view; at the default
// page_size of 64 each 64-slot K/V tile is exactly one page. Page ids are
// arbitrary and lanes may share pages.
//
// Layout: q [B, T, H, hd], the arena k/v [B, S, KV, hd] and the pools
// [P, ps, KV, hd] are read IN PLACE through their strides (element strides
// for every axis but head_dim, which must be contiguous). The JAX wrapper
// transposes q to head-major before its pallas_call; on the TPU that is an
// XLA copy, and this kernel has no need for it. head_dim is fixed at 128,
// the only size kernel_supported admits; the wrapper raises for anything
// else.
//
// What bounds each kernel on an H100 SXM (989 TFLOP/s bf16 dense on the
// tensor cores, 67 TFLOP/s f32 outside them, 3.35 TB/s HBM) and what the
// design does about it:
//   - decode reads every live K/V byte once per step and does ~1 FLOP per
//     byte per query head: it is bounded by the BYTES of live K/V, so what
//     matters is how many bytes are in flight across the card. The KV axis
//     is split across blocks: grid (KV, B, n_split), split s covers slots
//     [s*L, (s+1)*L) (L = split_len, a multiple of the 64-slot tile, 256 by
//     default); a split past min(pos, S - 1) exits at once. n_split =
//     ceil(S / L) is fixed on the host from S alone (the positions live on
//     the device). At llama3-8b's B = 8, KV = 8 that is up to 512 blocks of
//     at most 4 tiles, not 64 blocks of up to 32. Each block streams its
//     tiles as they are stored (bf16 or f32) into a 3-stage shared-memory
//     ring with 16-byte cp.async copies (the page lookup of the paged
//     arena just feeds their addresses) and widens at use. Each of its 8
//     warps owns 8 slots of a tile and keeps its own online softmax in
//     registers (four lanes per slot for the scores, one lane per 4
//     head_dim columns for P.V), so a tile costs one __syncthreads. The
//     warps merge in fixed order and the block writes its partial
//     (acc[hd], m, l) in f32 to scratch [B, H, n_split, hd + 2]; a second
//     small kernel merges the live splits per (lane, head) in fixed split
//     order and writes q's dtype; it is launched as a programmatic
//     dependent, so its launch and prologue overlap the split kernel's
//     tail. No atomics: the result is the same bits run to run, and the
//     same bits for both arena policies.
//     What holds it above its bound now is the bytes each SM keeps in
//     flight through 16-byte cp.async and the fixed cost of two launches
//     (measured in PERF.md); bulk copies of 256-byte rows were slower.
//   - prefill does ~T FLOPs per K/V byte: at a 256-token chunk it is
//     bounded by its FLOPs. The bf16 body runs both products on the tensor
//     cores (mma.sync m16n8k16, bf16 in, f32 accumulate) on the
//     FlashAttention-2 pattern: 4 warps x 16 rows, Q fragments in
//     registers, K/V tiles as bf16 in a cp.async ring (rows padded by 16
//     bytes so ldmatrix is conflict-free; .trans for V), S = QK^T and the
//     online softmax in f32 registers with quad shuffles (exp2), P rounded
//     to bf16 in registers as the A operand of P.V. A served chunk gives
//     fewer blocks than SMs, so each block runs two such warp groups on
//     alternate tiles (8 warps, each tile double-buffered: 157 KB of shared
//     memory) and merges them at the end in fixed order. mma.sync and
//     cp.async rather than wgmma and TMA because the paged instance takes
//     any page size: a TMA box cannot cross a page, a cp.async takes the
//     per-16-byte lookup.
//     The f32 body stays on the CUDA cores (TF32 would break the f32
//     parity the tests hold): 64x64 score tile per block from shared
//     memory, 4x8 register micro-tile per thread.
//
// Plain C interface, loaded with ctypes. Every function launches on the
// caller's stream, allocates nothing (the decode partials go to scratch the
// caller passes in) and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int HD = 128;           // head_dim
constexpr int KS = HD + 4;        // padded shared-memory row stride (floats), f32 prefill
constexpr float NEG_INF = -1e30f;
constexpr size_t MAX_SMEM = 232448;  // dynamic shared memory a block may use on sm_90
constexpr unsigned FULL = 0xffffffffu;

// K/V rows staged as stored, padded by 16 bytes: rows of one 8-row group
// start 4 banks apart, so 16-byte row reads (and ldmatrix) are conflict-free.
template <typename T>
constexpr int kRow = HD + 16 / (int)sizeof(T);

// ---- 16-byte vector loads of one dtype, widened to f32 ---------------------

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;  // elements per 16-byte load
  __device__ static void load(const float* p, float* dst) {
    float4 x = *reinterpret_cast<const float4*>(p);
    dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
  }
  __device__ static void widen(uint4 r, float* dst) {
    dst[0] = __uint_as_float(r.x); dst[1] = __uint_as_float(r.y);
    dst[2] = __uint_as_float(r.z); dst[3] = __uint_as_float(r.w);
  }
  __device__ static void load4(const float* p, float* dst) { load(p, dst); }
  __device__ static void store4(float* p, const float* src) {
    *reinterpret_cast<float4*>(p) = make_float4(src[0], src[1], src[2], src[3]);
  }
  __device__ static float cvt(float x) { return x; }
};

template <>
struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ static void widen(uint4 r, float* dst) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
      float2 f = __bfloat1622float2(h);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
  __device__ static void load(const bf16* p, float* dst) {
    widen(*reinterpret_cast<const uint4*>(p), dst);
  }
  __device__ static void load4(const bf16* p, float* dst) {  // 4 elements, 8 bytes
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
    dst[0] = a.x; dst[1] = a.y; dst[2] = b.x; dst[3] = b.y;
  }
  __device__ static void store4(bf16* p, const float* src) {
    __nv_bfloat162 a = __floats2bfloat162_rn(src[0], src[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(src[2], src[3]);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&a);
    u.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  }
  __device__ static bf16 cvt(float x) { return __float2bfloat16(x); }
};

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// ---- asynchronous copies and tensor-core fragments (sm_80+ PTX) ------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without passing through registers; bytes = 0
// writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {  // at most N groups still in flight
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
// d += a (16x16 bf16, row-major) * b (16x8 bf16, col-major), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---- where slot j of (lane b, kv head h) lives ------------------------------
//
// A policy is passed to the kernel by value. ``stage`` copies what the block
// needs of the lane's addressing into shared memory (the paged table row);
// ``lane`` binds (b, h) and returns an accessor whose krow(j) / vrow(j) give
// the first element of slot j's head_dim row.

template <typename T>
struct DenseArena {
  const T* k;
  const T* v;
  long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;

  struct Lane {
    const T* k;
    const T* v;
    long long k_ss, v_ss;
    __device__ const T* krow(int j) const { return k + j * k_ss; }
    __device__ const T* vrow(int j) const { return v + j * v_ss; }
  };
  __host__ __device__ int table_len() const { return 0; }
  __device__ void stage(int, int*, int, int) const {}
  __device__ Lane lane(int b, int h, const int*) const {
    return {k + b * k_sb + h * k_sh, v + b * v_sb + h * v_sh, k_ss, v_ss};
  }
};

template <typename T>
struct PagedArena {
  const T* k;         // pool [P, ps, KV, hd]
  const T* v;
  const int* table;   // [B, n_blocks] physical page ids
  long long t_sb;
  int ps, n_blocks;
  long long k_sp, k_sr, k_sh, v_sp, v_sr, v_sh;

  struct Lane {
    const T* k;
    const T* v;
    const int* tbl;   // the lane's table row, in shared memory
    int ps;
    long long k_sp, k_sr, v_sp, v_sr;
    __device__ const T* krow(int j) const {
      const int blk = j / ps;
      return k + tbl[blk] * k_sp + (j - blk * ps) * k_sr;
    }
    __device__ const T* vrow(int j) const {
      const int blk = j / ps;
      return v + tbl[blk] * v_sp + (j - blk * ps) * v_sr;
    }
  };
  __host__ __device__ int table_len() const { return n_blocks; }
  __device__ void stage(int b, int* tbl_s, int tid, int nthreads) const {
    for (int i = tid; i < n_blocks; i += nthreads) tbl_s[i] = table[b * t_sb + i];
  }
  __device__ Lane lane(int, int h, const int* tbl_s) const {
    return {k + h * k_sh, v + h * v_sh, tbl_s, ps, k_sp, k_sr, v_sp, v_sr};
  }
};

// Issue the cp.async copies of slots [k0, k0 + ROWS) of a lane's K and V into
// shared tiles of row stride kRow<T>; slots at or past S are zero-filled (the
// TPU kernel zeroes V there). The caller commits the group.
template <typename T, int ROWS, int NTHREADS, typename Lane>
__device__ __forceinline__ void stage_kv(const Lane& lane, int k0, int S, T* k_s, T* v_s,
                                         int tid) {
  constexpr int CPR = HD * (int)sizeof(T) / 16;  // 16-byte chunks per row
  constexpr int EPC = 16 / (int)sizeof(T);       // elements per chunk
  static_assert(ROWS * CPR % NTHREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int u = 0; u < ROWS * CPR / NTHREADS; ++u) {
    const int idx = tid + u * NTHREADS;
    const int j = idx / CPR, c = (idx % CPR) * EPC;
    const int key = k0 + j;
    const bool in = key < S;
    const int src = in ? key : 0;  // any valid address; nothing is read
    cp_async16(k_s + j * kRow<T> + c, lane.krow(src) + c, in ? 16 : 0);
    cp_async16(v_s + j * kRow<T> + c, lane.vrow(src) + c, in ? 16 : 0);
  }
}

// ---- prefill --------------------------------------------------------------
//
// Grid (ceil(T / (BM / G)), KV, B). A block owns BM = 64 query rows: BM / G
// consecutive tokens x the G heads of one kv head, and walks the K/V tiles
// [0, BK), [BK, 2BK), ... up to the largest position among its rows. Rows
// past T get position -1 (no visible slot).

constexpr int PF_BM = 64;
constexpr int PF_BK = 64;
constexpr float LOG2E = 1.4426950408889634f;

// bf16 body (tensor cores), 256 threads: two warp groups of 4 warps; group
// i computes tiles i, i + 2, i + 4, ... with its own online softmax, so two
// warps share each scheduler, and the groups merge at the end in fixed order.
// Warp w of a group owns rows 16w .. 16w + 15. Fragment layouts are those of
// mma.m16n8k16: thread (g, t) = (lane / 4, lane % 4) holds rows g and g + 8,
// columns 2t, 2t + 1 of each 8-column accumulator. Scores are kept in log2
// units (scale * log2 e) so that the softmax runs on exp2.
constexpr int PF_GROUPS = 2;
constexpr int PF_MMA_THREADS = 128 * PF_GROUPS;
constexpr int PF_STAGES = 2 * PF_GROUPS;  // each group's tile double-buffered
constexpr int PF_RS = kRow<bf16>;
constexpr size_t PF_MMA_SMEM =
    sizeof(bf16) * (size_t)(PF_BM * PF_RS + 2 * PF_STAGES * PF_BK * PF_RS) + sizeof(int) * PF_BM;
constexpr int PF_MERGE = HD / 2 + 4;  // floats group 1 hands over per thread: o, m[2], l[2]
static_assert(sizeof(float) * PF_MERGE * 128 <= sizeof(bf16) * 2 * PF_STAGES * PF_BK * PF_RS,
              "the merge reuses the ring");

template <typename Arena>
__device__ __forceinline__ void prefill_mma(
    unsigned char* smem, const bf16* __restrict__ q, const Arena& arena,
    const int* __restrict__ pos, bf16* __restrict__ out, int T_len, int S, int G, long long q_sb,
    long long q_st, long long q_sh, long long p_sb, long long p_st, long long o_sb, long long o_st,
    long long o_sh, float scale) {
  constexpr int NT = PF_MMA_THREADS;
  bf16* q_s = reinterpret_cast<bf16*>(smem);          // [BM][RS]
  bf16* k_s = q_s + PF_BM * PF_RS;                    // [STAGES][BK][RS]
  bf16* v_s = k_s + PF_STAGES * PF_BK * PF_RS;        // [STAGES][BK][RS]
  int* pos_s = reinterpret_cast<int*>(v_s + PF_STAGES * PF_BK * PF_RS);  // [BM]
  int* tbl_s = pos_s + PF_BM;                         // [table_len] (paged only)

  const int tid = threadIdx.x, warp = tid / 32, lid = tid % 32;
  const int wg = warp / 4, wr = warp % 4;  // warp group, row block
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * (PF_BM / G);

  // the q tile, as stored (rows past T zero-filled); positions; table row
#pragma unroll
  for (int u = 0; u < PF_BM * 16 / NT; ++u) {
    const int idx = tid + u * NT;
    const int r = idx / 16, c = (idx % 16) * 8;
    const int t = t0 + r / G, h = kvh * G + r % G;
    const bool in = t < T_len;
    cp_async16(q_s + r * PF_RS + c, q + b * q_sb + (in ? t : 0) * q_st + h * q_sh + c, in ? 16 : 0);
  }
  for (int r = tid; r < PF_BM; r += NT) {
    const int t = t0 + r / G;
    pos_s[r] = t < T_len ? pos[b * p_sb + t * p_st] : -1;
  }
  arena.stage(b, tbl_s, tid, NT);
  __syncthreads();  // positions, and the table row the K/V copies read
  const auto lane = arena.lane(b, kvh, tbl_s);

  // the block's and this warp's last visible slot: tiles past them are never
  // loaded (block) or computed (warp: a wholly masked tile leaves m, l, o
  // unchanged, so skipping it is exact)
  int kmax = -1, wmax = -1;
  for (int r = 0; r < PF_BM; ++r) {
    const int lastr = min(pos_s[r], S - 1);
    kmax = max(kmax, lastr);
    if (r / 16 == wr) wmax = max(wmax, lastr);
  }
  const int n_tiles = kmax < 0 ? 0 : kmax / PF_BK + 1;
  const int n_steps = (n_tiles + PF_GROUPS - 1) / PF_GROUPS;
  auto stage_step = [&](int step) {  // tiles of one step, one per group
#pragma unroll
    for (int grp = 0; grp < PF_GROUPS; ++grp) {
      const int tile = step * PF_GROUPS + grp;
      const int st = (step % 2) * PF_GROUPS + grp;
      if (tile < n_tiles)
        stage_kv<bf16, PF_BK, NT>(lane, tile * PF_BK, S, k_s + st * PF_BK * PF_RS,
                                  v_s + st * PF_BK * PF_RS, tid);
    }
  };
  stage_step(0);
  cp_async_commit();  // group 0: q and the first step's tiles

  const int g = lid / 4, t4 = lid % 4;
  const int prow[2] = {pos_s[wr * 16 + g], pos_s[wr * 16 + g + 8]};
  const float sl2 = scale * LOG2E;
  uint32_t qf[HD / 16][4];  // A fragments of the warp's 16 q rows, 8 k-steps of 16
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[HD / 8][4];
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    // the half of the ring refilled here was read in step - 1, before its
    // closing sync
    if (step + 1 < n_steps) stage_step(step + 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the copies just issued has landed
    __syncthreads();
    if (step == 0) {
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
        ldsm_x4(qf[ks], q_s + (wr * 16 + (lid % 8) + ((lid / 8) % 2) * 8) * PF_RS + ks * 16 +
                            (lid / 16) * 8);
    }
    const int tile = step * PF_GROUPS + wg;
    const int k0 = tile * PF_BK;
    if (tile < n_tiles && k0 <= wmax) {
      const int st = (step % 2) * PF_GROUPS + wg;
      const bf16* kt = k_s + st * PF_BK * PF_RS;
      const bf16* vt = v_s + st * PF_BK * PF_RS;

      // S = Q K^T: 16 rows x 64 slots per warp, 8 accumulators of 16x8
      float s[PF_BK / 8][4];
#pragma unroll
      for (int nt = 0; nt < PF_BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ks += 2) {
#pragma unroll
        for (int nt = 0; nt < PF_BK / 8; ++nt) {
          uint32_t kb[4];  // B fragments of slots 8nt.. for k-steps ks and ks + 1
          ldsm_x4(kb, kt + (nt * 8 + lid % 8) * PF_RS + ks * 16 + (lid / 8) * 8);
          mma_bf16(s[nt], qf[ks], kb[0], kb[1]);
          mma_bf16(s[nt], qf[ks + 1], kb[2], kb[3]);
        }
      }

      // online softmax over the tile; a row's 4 threads are one quad
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int nt = 0; nt < PF_BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + nt * 8 + 2 * t4 + (e & 1);
          const bool valid = key <= prow[e >> 1] && key < S;
          s[nt][e] = valid ? s[nt][e] * sl2 : NEG_INF;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < PF_BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // a masked score is NEG_INF: exp2 of it less a finite m is 0; a
          // row that sees nothing yet has m = NEG_INF and is zeroed here
          const float p = m[e >> 1] == NEG_INF ? 0.f : exp2f(s[nt][e] - m[e >> 1]);
          sum[e >> 1] += p;
          s[nt][e] = p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];  // this thread's columns
#pragma unroll
      for (int dn = 0; dn < HD / 8; ++dn) {
        o[dn][0] *= alpha[0];
        o[dn][1] *= alpha[0];
        o[dn][2] *= alpha[1];
        o[dn][3] *= alpha[1];
      }

      // O += P V: P (bf16) is the A operand straight from the S accumulators
#pragma unroll
      for (int kk = 0; kk < PF_BK / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dn = 0; dn < HD / 8; dn += 2) {
          uint32_t vb[4];  // B fragments of columns 8dn.. and 8dn + 8..
          ldsm_x4_trans(vb, vt + (kk * 16 + lid % 8 + ((lid / 8) % 2) * 8) * PF_RS + dn * 8 +
                                (lid / 16) * 8);
          mma_bf16(o[dn], pa, vb[0], vb[1]);
          mma_bf16(o[dn + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this step's stages before they are refilled
  }
  cp_async_wait<0>();
  __syncthreads();

  // group 1 hands (o, m, l) to the thread of group 0 that holds the same rows
  // and columns, through the idle ring ([value][thread]: conflict-free)
  float* xch = reinterpret_cast<float*>(k_s);
  const int slot = wr * 32 + lid;
  if (wg == 1) {
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) xch[(dn * 4 + e) * 128 + slot] = o[dn][e];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      xch[(HD / 2 + r) * 128 + slot] = m[r];
      xch[(HD / 2 + 2 + r) * 128 + slot] = l[r];
    }
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = xch[(HD / 2 + r) * 128 + slot], l1 = xch[(HD / 2 + 2 + r) * 128 + slot];
    const float mm = fmaxf(m[r], m1);
    const float f0 = exp2f(m[r] - mm), f1 = exp2f(m1 - mm);
    l[r] = l[r] * f0 + l1 * f1;
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e)
        o[dn][e] = o[dn][e] * f0 + xch[(dn * 4 + e) * 128 + slot] * f1;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r] + __shfl_xor_sync(FULL, l[r], 1);
    lr += __shfl_xor_sync(FULL, lr, 2);
    const int row = wr * 16 + g + 8 * r;
    const int t = t0 + row / G, h = kvh * G + row % G;
    if (t >= T_len) continue;
    const float inv = 1.f / (lr == 0.f ? 1.f : lr);
    bf16* orow = out + b * o_sb + t * o_st + h * o_sh + 2 * t4;
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn)
      *reinterpret_cast<uint32_t*>(orow + dn * 8) =
          pack_bf16(o[dn][2 * r] * inv, o[dn][2 * r + 1] * inv);
  }
}

// f32 body (CUDA cores), 128 threads. Thread (rb, cb) = (tid / 8, tid % 8)
// holds score rows rb*4..rb*4+3 x key columns cb + 8*jj, and output rows
// rb*4.. x head_dim columns cb*4 + 32*q .. +3 — both mappings read shared
// memory without bank conflicts (the padded stride KS puts consecutive rows
// 4 banks apart).
constexpr int PF_THREADS = 128;
constexpr int PF_PS = PF_BK + 1;
constexpr size_t PF_SMEM =
    sizeof(float) * (size_t)(PF_BM * KS + 2 * PF_BK * KS + PF_BM * PF_PS) + sizeof(int) * PF_BM;

template <typename T, typename Arena>
__device__ __forceinline__ void prefill_simt(
    unsigned char* smem_raw, const T* __restrict__ q, const Arena& arena,
    const int* __restrict__ pos, T* __restrict__ out, int T_len, int S, int G, long long q_sb,
    long long q_st, long long q_sh, long long p_sb, long long p_st, long long o_sb, long long o_st,
    long long o_sh, float scale) {
  float* smem = reinterpret_cast<float*>(smem_raw);
  float* q_s = smem;                  // [BM][KS]
  float* k_s = q_s + PF_BM * KS;      // [BK][KS]
  float* v_s = k_s + PF_BK * KS;      // [BK][KS]
  float* p_s = v_s + PF_BK * KS;      // [BM][PS]
  int* pos_s = reinterpret_cast<int*>(p_s + PF_BM * PF_PS);  // [BM]
  int* tbl_s = pos_s + PF_BM;         // [table_len] (paged only)

  constexpr int VN = Vec<T>::N;
  constexpr int VPR = HD / VN;  // vectors per row
  const int tid = threadIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tok_per_block = PF_BM / G;
  const int t0 = blockIdx.x * tok_per_block;

  // stage the q tile (f32) and each row's position; rows past T get pos -1
  for (int idx = tid; idx < PF_BM * VPR; idx += PF_THREADS) {
    const int r = idx / VPR, c = (idx % VPR) * VN;
    const int t = t0 + r / G, h = kvh * G + r % G;
    float buf[VN];
    if (t < T_len) {
      Vec<T>::load(q + b * q_sb + t * q_st + h * q_sh + c, buf);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) buf[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) q_s[r * KS + c + e] = buf[e];
  }
  for (int r = tid; r < PF_BM; r += PF_THREADS) {
    const int t = t0 + r / G;
    pos_s[r] = t < T_len ? pos[b * p_sb + t * p_st] : -1;
  }
  arena.stage(b, tbl_s, tid, PF_THREADS);
  __syncthreads();
  const auto lane = arena.lane(b, kvh, tbl_s);

  // the block's last visible slot: tiles past it are never loaded
  int kmax = -1;
  for (int r = 0; r < PF_BM; ++r) kmax = max(kmax, min(pos_s[r], S - 1));
  const int n_tiles = kmax < 0 ? 0 : kmax / PF_BK + 1;

  const int rb = tid / 8, cb = tid % 8;
  int prow[4];
  float m[4], l[4], acc[4][16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    prow[i] = pos_s[rb * 4 + i];
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[i][e] = 0.f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * PF_BK;
    __syncthreads();  // the previous tile's readers are done with k_s/v_s/p_s
    for (int idx = tid; idx < PF_BK * VPR; idx += PF_THREADS) {
      const int j = idx / VPR, c = (idx % VPR) * VN;
      const int key = k0 + j;
      float kb[VN], vb[VN];
      if (key < S) {
        Vec<T>::load(lane.krow(key) + c, kb);
        Vec<T>::load(lane.vrow(key) + c, vb);
      } else {  // past the arena: zero, as the TPU kernel zeroes V there
#pragma unroll
        for (int e = 0; e < VN; ++e) kb[e] = vb[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        k_s[j * KS + c + e] = kb[e];
        v_s[j * KS + c + e] = vb[e];
      }
    }
    __syncthreads();

    // scores: 4 rows x 8 keys per thread
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&q_s[(rb * 4 + i) * KS + d]);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        kv[jj] = *reinterpret_cast<const float4*>(&k_s[(cb + 8 * jj) * KS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) s[i][jj] += dot4(qv[i], kv[jj]);
    }

    // online softmax; the 8 threads sharing a row are lanes 8*k .. 8*k+7
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
      bool valid[8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int key = k0 + cb + 8 * jj;
        valid[jj] = key <= prow[i] && key < S;
        s[i][jj] = valid[jj] ? s[i][jj] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][jj]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float p = valid[jj] ? expf(s[i][jj] - m_new) : 0.f;
        sum += p;
        p_s[(rb * 4 + i) * PF_PS + cb + 8 * jj] = p;
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(FULL, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();

    // acc += P · V over the tile
#pragma unroll 2
    for (int j = 0; j < PF_BK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = p_s[(rb * 4 + i) * PF_PS + j];
#pragma unroll
      for (int qd = 0; qd < 4; ++qd) {
        const float4 vv = *reinterpret_cast<const float4*>(&v_s[j * KS + cb * 4 + 32 * qd]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][qd * 4 + 0] += p[i] * vv.x;
          acc[i][qd * 4 + 1] += p[i] * vv.y;
          acc[i][qd * 4 + 2] += p[i] * vv.z;
          acc[i][qd * 4 + 3] += p[i] * vv.w;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rb * 4 + i;
    const int t = t0 + r / G, h = kvh * G + r % G;
    if (t >= T_len) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    T* o = out + b * o_sb + t * o_st + h * o_sh;
#pragma unroll
    for (int qd = 0; qd < 4; ++qd) {
      float w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) w[e] = acc[i][qd * 4 + e] * inv;
      Vec<T>::store4(o + cb * 4 + 32 * qd, w);
    }
  }
}

template <typename T>
constexpr size_t prefill_smem() {
  return std::is_same<T, bf16>::value ? PF_MMA_SMEM : PF_SMEM;
}
template <typename T>
constexpr int prefill_threads() {
  return std::is_same<T, bf16>::value ? PF_MMA_THREADS : PF_THREADS;
}

template <typename T, typename Arena>
__global__ void __launch_bounds__(prefill_threads<T>()) prefill_kernel(
    const T* __restrict__ q, const Arena arena, const int* __restrict__ pos,
    T* __restrict__ out, int T_len, int S, int G, long long q_sb, long long q_st,
    long long q_sh, long long p_sb, long long p_st, long long o_sb, long long o_st,
    long long o_sh, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (std::is_same<T, bf16>::value)
    prefill_mma(smem, q, arena, pos, out, T_len, S, G, q_sb, q_st, q_sh, p_sb, p_st, o_sb, o_st,
                o_sh, scale);
  else
    prefill_simt(smem, q, arena, pos, out, T_len, S, G, q_sb, q_st, q_sh, p_sb, p_st, o_sb, o_st,
                 o_sh, scale);
}

// ---- decode ---------------------------------------------------------------
//
// Split kernel: grid (KV, B, n_split), 256 threads = 8 warps. Block (kvh, b,
// s) handles the G query heads of kv head kvh against slots [s*L, (s+1)*L) of
// lane b, up to min(pos, S - 1), in tiles of 64 slots through a 3-stage
// cp.async ring. Warp w owns slots 8w .. 8w + 7 of every tile and keeps its
// own (m, l, acc) per head: scores with four lanes per slot (lane = 8 * part
// + slot, each a quarter of head_dim), then the warp's online softmax with
// shuffles, then P.V with lane i owning head_dim columns 4i .. 4i + 3. Scores
// are kept in log2 units (scale * log2 e) so that the softmax runs on exp2.
// The warps merge in order 0..7 and the block writes f32 (acc[hd], m, l) for
// each head to part[b, h, s, :].
//
// Combine kernel: grid (H, B), 128 threads (one per head_dim column):
// merges splits 0 .. n_live - 1 of (b, h) in that order and writes q's dtype.

constexpr int DC_THREADS = 256;
constexpr int DC_WARPS = DC_THREADS / 32;
constexpr int DC_BK = 64;
constexpr int DC_KPW = DC_BK / DC_WARPS;   // slots per warp per tile
constexpr int DC_PARTS = 32 / DC_KPW;       // lanes per slot
constexpr int DC_PD = HD / DC_PARTS;        // head_dim columns per lane for the scores
constexpr int DC_QP = DC_PD + 4;            // q part stride (floats): parts 4 banks apart
constexpr int DC_QS = DC_PARTS * DC_QP;     // q row stride (floats)
constexpr int DC_STAGES = 3;
constexpr int PART = HD + 2;                // floats per (b, h, split): acc[hd], m, l
static_assert(DC_KPW % 4 == 0 && DC_PARTS * DC_KPW == 32, "whole float4 p reads, one warp per 32 lanes");

template <typename T, int G>
constexpr size_t decode_smem() {
  return sizeof(T) * (size_t)(2 * DC_STAGES * DC_BK * kRow<T>) +
         sizeof(float) * (size_t)(G * DC_QS + DC_WARPS * G * DC_KPW);
}

template <typename T, int G, typename Arena>
__global__ void __launch_bounds__(DC_THREADS) decode_kernel(
    const T* __restrict__ q, const Arena arena, const int* __restrict__ pos,
    float* __restrict__ part, int S, int split_len, long long q_sb, long long q_sh,
    long long p_sb, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int RS = kRow<T>;
  T* k_s = reinterpret_cast<T*>(smem);                                   // [STAGES][BK][RS]
  T* v_s = k_s + DC_STAGES * DC_BK * RS;                                 // [STAGES][BK][RS]
  float* q_s = reinterpret_cast<float*>(v_s + DC_STAGES * DC_BK * RS);   // [G][QS]
  float* p_s = q_s + G * DC_QS;                                          // [WARPS][G][KPW]
  int* tbl_s = reinterpret_cast<int*>(p_s + DC_WARPS * G * DC_KPW);     // [table_len]
  static_assert(sizeof(float) * DC_WARPS * G * (HD + 2) <= sizeof(T) * 2 * DC_STAGES * DC_BK * RS,
                "the merge reuses the ring");

  constexpr int VN = Vec<T>::N;
  constexpr int VPR = HD / VN;
  const int tid = threadIdx.x, warp = tid / 32, lid = tid % 32;
  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");  // the combine may start
  const int p = pos[b * p_sb];
  // q, loaded before the position is known: both loads are in flight at once
  constexpr int QPT = (G * VPR + DC_THREADS - 1) / DC_THREADS;  // q vectors per thread
  uint4 qr[QPT];
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int idx = tid + u * DC_THREADS;
    if (idx < G * VPR)
      qr[u] = *reinterpret_cast<const uint4*>(q + b * q_sb + (kvh * G + idx / VPR) * q_sh +
                                              (idx % VPR) * VN);
  }
  const int last = min(p, S - 1);
  const int k_begin = split * split_len;
  if (k_begin > last) return;  // past the lane's position (every split when pos < 0)
  const int n_tiles = (min(k_begin + split_len, last + 1) - k_begin + DC_BK - 1) / DC_BK;

#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int idx = tid + u * DC_THREADS;
    if (idx < G * VPR) {
      const int g = idx / VPR, c = (idx % VPR) * VN;
      float buf[VN];
      Vec<T>::widen(qr[u], buf);
#pragma unroll
      for (int e = 0; e < VN; ++e) q_s[g * DC_QS + (c / DC_PD) * DC_QP + c % DC_PD + e] = buf[e];
    }
  }
  arena.stage(b, tbl_s, tid, DC_THREADS);
  __syncthreads();  // q, and the table row the copies read
  const auto lane = arena.lane(b, kvh, tbl_s);

  auto fill = [&](int tile) {  // one group of copies per tile
    const int st = tile % DC_STAGES;
    stage_kv<T, DC_BK, DC_THREADS>(lane, k_begin + tile * DC_BK, S, k_s + st * DC_BK * RS,
                                   v_s + st * DC_BK * RS, tid);
  };
#pragma unroll
  for (int st = 0; st < DC_STAGES - 1; ++st) {
    if (st < n_tiles) fill(st);
    cp_async_commit();
  }

  const int qpart = lid / DC_KPW, jw = lid % DC_KPW;
  const int jrow = warp * DC_KPW + jw;  // the slot of the tile this lane scores
  const float* qp = q_s + qpart * DC_QP;
  float* pw = p_s + warp * G * DC_KPW;
  const float sl2 = scale * LOG2E;
  float m[G], l[G], acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<DC_STAGES - 2>();  // this tile's copies have landed
    __syncthreads();                 // for every thread; and tile - 1's stage is free
    if (tile + DC_STAGES - 1 < n_tiles) fill(tile + DC_STAGES - 1);
    cp_async_commit();
    const int k0 = k_begin + tile * DC_BK;
    const T* kt = k_s + (tile % DC_STAGES) * DC_BK * RS;
    const T* vt = v_s + (tile % DC_STAGES) * DC_BK * RS;

    // this lane's part of slot k0 + jrow against the G heads
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    const T* kr = kt + jrow * RS + qpart * DC_PD;
#pragma unroll
    for (int c = 0; c < DC_PD; c += VN) {
      float kf[VN];
      Vec<T>::widen(*reinterpret_cast<const uint4*>(kr + c), kf);
#pragma unroll
      for (int e = 0; e < VN; e += 4) {
        const float4 kv = make_float4(kf[e], kf[e + 1], kf[e + 2], kf[e + 3]);
#pragma unroll
        for (int g = 0; g < G; ++g)
          s[g] += dot4(*reinterpret_cast<const float4*>(qp + g * DC_QS + c + e), kv);
      }
    }
    const bool valid = k0 + jrow <= last;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float sg = s[g];
#pragma unroll
      for (int o = DC_KPW; o < 32; o <<= 1) sg += __shfl_xor_sync(FULL, sg, o);
      sg = valid ? sg * sl2 : NEG_INF;
      float mx = sg;
#pragma unroll
      for (int o = DC_KPW / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_new = fmaxf(m[g], mx);
      const float alpha = exp2f(m[g] - m_new);
      const float p = valid ? exp2f(sg - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = DC_KPW / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
      l[g] = l[g] * alpha + sum;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] *= alpha;
      if (qpart == 0) pw[g * DC_KPW + jw] = p;
    }
    __syncwarp();

    // acc += P.V over the warp's slots; lane owns columns 4*lid .. 4*lid + 3
#pragma unroll
    for (int j = 0; j < DC_KPW; j += 4) {
      float4 pg[G];
#pragma unroll
      for (int g = 0; g < G; ++g) pg[g] = *reinterpret_cast<const float4*>(pw + g * DC_KPW + j);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vf[4];
        Vec<T>::load4(vt + (warp * DC_KPW + j + u) * RS + 4 * lid, vf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pu = u == 0 ? pg[g].x : u == 1 ? pg[g].y : u == 2 ? pg[g].z : pg[g].w;
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[g][e] += pu * vf[e];
        }
      }
    }
    __syncwarp();  // pw is rewritten next tile
  }

  // merge the warps in fixed order, through the (now idle) ring
  cp_async_wait<0>();
  __syncthreads();
  float* wm = reinterpret_cast<float*>(smem);  // [WARPS][G]
  float* wl = wm + DC_WARPS * G;               // [WARPS][G]
  float* wacc = wl + DC_WARPS * G;             // [WARPS][G][HD]
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lid == 0) {
      wm[warp * G + g] = m[g];
      wl[warp * G + g] = l[g];
    }
    *reinterpret_cast<float4*>(wacc + (warp * G + g) * HD + 4 * lid) =
        make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  }
  __syncthreads();
  const int H = gridDim.x * G;
  for (int i = tid; i < G * HD; i += DC_THREADS) {
    const int g = i / HD, d = i % HD;
    float mm = NEG_INF;
#pragma unroll
    for (int w = 0; w < DC_WARPS; ++w) mm = fmaxf(mm, wm[w * G + g]);
    float ll = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < DC_WARPS; ++w) {
      const float f = exp2f(wm[w * G + g] - mm);
      ll += wl[w * G + g] * f;
      a += wacc[(w * G + g) * HD + d] * f;
    }
    float* pp = part + ((size_t)(b * H + kvh * G + g) * gridDim.z + split) * PART;
    pp[d] = a;
    if (d == 0) {
      pp[HD] = mm;
      pp[HD + 1] = ll;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(HD) decode_combine_kernel(
    const float* __restrict__ part, const int* __restrict__ pos, T* __restrict__ out, int S,
    int split_len, int n_split, long long p_sb, long long o_sb, long long o_sh) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int last = min(pos[b * p_sb], S - 1);
  const int n_live = last < 0 ? 0 : last / split_len + 1;
  const float* pp = part + (size_t)(b * gridDim.x + h) * n_split * PART;
  // launched as a programmatic dependent of the split kernel: everything
  // above overlaps its tail; the partials are read only once it has
  // finished and its writes are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float mm = NEG_INF;
  for (int s = 0; s < n_live; ++s) mm = fmaxf(mm, pp[s * PART + HD]);
  float ll = 0.f, a = 0.f;
  for (int s = 0; s < n_live; ++s) {
    const float f = exp2f(pp[s * PART + HD] - mm);
    ll += pp[s * PART + HD + 1] * f;
    a += pp[s * PART + d] * f;
  }
  out[b * o_sb + h * o_sh + d] = Vec<T>::cvt(a / (ll == 0.f ? 1.f : ll));
}

// ---- launchers ----------------------------------------------------------
//
// Element strides. Both entry points of a kernel share one layout for q,
// positions and out; the arena's strides sit in between:
//   prefill st = {q_b, q_t, q_h, <6 arena>, pos_b, pos_t, out_b, out_t, out_h[, table_b]}
//   decode  st = {q_b, q_h, <6 arena>, pos_b, out_b, out_h[, table_b]}
// where <6 arena> is {k_b, k_s, k_h, v_b, v_s, v_h} for the dense arena and
// {k_page, k_row, k_h, v_page, v_row, v_h} for the pools.

template <typename T>
DenseArena<T> dense_arena(const void* k, const void* v, const long long* a) {
  return {static_cast<const T*>(k), static_cast<const T*>(v), a[0], a[1], a[2], a[3], a[4], a[5]};
}

template <typename T>
PagedArena<T> paged_arena(const void* k, const void* v, const void* table, long long t_sb,
                          int ps, int n_blocks, const long long* a) {
  return {static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const int*>(table),
          t_sb, ps, n_blocks, a[0], a[1], a[2], a[3], a[4], a[5]};
}

template <typename T, typename Arena>
cudaError_t launch_prefill(const void* q, const Arena& arena, const int* pos, void* out,
                           int B, int T_len, int H, int KV, int S, const long long* st,
                           float scale, cudaStream_t stream) {
  const int G = H / KV;
  auto kern = prefill_kernel<T, Arena>;
  const size_t smem = prefill_smem<T>() + sizeof(int) * (size_t)arena.table_len();
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tok_per_block = PF_BM / G;
  dim3 grid((T_len + tok_per_block - 1) / tok_per_block, KV, B);
  kern<<<grid, prefill_threads<T>(), smem, stream>>>(
      static_cast<const T*>(q), arena, pos, static_cast<T*>(out), T_len, S, G, st[0], st[1],
      st[2], st[9], st[10], st[11], st[12], st[13], scale);
  return cudaGetLastError();
}

template <typename T, int G, typename Arena>
cudaError_t launch_decode_g(const void* q, const Arena& arena, const int* pos, float* part,
                            int B, int KV, int S, int split_len, int n_split,
                            const long long* st, float scale, cudaStream_t stream) {
  auto kern = decode_kernel<T, G, Arena>;
  const size_t smem = decode_smem<T, G>() + sizeof(int) * (size_t)arena.table_len();
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(KV, B, n_split);
  kern<<<grid, DC_THREADS, smem, stream>>>(static_cast<const T*>(q), arena, pos, part, S,
                                           split_len, st[0], st[1], st[8], scale);
  return cudaGetLastError();
}

// Two launches: the split kernel, then the combine. ``part`` holds
// B * H * ceil(S / split_len) * (hd + 2) floats.
template <typename T, typename Arena>
cudaError_t launch_decode(const void* q, const Arena& arena, const int* pos, void* out,
                          void* scratch, int B, int H, int KV, int S, int split_len,
                          const long long* st, float scale, cudaStream_t stream) {
  const int n_split = (S + split_len - 1) / split_len;
  float* part = static_cast<float*>(scratch);
  if (n_split > 0) {
    cudaError_t err;
    switch (H / KV) {
      case 1: err = launch_decode_g<T, 1>(q, arena, pos, part, B, KV, S, split_len, n_split, st, scale, stream); break;
      case 2: err = launch_decode_g<T, 2>(q, arena, pos, part, B, KV, S, split_len, n_split, st, scale, stream); break;
      case 4: err = launch_decode_g<T, 4>(q, arena, pos, part, B, KV, S, split_len, n_split, st, scale, stream); break;
      case 8: err = launch_decode_g<T, 8>(q, arena, pos, part, B, KV, S, split_len, n_split, st, scale, stream); break;
      case 16: err = launch_decode_g<T, 16>(q, arena, pos, part, B, KV, S, split_len, n_split, st, scale, stream); break;
      default: return cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, B);
  cfg.blockDim = dim3(HD);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_combine_kernel<T>, static_cast<const float*>(part), pos, static_cast<T*>(out),
      S, split_len, n_split, st[8], st[9], st[10]);
  return err != cudaSuccess ? err : cudaGetLastError();
}

bool bad_split(int split_len) { return split_len <= 0 || split_len % DC_BK != 0; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides in elements, laid out as above.

// The decode entry points take f32 scratch of B * H * ceil(S / split_len) *
// atpu_decode_part_floats() floats; split_len is a positive multiple of 64.
int atpu_decode_part_floats() { return PART; }

// Dense arena k/v [B, S, KV, hd].
int atpu_flash_prefill(const void* q, const void* k, const void* v, const void* pos, void* out,
                       int dtype, int B, int T_len, int H, int KV, int S,
                       const long long* strides, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  if (H % KV != 0 || PF_BM % (H / KV) != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || T_len == 0) return (int)cudaSuccess;
  const long long* a = strides + 3;
  cudaError_t err = dtype == 1
      ? launch_prefill<bf16>(q, dense_arena<bf16>(k, v, a), p, out, B, T_len, H, KV, S, strides,
                             scale, s)
      : launch_prefill<float>(q, dense_arena<float>(k, v, a), p, out, B, T_len, H, KV, S,
                              strides, scale, s);
  return (int)err;
}

int atpu_flash_decode(const void* q, const void* k, const void* v, const void* pos, void* out,
                      void* scratch, int dtype, int B, int H, int KV, int S, int split_len,
                      const long long* strides, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  if (H % KV != 0 || bad_split(split_len)) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const long long* a = strides + 2;
  cudaError_t err = dtype == 1
      ? launch_decode<bf16>(q, dense_arena<bf16>(k, v, a), p, out, scratch, B, H, KV, S,
                            split_len, strides, scale, s)
      : launch_decode<float>(q, dense_arena<float>(k, v, a), p, out, scratch, B, H, KV, S,
                             split_len, strides, scale, s);
  return (int)err;
}

// Paged: pools [P, page_size, KV, hd], table [B, n_blocks] int32; the table's
// batch stride is the last entry of strides.
int atpu_paged_flash_prefill(const void* q, const void* k_pool, const void* v_pool,
                             const void* table, const void* pos, void* out, int dtype, int B,
                             int T_len, int H, int KV, int page_size, int n_blocks,
                             const long long* strides, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  if (H % KV != 0 || PF_BM % (H / KV) != 0 || page_size <= 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || T_len == 0) return (int)cudaSuccess;
  const long long* a = strides + 3;
  const long long t_sb = strides[14];
  const int S = n_blocks * page_size;
  cudaError_t err = dtype == 1
      ? launch_prefill<bf16>(
            q, paged_arena<bf16>(k_pool, v_pool, table, t_sb, page_size, n_blocks, a), p, out,
            B, T_len, H, KV, S, strides, scale, s)
      : launch_prefill<float>(
            q, paged_arena<float>(k_pool, v_pool, table, t_sb, page_size, n_blocks, a), p, out,
            B, T_len, H, KV, S, strides, scale, s);
  return (int)err;
}

int atpu_paged_flash_decode(const void* q, const void* k_pool, const void* v_pool,
                            const void* table, const void* pos, void* out, void* scratch,
                            int dtype, int B, int H, int KV, int page_size, int n_blocks,
                            int split_len, const long long* strides, float scale,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  if (H % KV != 0 || page_size <= 0 || bad_split(split_len)) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const long long* a = strides + 2;
  const long long t_sb = strides[11];
  const int S = n_blocks * page_size;
  cudaError_t err = dtype == 1
      ? launch_decode<bf16>(
            q, paged_arena<bf16>(k_pool, v_pool, table, t_sb, page_size, n_blocks, a), p, out,
            scratch, B, H, KV, S, split_len, strides, scale, s)
      : launch_decode<float>(
            q, paged_arena<float>(k_pool, v_pool, table, t_sb, page_size, n_blocks, a), p, out,
            scratch, B, H, KV, S, split_len, strides, scale, s);
  return (int)err;
}

}  // extern "C"
