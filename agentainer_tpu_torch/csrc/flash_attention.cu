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
// What bounds each kernel on an H100 SXM (989 TFLOP/s bf16 dense,
// 3.35 TB/s HBM) and what the design does about it:
//   - decode reads every live K/V byte once per step and does ~1 FLOP per
//     byte: it is bounded by the BYTES of live K/V. One block per
//     (batch, kv head) streams its arena row (or its pages) in 64-slot tiles
//     with 16-byte loads per thread, and prefetches the next tile into
//     registers while the current one is computed. At llama3-8b decode
//     shapes (B = 8, KV = 8) that is only 64 blocks on 132 SMs; splitting
//     the KV axis across blocks (split-KV plus a combine pass) is the next
//     step.
//   - prefill does ~T FLOPs per K/V byte: once T is large it is bounded by
//     its FLOPs. This first version runs the two products on CUDA cores in
//     f32 from shared memory (64x64 score tile per block, 4x8 register
//     micro-tile per thread); moving them onto the tensor cores (mma.sync /
//     wgmma with TMA-fed tiles) is later work.
//
// Plain C interface, loaded with ctypes. Every function launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 128;           // head_dim
constexpr int KS = HD + 4;        // padded shared-memory row stride (floats)
constexpr float NEG_INF = -1e30f;
constexpr size_t MAX_SMEM = 232448;  // dynamic shared memory a block may use on sm_90

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
  __device__ static uint4 raw(const float* p) { return *reinterpret_cast<const uint4*>(p); }
  __device__ static void widen(uint4 r, float* dst) {
    dst[0] = __uint_as_float(r.x); dst[1] = __uint_as_float(r.y);
    dst[2] = __uint_as_float(r.z); dst[3] = __uint_as_float(r.w);
  }
  __device__ static void store4(float* p, const float* src) {
    *reinterpret_cast<float4*>(p) = make_float4(src[0], src[1], src[2], src[3]);
  }
  __device__ static float cvt(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static uint4 raw(const __nv_bfloat16* p) { return *reinterpret_cast<const uint4*>(p); }
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
  __device__ static void load(const __nv_bfloat16* p, float* dst) { widen(raw(p), dst); }
  __device__ static void store4(__nv_bfloat16* p, const float* src) {
    __nv_bfloat162 a = __floats2bfloat162_rn(src[0], src[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(src[2], src[3]);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&a);
    u.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  }
  __device__ static __nv_bfloat16 cvt(float x) { return __float2bfloat16(x); }
};

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// ---- where slot j of (lane b, kv head h) lives ------------------------------
//
// A policy is passed to the kernel by value. ``stage`` copies what the block
// needs of the lane's addressing into shared memory (the paged table row);
// ``lane`` binds (b, h) and returns an accessor whose krow(j) / vrow(j) give
// the first element of slot j's head_dim row.

template <typename T>
struct DenseArena {
  static constexpr bool kPaged = false;
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
  static constexpr bool kPaged = true;
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

// ---- prefill --------------------------------------------------------------
//
// Grid (ceil(T / (BM / G)), KV, B), 128 threads. A block owns BM = 64 query
// rows: BM / G consecutive tokens x the G heads of one kv head, and walks
// the K/V tiles [0, BK), [BK, 2BK), ... up to the largest position among its
// rows. Thread (rb, cb) = (tid / 8, tid % 8) holds score rows rb*4..rb*4+3 x
// key columns cb + 8*jj, and output rows rb*4.. x head_dim columns
// cb*4 + 32*q .. +3 — both mappings read shared memory without bank
// conflicts (the padded stride KS puts consecutive rows 4 banks apart).

constexpr int PF_THREADS = 128;
constexpr int PF_BM = 64;
constexpr int PF_BK = 64;
constexpr int PF_PS = PF_BK + 1;
constexpr size_t PF_SMEM =
    sizeof(float) * (size_t)(PF_BM * KS + 2 * PF_BK * KS + PF_BM * PF_PS) + sizeof(int) * PF_BM;

template <typename T, typename Arena>
__global__ void __launch_bounds__(PF_THREADS) prefill_kernel(
    const T* __restrict__ q, const Arena arena, const int* __restrict__ pos,
    T* __restrict__ out, int T_len, int H, int S, int G, long long q_sb, long long q_st,
    long long q_sh, long long p_sb, long long p_st, long long o_sb, long long o_st,
    long long o_sh, float scale) {
  extern __shared__ float smem[];
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
      for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
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
      for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
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

// ---- decode ---------------------------------------------------------------
//
// Grid (KV, B), 256 threads. One block per (batch, kv head) handles all G
// query heads of the group against its arena row (or its pages), 64 slots
// per tile, up to min(pos, S - 1). Scores: thread (j, gq) = (tid % 64,
// tid / 64) computes key j for heads gq, gq + 4, ...; softmax statistics:
// warp w owns heads w, w + 8, ...; P·V: thread (d, gh) = (tid % 128,
// tid / 128) owns head_dim column d of heads gh, gh + 2, .... The next
// tile's K/V is fetched into registers while the current tile is computed
// from shared memory.

constexpr int DC_THREADS = 256;
constexpr int DC_BK = 64;

template <int G>
constexpr size_t decode_smem() {
  return sizeof(float) * (size_t)(G * KS + 2 * DC_BK * KS + G * DC_BK + 3 * G);
}

template <typename T, int G, typename Arena>
__global__ void __launch_bounds__(DC_THREADS) decode_kernel(
    const T* __restrict__ q, const Arena arena, const int* __restrict__ pos,
    T* __restrict__ out, int S, long long q_sb, long long q_sh, long long p_sb,
    long long o_sb, long long o_sh, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                 // [G][KS]
  float* k_s = q_s + G * KS;         // [BK][KS]
  float* v_s = k_s + DC_BK * KS;     // [BK][KS]
  float* p_s = v_s + DC_BK * KS;     // [G][BK]
  float* m_s = p_s + G * DC_BK;      // [G] running max
  float* l_s = m_s + G;              // [G] running sum
  float* a_s = l_s + G;              // [G] this tile's rescale factor
  int* tbl_s = reinterpret_cast<int*>(a_s + G);  // [table_len] (paged only)

  constexpr int VN = Vec<T>::N;
  constexpr int VPR = HD / VN;
  constexpr int LPT = DC_BK * VPR / DC_THREADS;  // 16-byte loads per thread per tile
  const int tid = threadIdx.x;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int p = pos[b * p_sb];
  const int last = min(p, S - 1);
  const int n_tiles = last < 0 ? 0 : last / DC_BK + 1;

  for (int idx = tid; idx < G * VPR; idx += DC_THREADS) {
    const int g = idx / VPR, c = (idx % VPR) * VN;
    float buf[VN];
    Vec<T>::load(q + b * q_sb + (kvh * G + g) * q_sh + c, buf);
#pragma unroll
    for (int e = 0; e < VN; ++e) q_s[g * KS + c + e] = buf[e];
  }
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  arena.stage(b, tbl_s, tid, DC_THREADS);
  if constexpr (Arena::kPaged) __syncthreads();  // the first fetch reads the table
  const auto lane = arena.lane(b, kvh, tbl_s);

  uint4 kr[LPT], vr[LPT];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int u = 0; u < LPT; ++u) {
      const int idx = tid + u * DC_THREADS;
      const int key = k0 + idx / VPR, c = (idx % VPR) * VN;
      if (key < S) {
        kr[u] = Vec<T>::raw(lane.krow(key) + c);
        vr[u] = Vec<T>::raw(lane.vrow(key) + c);
      } else {
        kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  if (n_tiles > 0) fetch(0);

  constexpr int GH = (G + 1) / 2;
  float acc[GH];
#pragma unroll
  for (int i = 0; i < GH; ++i) acc[i] = 0.f;
  const int d = tid % HD, gh = tid / HD;
  const int jq = tid % DC_BK, gq = tid / DC_BK;
  const int warp = tid / 32, lane_id = tid % 32;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * DC_BK;
    __syncthreads();  // previous tile's readers are done with k_s/v_s/p_s
#pragma unroll
    for (int u = 0; u < LPT; ++u) {
      const int idx = tid + u * DC_THREADS;
      const int j = idx / VPR, c = (idx % VPR) * VN;
      float kb[VN], vb[VN];
      Vec<T>::widen(kr[u], kb);
      Vec<T>::widen(vr[u], vb);
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        k_s[j * KS + c + e] = kb[e];
        v_s[j * KS + c + e] = vb[e];
      }
    }
    __syncthreads();
    if (tile + 1 < n_tiles) fetch(k0 + DC_BK);  // in flight during compute

    // masked, scaled scores
    const int key = k0 + jq;
    const bool valid = key <= last;
    for (int g = gq; g < G; g += DC_THREADS / DC_BK) {
      float sc = 0.f;
#pragma unroll 8
      for (int dd = 0; dd < HD; dd += 4)
        sc += dot4(*reinterpret_cast<const float4*>(&q_s[g * KS + dd]),
                   *reinterpret_cast<const float4*>(&k_s[jq * KS + dd]));
      p_s[g * DC_BK + jq] = valid ? sc * scale : NEG_INF;
    }
    __syncthreads();

    // online-softmax statistics per head
    for (int g = warp; g < G; g += DC_THREADS / 32) {
      const float s0 = p_s[g * DC_BK + lane_id], s1 = p_s[g * DC_BK + lane_id + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = (k0 + lane_id <= last) ? expf(s0 - m_new) : 0.f;
      const float p1 = (k0 + lane_id + 32 <= last) ? expf(s1 - m_new) : 0.f;
      p_s[g * DC_BK + lane_id] = p0;
      p_s[g * DC_BK + lane_id + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane_id == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P · V
#pragma unroll
    for (int i = 0; i < GH; ++i) {
      const int g = gh + 2 * i;
      if (g < G) {
        float a = acc[i] * a_s[g];
#pragma unroll 8
        for (int j = 0; j < DC_BK; ++j) a += p_s[g * DC_BK + j] * v_s[j * KS + d];
        acc[i] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < GH; ++i) {
    const int g = gh + 2 * i;
    if (g < G) {
      const float lg = l_s[g];
      const float val = acc[i] / (lg == 0.f ? 1.f : lg);
      T* o = out + b * o_sb + (kvh * G + g) * o_sh + d;
      *o = Vec<T>::cvt(val);
    }
  }
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
  const size_t smem = PF_SMEM + sizeof(int) * (size_t)arena.table_len();
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tok_per_block = PF_BM / G;
  dim3 grid((T_len + tok_per_block - 1) / tok_per_block, KV, B);
  kern<<<grid, PF_THREADS, smem, stream>>>(
      static_cast<const T*>(q), arena, pos, static_cast<T*>(out), T_len, H, S, G, st[0], st[1],
      st[2], st[9], st[10], st[11], st[12], st[13], scale);
  return cudaGetLastError();
}

template <typename T, int G, typename Arena>
cudaError_t launch_decode_g(const void* q, const Arena& arena, const int* pos, void* out,
                            int B, int KV, int S, const long long* st, float scale,
                            cudaStream_t stream) {
  auto kern = decode_kernel<T, G, Arena>;
  const size_t smem = decode_smem<G>() + sizeof(int) * (size_t)arena.table_len();
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(KV, B);
  kern<<<grid, DC_THREADS, smem, stream>>>(
      static_cast<const T*>(q), arena, pos, static_cast<T*>(out), S, st[0], st[1], st[8],
      st[9], st[10], scale);
  return cudaGetLastError();
}

template <typename T, typename Arena>
cudaError_t launch_decode(const void* q, const Arena& arena, const int* pos, void* out,
                          int B, int H, int KV, int S, const long long* st, float scale,
                          cudaStream_t stream) {
  switch (H / KV) {
    case 1: return launch_decode_g<T, 1>(q, arena, pos, out, B, KV, S, st, scale, stream);
    case 2: return launch_decode_g<T, 2>(q, arena, pos, out, B, KV, S, st, scale, stream);
    case 4: return launch_decode_g<T, 4>(q, arena, pos, out, B, KV, S, st, scale, stream);
    case 8: return launch_decode_g<T, 8>(q, arena, pos, out, B, KV, S, st, scale, stream);
    case 16: return launch_decode_g<T, 16>(q, arena, pos, out, B, KV, S, st, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides in elements, laid out as above.

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
      ? launch_prefill<__nv_bfloat16>(q, dense_arena<__nv_bfloat16>(k, v, a), p, out, B, T_len,
                                      H, KV, S, strides, scale, s)
      : launch_prefill<float>(q, dense_arena<float>(k, v, a), p, out, B, T_len, H, KV, S,
                              strides, scale, s);
  return (int)err;
}

int atpu_flash_decode(const void* q, const void* k, const void* v, const void* pos, void* out,
                      int dtype, int B, int H, int KV, int S, const long long* strides,
                      float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  if (H % KV != 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const long long* a = strides + 2;
  cudaError_t err = dtype == 1
      ? launch_decode<__nv_bfloat16>(q, dense_arena<__nv_bfloat16>(k, v, a), p, out, B, H, KV,
                                     S, strides, scale, s)
      : launch_decode<float>(q, dense_arena<float>(k, v, a), p, out, B, H, KV, S, strides,
                             scale, s);
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
      ? launch_prefill<__nv_bfloat16>(
            q, paged_arena<__nv_bfloat16>(k_pool, v_pool, table, t_sb, page_size, n_blocks, a),
            p, out, B, T_len, H, KV, S, strides, scale, s)
      : launch_prefill<float>(
            q, paged_arena<float>(k_pool, v_pool, table, t_sb, page_size, n_blocks, a), p, out,
            B, T_len, H, KV, S, strides, scale, s);
  return (int)err;
}

int atpu_paged_flash_decode(const void* q, const void* k_pool, const void* v_pool,
                            const void* table, const void* pos, void* out, int dtype, int B,
                            int H, int KV, int page_size, int n_blocks,
                            const long long* strides, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  if (H % KV != 0 || page_size <= 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const long long* a = strides + 2;
  const long long t_sb = strides[11];
  const int S = n_blocks * page_size;
  cudaError_t err = dtype == 1
      ? launch_decode<__nv_bfloat16>(
            q, paged_arena<__nv_bfloat16>(k_pool, v_pool, table, t_sb, page_size, n_blocks, a),
            p, out, B, H, KV, S, strides, scale, s)
      : launch_decode<float>(
            q, paged_arena<float>(k_pool, v_pool, table, t_sb, page_size, n_blocks, a), p, out,
            B, H, KV, S, strides, scale, s);
  return (int)err;
}

}  // extern "C"
