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
// Decode (M = 8) is bounded by the weight bytes (w_gate 4096 x 14336: about
// 17.6 us); a 256-row prefill chunk by its FLOPs (w_gate: about 30.4 us).
//
// Design (a simple kernel that is right first; wgmma and TMA are later work):
//   - a block owns BN = 128 output channels x BM tokens (the wrapper picks
//     BM = 16, 64 or 128 from M) and a range of the contraction; 4 warps,
//     each 32 output channels x BM tokens, so one widened weight fragment
//     feeds BM / 8 mma;
//   - 4-stage ring of BK = 64 deep tiles filled with 16-byte cp.async: the
//     q tile [64][128] int8 as stored, the x tile [BM][64] bf16; rows padded
//     by 16 bytes so ldmatrix reads are free of bank conflicts;
//   - mma.sync m16n8k16 bf16 with f32 accumulation, with the WEIGHT as the
//     A operand (16 output channels) and the tokens as B (8 per mma), so a
//     decode step's 8 lanes fill one mma exactly. ldmatrix.trans of the
//     int8 tile, read as 16-bit pairs, gives each thread the two k values
//     of two neighbouring output channels; they are widened in registers
//     (byte -> f32 through the 2^23 magic number, exact, then the high half
//     of each f32 is its bf16) into the A fragments of two row groups:
//     output channel 2g is fragment row g, 2g + 1 is row g + 8, which the
//     epilogue undoes (each thread stores two neighbouring channels);
//   - the scale is applied once in the epilogue, in f32, before the one
//     rounding to bf16;
//   - at small M a weight has too few 128-column tiles to fill 132 SMs
//     (wk at decode: 8), so the contraction is split (the wrapper picks the
//     split count from the shape alone): each split writes f32 partials to
//     workspace and a second kernel adds them in fixed split order, scales
//     and rounds, launched as a programmatic dependent so that its launch
//     overlaps the split kernel's tail. No atomics: the result is the same
//     bits on every run and in a replayed CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BN = 128;               // output channels per block
constexpr int BK = 64;                // contraction depth per stage
constexpr int STAGES = 4;
constexpr int THREADS = 128;          // 4 warps x 32 output channels
constexpr int Q_ROW = BN + 16;        // bytes of one staged q row
constexpr int X_ROW = 2 * BK + 16;    // bytes of one staged x row
constexpr size_t MAX_SMEM = 232448;   // dynamic shared memory a block may use on sm_90

template <int BM>
__host__ __device__ constexpr int stage_bytes() {
  return BK * Q_ROW + BM * X_ROW;
}
template <int BM>
constexpr size_t smem_bytes() {
  return (size_t)STAGES * stage_bytes<BM>();
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes = 0 writes zeros and reads nothing.
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

// grid (ceil(M / BM), ceil(N / BN), splits). Split s covers contraction
// tiles [s * steps / splits, (s + 1) * steps / splits). With one split the
// block scales and writes y; otherwise it writes its f32 partial sums to
// part[s][m][n] for the combine.
template <int BM>
__global__ void __launch_bounds__(THREADS) w8a16_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ q, const bf16* __restrict__ scale,
    bf16* __restrict__ out, float* __restrict__ part, int M, int N, int K, int splits) {
  constexpr int NT = BM / 8;  // token tiles of one mma (n = 8)
  static_assert(BM * (BK / 8) % THREADS == 0 && NT % 2 == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char smem[];
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int split = blockIdx.z;
  const int steps = K / BK;
  const int s_begin = (int)((long long)steps * split / splits);
  const int n_steps = (int)((long long)steps * (split + 1) / splits) - s_begin;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // a split's combine may be scheduled now; it waits for this grid to end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  auto load = [&](int step, int slot) {
    const int k0 = (s_begin + step) * BK;
    unsigned char* qs = smem + slot * stage_bytes<BM>();
    unsigned char* xs = qs + BK * Q_ROW;
#pragma unroll
    for (int i = 0; i < BK * (BN / 16) / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (BN / 16), col = (c % (BN / 16)) * 16;
      const bool in = n0 + col < N;  // N % 16 == 0: a chunk is all in or all out
      cp_async16(qs + r * Q_ROW + col, q + (size_t)(k0 + r) * N + (in ? n0 + col : 0), in ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < BM * (BK / 8) / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
      const bool in = m0 + r < M;
      cp_async16(xs + r * X_ROW + 2 * col, x + (size_t)(in ? m0 + r : 0) * K + k0 + col, in ? 16 : 0);
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_steps) load(s, s);
    cp_async_commit();
  }

  // ldmatrix addresses of this lane: matrix mi = lane / 8, its row lane % 8
  const int mi = lane >> 3, mr = lane & 7;
  // A (q, transposed): k rows (mi & 1) * 8 + mr, output channels
  // warp * 32 + (mi >> 1) * 16 .. + 15
  const int a_off = ((mi & 1) * 8 + mr) * Q_ROW + warp * 32 + (mi >> 1) * 16;
  // B (x): token (mi >> 1) * 8 + mr of a token-tile pair, k (mi & 1) * 8
  const int b_off = ((mi >> 1) * 8 + mr) * X_ROW + 2 * (mi & 1) * 8;

  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<STAGES - 2>();  // this step's tile has landed
    __syncthreads();               // ... for every thread, and the slot refilled below is free
    const int nxt = step + STAGES - 1;
    if (nxt < n_steps) load(nxt, nxt % STAGES);
    cp_async_commit();

    const unsigned char* qs = smem + (step % STAGES) * stage_bytes<BM>();
    const unsigned char* xs = qs + BK * Q_ROW;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t raw[4];
      ldsm_x4_trans(raw, qs + kk * Q_ROW + a_off);
      uint32_t a[2][4];
      widen_i8x4(raw[0], a[0][0], a[0][1]);  // channels 0-15, k 0-7
      widen_i8x4(raw[1], a[0][2], a[0][3]);  // channels 0-15, k 8-15
      widen_i8x4(raw[2], a[1][0], a[1][1]);  // channels 16-31
      widen_i8x4(raw[3], a[1][2], a[1][3]);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t b[4];
        ldsm_x4(b, xs + nt * 8 * X_ROW + 2 * kk + b_off);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][nt], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][nt + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // fragment (row g / g + 8, column 2t / 2t + 1) of tile (mt, nt) holds
  // output channel n = n0 + warp * 32 + mt * 16 + 2g (+ 1 for row g + 8)
  // and token m = m0 + nt * 8 + 2t (+ 1)
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int n = n0 + warp * 32 + mt * 16 + 2 * g;
    if (n >= N) continue;
    const float s0 = splits == 1 ? __bfloat162float(scale[n]) : 1.f;
    const float s1 = splits == 1 ? __bfloat162float(scale[n + 1]) : 1.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int m = m0 + nt * 8 + 2 * t;
      const float* c = acc[mt][nt];
#pragma unroll
      for (int j = 0; j < 2; ++j) {  // token m + j: c[j] at n, c[j + 2] at n + 1
        if (m + j >= M) continue;
        if (splits == 1) {
          *reinterpret_cast<uint32_t*>(out + (size_t)(m + j) * N + n) =
              pack_bf16(c[j] * s0, c[j + 2] * s1);
        } else {
          *reinterpret_cast<float2*>(part + ((size_t)split * M + m + j) * N + n) =
              make_float2(c[j], c[j + 2]);
        }
      }
    }
  }
}

// y = bf16(scale * sum over splits of part, in split order); one thread per
// 8 neighbouring outputs. Launched as a programmatic dependent of the split
// kernel: its launch and the scale loads overlap that kernel's tail, and
// the partials are read once it has finished and its writes are visible.
__global__ void w8a16_combine_kernel(const float* __restrict__ part, const bf16* __restrict__ scale,
                                     bf16* __restrict__ out, int M, int N, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)M * N / 8;
  const long long e = i * 8;
  const int n = (int)(e % N);
  float sc[8];
  if (i < total) {
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[j] = __bfloat162float(scale[n + j]);
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (i >= total) return;
  float sum[8] = {};
  for (int s = 0; s < splits; ++s) {
    const float4* p = reinterpret_cast<const float4*>(part + (long long)s * M * N + e);
    const float4 lo = p[0], hi = p[1];
    sum[0] += lo.x; sum[1] += lo.y; sum[2] += lo.z; sum[3] += lo.w;
    sum[4] += hi.x; sum[5] += hi.y; sum[6] += hi.z; sum[7] += hi.w;
  }
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[j] = pack_bf16(sum[2 * j] * sc[2 * j], sum[2 * j + 1] * sc[2 * j + 1]);
  }
  *reinterpret_cast<uint4*>(out + e) = make_uint4(w[0], w[1], w[2], w[3]);
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

template <int BM>
cudaError_t launch(const bf16* x, const int8_t* q, const bf16* scale, bf16* out, float* part,
                   int M, int N, int K, int splits, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BM>();
  static_assert(smem <= MAX_SMEM, "stages do not fit in shared memory");
  cudaError_t err = raise_smem_limit<&w8a16_kernel<BM>>(smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
  w8a16_kernel<BM><<<grid, THREADS, smem, stream>>>(x, q, scale, out, part, M, N, K, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = (long long)M * N / 8;
  const int threads = 256;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((total + threads - 1) / threads));
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, w8a16_combine_kernel, static_cast<const float*>(part), scale, out,
                           M, N, splits);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// x [M, K] bf16, q [K, N] int8, scale [N] bf16, out [M, N] bf16, all
// contiguous and 16-byte aligned; part: splits * M * N floats when
// splits > 1 (may be null otherwise). block_m is 16, 64 or 128; K % 64 == 0,
// N % 16 == 0, 1 <= splits <= K / 64. Returns a cudaError_t.
int atpu_w8a16_matmul(const void* x, const void* q, const void* scale, void* out, void* part,
                      int M, int N, int K, int block_m, int splits, void* stream) {
  if (M < 0 || N <= 0 || K <= 0 || K % BK != 0 || N % 16 != 0) return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > K / BK || (splits > 1 && part == nullptr)) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const int8_t* qb = static_cast<const int8_t*>(q);
  const bf16* sb = static_cast<const bf16*>(scale);
  bf16* ob = static_cast<bf16*>(out);
  float* pb = static_cast<float*>(part);
  switch (block_m) {
    case 16: return (int)launch<16>(xb, qb, sb, ob, pb, M, N, K, splits, s);
    case 64: return (int)launch<64>(xb, qb, sb, ob, pb, M, N, K, splits, s);
    case 128: return (int)launch<128>(xb, qb, sb, ob, pb, M, N, K, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
