// The generator's folded 7x7 conv + tanh head, in phase layout, with the
// depth-to-space fused into the store.
//
// Replaces the TPU kernel affganwriting_tpu/ops/phase_head_pallas.py
// (phase_head_fold, body _kernel).  Inputs: the reflect-padded phase tensor
// xp (B, 4C, h+4, w+4), NCHW with channels packed (p, q, c); the tap-major
// folded kernel kc (4C, 100), kc[ci, 4*t + P] for tap t = 5*dy + dx and
// output phase P = 2*p + q; the per-phase bias (4,) in f32.  Output: the
// (B, 1, 2h, 2w) image, out[2i+p, 2j+q] = tanh(bias[P] + sum_{ci,t}
// xp[ci, i+dy, j+dx] * kc[ci, 4t+P]).
//
// Bound on the H100: bytes.  Reassociated, the head is one product
// (pixels x 4C) . (4C x 100), then a 25-tap fold of z = that product.  At
// 51,200 operations per 512 bytes of a pixel's channels (about 100 a byte)
// it sits under the card's ~295 bf16 operations a byte, so the least time
// is the one read of xp: 0.16 ms at batch 256 (4C = 256, 36 x 112).
//
// Two routes, chosen by dtype in ops/phase_head_cuda.py:
//
// * bf16: phase_head_wgmma_kernel, on the tensor cores.  A CUDA-core design
//   cannot reach the bound: the 45.3 GFLOP of the product at batch 256 take
//   0.68 ms at the card's 67 TFLOP/s f32 FMA rate, 4.2x the bytes bound.
//   Here one CTA owns (image, strip of R output rows) and walks the strip's
//   R+4 padded rows.  For each padded row it computes z (128 pixels x 104
//   tap-phase columns, K = 4C) with wgmma (bf16 in, f32 accumulate): A is
//   the row of xp, MN-major (pixels contiguous in NCHW), loaded by TMA in
//   (64 channel x 64 pixel) boxes with 128-byte swizzle and read by wgmma
//   with its transpose bit set; B is kc, packed once per call by the wrapper
//   into the swizzled K-major layout wgmma reads, and copied once by a TMA
//   bulk copy to stay resident (4C/64 x 13 KB).  z goes from the
//   accumulators to shared memory in f32 (it is never rounded to bf16); the
//   fold adds its 5 x 20 columns into a ring of 5 output-row accumulators,
//   and once an output row has seen its 5 padded rows, bias, tanh and the
//   depth-to-space write its two image rows.
//
//   Roles: warps 0-3 and 4-7 are two consumer warpgroups that take the
//   padded rows in turn, each computing a whole row; their epilogues (z
//   store, fold, output row) run in row order through named barriers, so
//   one warpgroup's fold overlaps the other's product.  Warps 8 and 9 are
//   producers, one a warpgroup, each filling that warpgroup's own ring of
//   kRingStages K-chunk stages (16 KB) under full/empty mbarriers: with one
//   producer and one consumer a ring, a parity wait cannot see another
//   round's fill (one ring shared by both warpgroups let a wait pass early).
//   Shared memory (218 KB) holds 6 stages, kc, z and the ring; one CTA an
//   SM.  xp is read once when R = h; R is a launch argument, and the
//   wrapper picks a smaller R at small batch so that enough CTAs fill the
//   card, reading halo rows again (mostly from L2).
//
//   Shapes taken: 4C in {64, 128, 192, 256}, w+4 <= 128 (the row tile) and
//   (w+4) % 8 == 0: every padded row starts a box, and a box whose inner
//   start is not 16-byte aligned faults on the H100 (measured at w+4 = 60
//   and 68; 64, 72 and 112 run).
//
// * f32: phase_head_f32_kernel, on CUDA cores, for the exact-f32 reference
//   runs (TF32 wgmma would not hold 1e-4).  One 128-thread block per (image,
//   16x16 tile of low-res pixels) stages channels 16 at a time with a
//   4-pixel halo and keeps two pixels' four phase sums in f32 registers.
#include <cuda.h>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------- bf16 ----

constexpr int kPix = 64;            // pixels per TMA box and per warpgroup
constexpr int kRowTile = 2 * kPix;  // pixels of one padded row's product
constexpr int kKC = 64;             // channels per K-chunk (one 128 B row)
constexpr int kN = 104;             // 100 tap-phase columns padded to 8
constexpr int kMaxC4 = 256;
constexpr int kMaxW = kRowTile - 4;
constexpr int kRingStages = 3;     // TMA stages of each warpgroup's ring
constexpr int kStages = 2 * kRingStages;
constexpr int kBox = kPix * kKC * 2;           // 8 KB
constexpr int kStageBytes = 2 * kBox;          // both pixel halves
constexpr int kBChunk = kN * kKC * 2;          // 13,312 B, 13 swizzle atoms
constexpr int kZS = 108;            // z row stride in floats: 8 rows of a
                                    // warp's fold reads land on 32 banks
constexpr int kRing = 4 * kMaxW;    // floats of one output-row accumulator
constexpr int kConsumers = 256;
constexpr int kThreadsW = kConsumers + 64;   // + one producer warp a ring

constexpr int kOffA = 0;
constexpr int kOffB = kOffA + kStages * kStageBytes;
constexpr int kOffZ = kOffB + (kMaxC4 / kKC) * kBChunk;
constexpr int kOffRing = kOffZ + kRowTile * kZS * 4;
constexpr int kOffBar = kOffRing + 5 * kRing * 4;
constexpr int kSmemBytes = kOffBar + (2 * kStages + 1) * 8 + 1024;  // +align
static_assert(kOffB % 1024 == 0 && kBChunk % 1024 == 0, "swizzle atoms");
static_assert(kSmemBytes <= 232448, "shared memory of one block");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// One (64 pixel x 64 channel) box of xp viewed as (B*4C, hp*wp).
__device__ __forceinline__ void tma_load_box(void* dst, const CUtensorMap* map,
                                             int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(col), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.  Byte offsets: lbo
// between 64-element atoms along MN (MN-major) or unused (K-major); sbo
// between groups of 8 rows of 128 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | static_cast<uint64_t>(lbo >> 4) << 16
       | static_cast<uint64_t>(sbo >> 4) << 32
       | static_cast<uint64_t>(1) << 62;
}

// d (64 x 104, f32) (+)= A (64 x 16, MN-major) . B (16 x 104, K-major);
// d is zeroed first when accumulate == 0.
__device__ __forceinline__ void wgmma_m64n104k16(float (&d)[52], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %54, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51}, "
      "%52, %53, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N groups are pending; the accumulators are fenced so
// that no read of them moves above the wait.
template <int N>
__device__ __forceinline__ void wgmma_wait(float (&d0)[52], float (&d1)[52]) {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
#pragma unroll
  for (int k = 0; k < 52; ++k)
    asm volatile("" : "+f"(d0[k]), "+f"(d1[k]) :: "memory");
}

// Named barriers of the consumers (0 is __syncthreads): kTurn + g is
// warpgroup g's turn at the epilogue, 256 threads (one warpgroup arrives,
// the other waits); kGroup + g syncs warpgroup g's 128 threads.
constexpr int kTurn = 1, kGroup = 3;

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

// kTwo: the padded row has a second 64-pixel half (w+4 > 64).
template <bool kTwo>
__global__ void __launch_bounds__(kThreadsW, 1)
phase_head_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __nv_bfloat16* __restrict__ kpack,
                        const float* __restrict__ bias4,
                        __nv_bfloat16* __restrict__ out,
                        int c4, int h, int w, int rows) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sa = smem + kOffA;
  uint8_t* sb = smem + kOffB;
  float* z = reinterpret_cast<float*>(smem + kOffZ);
  float* ring = reinterpret_cast<float*>(smem + kOffRing);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* empty = full + kStages;
  uint64_t* bbar = empty + kStages;

  const int wp = w + 4;
  const int nk = c4 / kKC;
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * rows;
  const int i1 = min(i0 + rows, h);
  const int r0 = i0, r1 = i1 + 4;   // padded rows of the strip
  const int tid = threadIdx.x;

  for (int e = tid; e < 5 * kRing; e += kThreadsW) ring[e] = 0.f;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);   // the warpgroup that read the stage
    }
    mbar_init(bbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int n = r1 - r0;
  if (tid >= kConsumers) {
    // ---- producers: lane 0 of warp 8 + g fills ring g with the K-chunks
    // of rows r0 + g, r0 + g + 2, ... for warpgroup g.  One producer and
    // one consumer a ring: a parity wait cannot see a fill of another
    // round.
    if (tid % 32) return;
    const int g = (tid - kConsumers) / 32;
    if (g == 0) {
      mbar_expect_tx(bbar, nk * kBChunk);
      for (int k = 0; k < nk; ++k)
        bulk_load(sb + k * kBChunk, kpack + k * (kBChunk / 2), kBChunk,
                  bbar);
    }
    for (int u = g, q = 0; u < n; u += 2) {
      for (int k = 0; k < nk; ++k, ++q) {
        const int stage = g * kRingStages + q % kRingStages;
        mbar_wait(&empty[stage], ((q / kRingStages) & 1) ^ 1);
        mbar_expect_tx(&full[stage], kTwo ? 2 * kBox : kBox);
        uint8_t* dst = sa + stage * kStageBytes;
        const int row = b * c4 + k * kKC, col = (r0 + u) * wp;
        tma_load_box(dst, &xmap, col, row, &full[stage]);
        // the second pixel half only where the row has one (w+4 > 64)
        if (kTwo)
          tma_load_box(dst + kBox, &xmap, col + kPix, row, &full[stage]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup g takes padded rows r0 + g, r0 + g + 2, ...
  // and computes each whole (two 64-pixel halves).  The epilogues (z store,
  // fold, output row) run in row order: each warpgroup waits for its turn
  // on barrier kTurn + g and hands the z buffer and the ring over on the
  // other's, so one warpgroup's epilogue overlaps the other's product.
  const int g = tid / 128, t = tid % 128;
  const int warp = t / 32, lane = t % 32;
  const uint32_t a_base = smem_u32(sa);
  const uint32_t b_base = smem_u32(sb);
  float d0[52] = {}, d1[52] = {};
  mbar_wait(bbar, 0);
  if (g == 1) named_arrive(kTurn, kConsumers);   // row r0 goes first

  for (int u = g, q = 0; u < n; u += 2) {
    const int r = r0 + u;
    // z of padded row r, K-chunk by K-chunk from ring g; each stage is
    // released as soon as the wgmmas that read it are done
    int prev = 0;
    for (int k = 0; k < nk; ++k, ++q) {
      const int stage = g * kRingStages + q % kRingStages;
      mbar_wait(&full[stage], (q / kRingStages) & 1);
      wgmma_fence();
      const uint32_t a = a_base + stage * kStageBytes;
      const uint32_t bk = b_base + k * kBChunk;
#pragma unroll
      for (int kk = 0; kk < kKC / 16; ++kk) {
        const uint64_t db = desc_sw128(bk + kk * 32, 16, 1024);
        wgmma_m64n104k16(d0, desc_sw128(a + kk * 2048, kBox, 1024), db,
                         k | kk);
        if (kTwo)
          wgmma_m64n104k16(d1, desc_sw128(a + kBox + kk * 2048, kBox, 1024),
                           db, k | kk);
      }
      wgmma_commit();
      if (k > 0) {
        wgmma_wait<1>(d0, d1);
        mbar_arrive(&empty[prev]);
      }
      prev = stage;
    }
    wgmma_wait<0>(d0, d1);
    mbar_arrive(&empty[prev]);

    named_sync(kTurn + g, kConsumers);

    // accumulator fragments -> z[pixel][column] in f32
    {
      const int m = warp * 16 + lane / 4;
      const int c = 2 * (lane % 4);
#pragma unroll
      for (int nb = 0; nb < kN / 8; ++nb) {
        float* zr = z + m * kZS + nb * 8 + c;
        *reinterpret_cast<float2*>(zr) = make_float2(d0[4 * nb],
                                                     d0[4 * nb + 1]);
        *reinterpret_cast<float2*>(zr + 8 * kZS) =
            make_float2(d0[4 * nb + 2], d0[4 * nb + 3]);
        if (kTwo) {
          *reinterpret_cast<float2*>(zr + kPix * kZS) =
              make_float2(d1[4 * nb], d1[4 * nb + 1]);
          *reinterpret_cast<float2*>(zr + (kPix + 8) * kZS) =
              make_float2(d1[4 * nb + 2], d1[4 * nb + 3]);
        }
      }
    }
    named_sync(kGroup + g, 128);

    // fold: padded row r = output row i + dy feeds columns 20dy..20dy+19.
    // A thread takes one (j, P) for all five dy: 25 independent loads.
    for (int e = t; e < 4 * w; e += 128) {
      const float* zp = z + (e >> 2) * kZS + (e & 3);
      float s[5];
#pragma unroll
      for (int dy = 0; dy < 5; ++dy) {
        s[dy] = zp[20 * dy];
#pragma unroll
        for (int dx = 1; dx < 5; ++dx)
          s[dy] += zp[dx * (kZS + 4) + 20 * dy];
      }
#pragma unroll
      for (int dy = 0; dy < 5; ++dy) {
        const int i = r - dy;
        if (i >= i0 && i < i1) ring[(i % 5) * kRing + e] += s[dy];
      }
    }
    named_sync(kGroup + g, 128);

    // output row r - 4 is complete: bias, tanh, depth-to-space; each
    // thread zeroes the accumulator values it read
    const int i = r - 4;
    if (i >= i0) {
      float* acc = ring + (i % 5) * kRing;
      __nv_bfloat16* orow = out + (static_cast<int64_t>(b) * 2 * h + 2 * i)
                                  * (2 * w);
      for (int e = t; e < 2 * w; e += 128) {
        const int p = e / w, j = e % w;
        float2* v = reinterpret_cast<float2*>(&acc[4 * j + 2 * p]);
        const float2 s = *v;
        *v = make_float2(0.f, 0.f);
        *reinterpret_cast<__nv_bfloat162*>(&orow[p * 2 * w + 2 * j]) =
            __floats2bfloat162_rn(tanhf(s.x + bias4[2 * p]),
                                  tanhf(s.y + bias4[2 * p + 1]));
      }
    }
    if (u + 1 < n) named_arrive(kTurn + 1 - g, kConsumers);
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query, so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
        ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

cudaError_t launch_wgmma(const void* xp, const void* kpack, const void* bias4,
                         void* out, int batch, int c4, int h, int w, int rows,
                         cudaStream_t stream) {
  const int hp = h + 4, wp = w + 4;
  if (c4 % kKC || c4 > kMaxC4 || wp % 8 || wp > kRowTile ||
      rows <= 0 || reinterpret_cast<uintptr_t>(xp) % 16 ||
      reinterpret_cast<uintptr_t>(kpack) % 16)
    return cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(hp) * wp,
                              static_cast<cuuint64_t>(batch) * c4};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(hp) * wp * 2};
  const cuuint32_t box[2] = {kPix, kKC};
  const cuuint32_t estrides[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(xp), dims, strides, box, estrides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  auto kernel = wp > kPix ? phase_head_wgmma_kernel<true>
                          : phase_head_wgmma_kernel<false>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((h + rows - 1) / rows, batch);
  kernel<<<grid, kThreadsW, kSmemBytes, stream>>>(
      map, static_cast<const __nv_bfloat16*>(kpack),
      static_cast<const float*>(bias4), static_cast<__nv_bfloat16*>(out), c4,
      h, w, rows);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- f32 ----

constexpr int kTH = 16, kTW = 16;          // low-res output tile
constexpr int kXH = kTH + 4, kXW = kTW + 4;  // tile plus halo
constexpr int kXStride = 24;   // row stride: rows 2 apart land 16 banks apart
constexpr int kCC = 16;        // channels per staged chunk
constexpr int kTaps = 25;
constexpr int kThreads = (kTH / 2) * kTW;  // 128, two pixels each

// out[2i+p, 2j+q] = tanh(acc[2p+q] + bias[2p+q]): the fused depth-to-space
__device__ __forceinline__ void store_pixel(float* ob, int i, int j, int w,
                                            const float (&acc)[4],
                                            const float* __restrict__ bias4) {
#pragma unroll
  for (int ph = 0; ph < 4; ++ph) {
    const int p = ph >> 1, q = ph & 1;
    ob[static_cast<int64_t>(2 * i + p) * (2 * w) + 2 * j + q] =
        tanhf(acc[ph] + bias4[ph]);
  }
}

// Summation order: channel chunks in order, then channel, then dx, then dy,
// all in f32.
__global__ void __launch_bounds__(kThreads)
phase_head_f32_kernel(const float* __restrict__ xp,
                      const float* __restrict__ kc,
                      const float* __restrict__ bias4, float* __restrict__ out,
                      int c4, int h, int w) {
  __shared__ float xs[kCC][kXH][kXStride];
  __shared__ float4 ks[kCC][kTaps];

  const int hp = h + 4, wp = w + 4;
  const int tiles_w = (w + kTW - 1) / kTW;
  const int i0 = (blockIdx.x / tiles_w) * kTH;
  const int j0 = (blockIdx.x % tiles_w) * kTW;
  const int tx = threadIdx.x % kTW;
  const int ty = (threadIdx.x / kTW) * 2;  // first of this thread's two rows
  const float* xb = xp + static_cast<int64_t>(blockIdx.y) * c4 * hp * wp;

  float acc0[4] = {0.f, 0.f, 0.f, 0.f};
  float acc1[4] = {0.f, 0.f, 0.f, 0.f};

  for (int c0 = 0; c0 < c4; c0 += kCC) {
    for (int e = threadIdx.x; e < kCC * kXH * kXW; e += kThreads) {
      const int ci = e / (kXH * kXW);
      const int r = (e / kXW) % kXH;
      const int col = e % kXW;
      const int c = c0 + ci, gi = i0 + r, gj = j0 + col;
      float v = 0.f;
      if (c < c4 && gi < hp && gj < wp)
        v = xb[(static_cast<int64_t>(c) * hp + gi) * wp + gj];
      xs[ci][r][col] = v;
    }
    float* kflat = reinterpret_cast<float*>(ks);
    for (int e = threadIdx.x; e < kCC * kTaps * 4; e += kThreads) {
      const int c = c0 + e / (kTaps * 4);
      kflat[e] = c < c4 ? kc[static_cast<int64_t>(c0) * kTaps * 4 + e] : 0.f;
    }
    __syncthreads();

#pragma unroll 2
    for (int ci = 0; ci < kCC; ++ci) {
#pragma unroll
      for (int dx = 0; dx < 5; ++dx) {
        float col[6];
#pragma unroll
        for (int r = 0; r < 6; ++r) col[r] = xs[ci][ty + r][tx + dx];
#pragma unroll
        for (int dy = 0; dy < 5; ++dy) {
          const float4 k = ks[ci][dy * 5 + dx];
          acc0[0] = fmaf(col[dy], k.x, acc0[0]);
          acc0[1] = fmaf(col[dy], k.y, acc0[1]);
          acc0[2] = fmaf(col[dy], k.z, acc0[2]);
          acc0[3] = fmaf(col[dy], k.w, acc0[3]);
          acc1[0] = fmaf(col[dy + 1], k.x, acc1[0]);
          acc1[1] = fmaf(col[dy + 1], k.y, acc1[1]);
          acc1[2] = fmaf(col[dy + 1], k.z, acc1[2]);
          acc1[3] = fmaf(col[dy + 1], k.w, acc1[3]);
        }
      }
    }
    __syncthreads();
  }

  const int j = j0 + tx;
  if (j >= w) return;
  float* ob = out + static_cast<int64_t>(blockIdx.y) * (2 * h) * (2 * w);
  const int i = i0 + ty;
  if (i < h) store_pixel(ob, i, j, w, acc0, bias4);
  if (i + 1 < h) store_pixel(ob, i + 1, j, w, acc1, bias4);
}

}  // namespace

// bf16 route.  xp (batch, c4, h+4, w+4) bf16; kpack the folded kernel as
// packed by ops/phase_head_cuda.py:pack_kc, (c4/64, 104, 64) bf16, 128-byte
// swizzled; bias4 (4,) f32; out (batch, 1, 2h, 2w) bf16; all contiguous.
// `rows` is the strip height R.  Returns the launch's cudaError_t.
extern "C" int affg_phase_head_wgmma(const void* xp, const void* kpack,
                                     const void* bias4, void* out, int batch,
                                     int c4, int h, int w, int rows,
                                     void* stream) {
  if (batch <= 0 || batch > 65535 || c4 <= 0 || h <= 0 || w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_wgmma(xp, kpack, bias4, out, batch, c4, h,
                                       w, rows,
                                       static_cast<cudaStream_t>(stream)));
}

// f32 route.  xp (batch, c4, h+4, w+4), kc (c4, 100), bias4 (4,), out
// (batch, 1, 2h, 2w), all f32 and contiguous.  Returns the launch's
// cudaError_t.
extern "C" int affg_phase_head_f32(const void* xp, const void* kc,
                                   const void* bias4, void* out, int batch,
                                   int c4, int h, int w, void* stream) {
  if (batch <= 0 || batch > 65535 || c4 <= 0 || h <= 0 || w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(((h + kTH - 1) / kTH) * ((w + kTW - 1) / kTW), batch);
  phase_head_f32_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xp), static_cast<const float*>(kc),
      static_cast<const float*>(bias4), static_cast<float*>(out), c4, h, w);
  return static_cast<int>(cudaGetLastError());
}
