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
// Bound by bytes at the main path's shapes: xp is read once (about 2 MB an
// image in bf16), the image written once; the 2*4C*100 operations a pixel
// are below the card's operations-per-byte balance.
//
// Design (simple first version, CUDA cores): one 128-thread block per
// (image, 16x16 tile of low-res pixels).  Channels are staged in chunks of
// 16: the tile plus its 4-pixel halo of xp, and the chunk's rows of kc, both
// as f32 in shared memory.  Each thread owns two vertically adjacent
// low-res pixels and accumulates their 4 phase sums in f32 registers, so a
// column of 6 staged values serves 10 (pixel, dy) pairs.  Summation order:
// channel chunks in order, then channel, then dx, then dy; no intermediate
// rounding (the Pallas kernel rounds z to the input dtype before the tap
// sum).  Bias, tanh and the depth-to-space happen in the store.
#include "common.cuh"

namespace {

constexpr int kTH = 16, kTW = 16;          // low-res output tile
constexpr int kXH = kTH + 4, kXW = kTW + 4;  // tile plus halo
constexpr int kXStride = 24;   // row stride: rows 2 apart land 16 banks apart
constexpr int kCC = 16;        // channels per staged chunk
constexpr int kTaps = 25;
constexpr int kThreads = (kTH / 2) * kTW;  // 128, two pixels each

// out[2i+p, 2j+q] = tanh(acc[2p+q] + bias[2p+q]): the fused depth-to-space
template <typename T>
__device__ __forceinline__ void store_pixel(T* ob, int i, int j, int w,
                                            const float (&acc)[4],
                                            const float* __restrict__ bias4) {
#pragma unroll
  for (int ph = 0; ph < 4; ++ph) {
    const int p = ph >> 1, q = ph & 1;
    ob[static_cast<int64_t>(2 * i + p) * (2 * w) + 2 * j + q] =
        affg::from_float<T>(tanhf(acc[ph] + bias4[ph]));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
phase_head_kernel(const T* __restrict__ xp, const T* __restrict__ kc,
                  const float* __restrict__ bias4, T* __restrict__ out,
                  int c4, int h, int w) {
  __shared__ float xs[kCC][kXH][kXStride];
  __shared__ float4 ks[kCC][kTaps];

  const int hp = h + 4, wp = w + 4;
  const int tiles_w = (w + kTW - 1) / kTW;
  const int i0 = (blockIdx.x / tiles_w) * kTH;
  const int j0 = (blockIdx.x % tiles_w) * kTW;
  const int tx = threadIdx.x % kTW;
  const int ty = (threadIdx.x / kTW) * 2;  // first of this thread's two rows
  const T* xb = xp + static_cast<int64_t>(blockIdx.y) * c4 * hp * wp;

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
        v = affg::to_float(xb[(static_cast<int64_t>(c) * hp + gi) * wp + gj]);
      xs[ci][r][col] = v;
    }
    float* kflat = reinterpret_cast<float*>(ks);
    for (int e = threadIdx.x; e < kCC * kTaps * 4; e += kThreads) {
      const int c = c0 + e / (kTaps * 4);
      kflat[e] = c < c4
          ? affg::to_float(kc[static_cast<int64_t>(c0) * kTaps * 4 + e])
          : 0.f;
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
  T* ob = out + static_cast<int64_t>(blockIdx.y) * (2 * h) * (2 * w);
  const int i = i0 + ty;
  if (i < h) store_pixel(ob, i, j, w, acc0, bias4);
  if (i + 1 < h) store_pixel(ob, i + 1, j, w, acc1, bias4);
}

template <typename T>
cudaError_t launch(const void* xp, const void* kc, const void* bias4,
                   void* out, int batch, int c4, int h, int w,
                   cudaStream_t stream) {
  const dim3 grid(((h + kTH - 1) / kTH) * ((w + kTW - 1) / kTW), batch);
  phase_head_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(kc),
      static_cast<const float*>(bias4), static_cast<T*>(out), c4, h, w);
  return cudaGetLastError();
}

}  // namespace

// xp (batch, c4, h+4, w+4), kc (c4, 100) of the same dtype, bias4 (4,) f32,
// out (batch, 1, 2h, 2w); all contiguous (checked by the wrapper,
// ops/phase_head_cuda.py).  Returns the launch's cudaError_t.
extern "C" int affg_phase_head(const void* xp, const void* kc,
                               const void* bias4, void* out, int batch,
                               int c4, int h, int w, int dtype, void* stream) {
  if (batch <= 0 || batch > 65535 || c4 <= 0 || h <= 0 || w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == affg::kFloat32)
    return static_cast<int>(
        launch<float>(xp, kc, bias4, out, batch, c4, h, w, s));
  if (dtype == affg::kBFloat16)
    return static_cast<int>(
        launch<__nv_bfloat16>(xp, kc, bias4, out, batch, c4, h, w, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
