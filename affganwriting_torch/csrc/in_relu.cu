// relu(instance_norm(x)) over the (n, c) planes of an NCHW tensor.
//
// Replaces the TPU kernel affganwriting_tpu/ops/in_relu_pallas.py
// (instance_norm_relu, body _kernel).  Bound by bytes: one read and one
// write of x, about five operations per element.
//
// Design: in NCHW one (n, c) plane is H*W contiguous elements (864 and
// 3,456 at the decoder's spatial upsample stages), so one thread block owns
// one plane.  Each thread keeps up to ITEMS 8-element vectors of the plane
// in registers (16-byte loads in bf16), the block reduces sum and sum of
// squares in f32 (warp shuffles, then shared memory), and the same
// registers are normalized and written: one read, one write, as the Pallas
// kernel got from its VMEM slab.
//
// Numerics follow ops/norms.py:instance_norm: mean and rsqrt(var + eps) in
// f32 from E[x^2] - E[x]^2, each rounded to the input dtype; then
// (x - mean) and its product with the scale, each rounded to the input
// dtype; then the optional ReLU.
#include "common.cuh"

namespace {

constexpr int kVec = 8;
constexpr int kMaxThreads = 256;
constexpr int kMaxItems = 8;   // planes up to 256 * 8 * 8 = 16,384 elements

template <typename T, int ITEMS>
__global__ void __launch_bounds__(kMaxThreads)
in_relu_kernel(const T* __restrict__ x, T* __restrict__ y, int plane,
               float eps, int relu) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * plane;
  const int nvec = plane / kVec;
  float v[ITEMS][kVec];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int vi = threadIdx.x + it * blockDim.x;
    if (vi < nvec) {
      affg::load8(x + base + static_cast<int64_t>(vi) * kVec, v[it]);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        s1 += v[it][k];
        s2 += v[it][k] * v[it][k];
      }
    }
  }

  __shared__ float red[2][kMaxThreads / 32];
  __shared__ float stats[2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  s1 = affg::warp_sum(s1);
  s2 = affg::warp_sum(s2);
  if (lane == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    float a = lane < nwarps ? red[0][lane] : 0.f;
    float b = lane < nwarps ? red[1][lane] : 0.f;
    a = affg::warp_sum(a);
    b = affg::warp_sum(b);
    if (lane == 0) {
      const float mean = a / static_cast<float>(plane);
      const float var = b / static_cast<float>(plane) - mean * mean;
      stats[0] = affg::round_to<T>(mean);
      stats[1] = affg::round_to<T>(1.0f / sqrtf(var + eps));
    }
  }
  __syncthreads();
  const float mean = stats[0], scale = stats[1];

#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int vi = threadIdx.x + it * blockDim.x;
    if (vi < nvec) {
      float o[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float d = affg::round_to<T>(v[it][k] - mean);
        float r = affg::round_to<T>(d * scale);
        o[k] = relu ? fmaxf(r, 0.f) : r;
      }
      affg::store8(y + base + static_cast<int64_t>(vi) * kVec, o);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, int planes, int plane, float eps,
                   int relu, cudaStream_t stream) {
  const int nvec = plane / kVec;
  const int warps32 = ((nvec + 31) / 32) * 32;
  const int threads = warps32 < kMaxThreads ? warps32 : kMaxThreads;
  const int items = (nvec + threads - 1) / threads;
  const T* xs = static_cast<const T*>(x);
  T* ys = static_cast<T*>(y);
  if (items <= 1)
    in_relu_kernel<T, 1><<<planes, threads, 0, stream>>>(xs, ys, plane, eps, relu);
  else if (items <= 2)
    in_relu_kernel<T, 2><<<planes, threads, 0, stream>>>(xs, ys, plane, eps, relu);
  else if (items <= 4)
    in_relu_kernel<T, 4><<<planes, threads, 0, stream>>>(xs, ys, plane, eps, relu);
  else
    in_relu_kernel<T, kMaxItems><<<planes, threads, 0, stream>>>(xs, ys, plane, eps, relu);
  return cudaGetLastError();
}

}  // namespace

// x, y: (planes, plane) contiguous, 16-byte aligned; plane % 8 == 0 and
// plane <= 16384 (checked by the wrapper, ops/in_relu_cuda.py).  Returns the
// launch's cudaError_t.
extern "C" int affg_in_relu(const void* x, void* y, int planes, int plane,
                            float eps, int relu, int dtype, void* stream) {
  if (planes <= 0 || plane <= 0 || plane % kVec != 0 ||
      plane > kMaxThreads * kMaxItems * kVec)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == affg::kFloat32)
    return static_cast<int>(launch<float>(x, y, planes, plane, eps, relu, s));
  if (dtype == affg::kBFloat16)
    return static_cast<int>(
        launch<__nv_bfloat16>(x, y, planes, plane, eps, relu, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
