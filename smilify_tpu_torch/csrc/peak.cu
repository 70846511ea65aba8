// FP32 FMA-stream peak probe for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (smilify_tpu_torch/render/_kernels.py).
//
// Replaces the Pallas TPU probe of the JAX package (K5):
//   fma_peak_kernel  ← tools/bench_all.py::measure_vpu_peak_gflops (body `kernel`)
//
// Function, element for element the same as the TPU body: for each element
// x, 32 streams a_i = x·(1 + 0.1·i); 128 rounds of a ← a·0.999999 + 1e-9 on
// every stream; out = ((a_0 + a_1) + a_2) + … + a_31. Rate counted as the
// JAX package counts it: 32 streams × 2 × 128 rounds per element.
//
// What bounds it: FP32 FMA throughput. Each thread holds one element's 32 streams
// in registers, so global memory is read once and written once (8 bytes
// against 8192 FP32 operations an element) and the 32 independent FMA
// chains hide the FMA latency. Each round is an explicit __fmaf_rn (one
// FFMA, rounded once, nothing folded; the build does not use fast math);
// the stream set-up and the final sum use __fmul_rn/__fadd_rn so that no
// contraction changes the function. One element a thread, 256 threads a
// block: the probe's 2,097,152 elements are 8,192 blocks, about 8 waves
// over the 132 SMs. The round loop is unrolled by 8, so its body is 256
// FFMAs and one counter update and branch.

#include <cuda_runtime.h>

namespace {

constexpr int kStreams = 32;
constexpr int kRounds = 128;
constexpr int kUnroll = 8;
constexpr int kThreads = 256;
static_assert(kRounds % kUnroll == 0, "rounds must be a multiple of the unroll");

__global__ void __launch_bounds__(kThreads)
fma_peak_kernel(const float* __restrict__ x, float* __restrict__ out, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float xi = __ldg(x + i);
  float a[kStreams];
#pragma unroll
  for (int s = 0; s < kStreams; ++s) a[s] = __fmul_rn(xi, (float)(1.0 + 0.1 * s));
#pragma unroll 1
  for (int r = 0; r < kRounds; r += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int s = 0; s < kStreams; ++s) a[s] = __fmaf_rn(a[s], 0.999999f, 1e-9f);
    }
  }
  float acc = a[0];
#pragma unroll
  for (int s = 1; s < kStreams; ++s) acc = __fadd_rn(acc, a[s]);
  out[i] = acc;
}

}  // namespace

extern "C" {

const char* smil_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int smil_fma_peak(const float* x, float* out, int n, cudaStream_t stream) {
  if (n <= 0) return 0;
  fma_peak_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(x, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
