// Soft-silhouette raster kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (smilify_tpu_torch/render/_kernels.py).
//
// They replace the four Pallas TPU kernels of the JAX package:
//   exact_fwd_kernel     ← smilify_tpu/render/rasterizer.py::_fwd_kernel (K1)
//   exact_bwd_kernel     ← smilify_tpu/render/rasterizer.py::_bwd_kernel (K2)
//   worklist_fwd_kernel  ← smilify_tpu/render/rasterizer_worklist.py::_wl_fwd_kernel (K3)
//   worklist_bwd_kernel  ← smilify_tpu/render/rasterizer_worklist.py::_wl_bwd_kernel (K4)
//
// What bounds them on this card: FP32 and transcendental throughput on the
// (pixel, face) pairs the cull admits — about 70 FP32 operations, an exp
// and a log1p per pair forward, 90 operations and an exp backward. The
// bytes are small: the packed face rows and the cull words or work lists
// plus S are under 2 MB a frame at 512² and ~6k faces, read from L2.
//
// Design. One block of 256 threads per (tile of 32×32 pixels, frame); the
// TPU's sequential grid axis over face chunks becomes a loop inside the
// block. A batch of up to 64 admitted 8-face subgroups (one chunk's set cull
// bits, or 64 work-list entries) is staged in shared memory, each face with
// its edge vectors and reciprocal squared edge lengths precomputed, so the
// per-pixel loop reads every face as a broadcast.
//   * Forward: each thread keeps 4 pixels (one column, rows 8 apart) and
//     their S in registers. The saturation early-out (every pixel S ≥ 20) is
//     one __syncthreads_and per batch, not per subgroup.
//   * Backward: each warp takes whole faces; a lane walks the 32 rows of one
//     tile column, the six xy gradients are reduced over the warp with
//     shuffles, and lane 0 adds them to dface with atomicAdd. Tiles sharing a
//     face run in parallel here (the TPU accumulated them in grid order), so
//     the accumulation order, and the last bits of dface, vary run to run.

#include "raster.cuh"

#include <cstdint>

namespace smil {
namespace {

// The thread's 4 forward pixels: column tid % 32, rows tid / 32 + 8k;
// pixel q = tid + 256k of the tile.
__device__ __forceinline__ void thread_pixels(int t, int n_tx, int H, int W, float& px,
                                              float (&py)[kPixPerThread]) {
  const float s = (float)min(H, W);
  const int ti = t / n_tx, tj = t % n_tx;
  px = ndc_x(tj * kTileW + (int)threadIdx.x % kTileW, W, s);
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k)
    py[k] = ndc_y(ti * kTileH + (int)threadIdx.x / kTileW + k * (kThreads / kTileW), H, s);
}

// The 64 subgroup bits of chunk c (bit 16·w + g = bit g of word w).
__device__ __forceinline__ unsigned long long chunk_bits(const int* __restrict__ words) {
  unsigned long long m = 0ull;
#pragma unroll
  for (int w = 0; w < kWords; ++w)
    m |= (unsigned long long)((unsigned)__ldg(words + w) & 0xFFFFu) << (16 * w);
  return m;
}

// Lists the set bits of m in sgroups (ascending); the caller synchronises.
__device__ __forceinline__ void list_bits(unsigned long long m, int* sgroups) {
  const int i = threadIdx.x;
  if (i < kGroupsPerChunk && ((m >> i) & 1ull))
    sgroups[__popcll(m & ((1ull << i) - 1ull))] = i;
}

// Stages the faces of subgroups sgroups[0..n) of the face rows at `faces`.
__device__ __forceinline__ void stage_groups(const float* __restrict__ faces,
                                             const int* sgroups, int n, float* sface) {
  for (int j = threadIdx.x; j < n * kFaceGroup; j += kThreads) {
    const int face = sgroups[j / kFaceGroup] * kFaceGroup + j % kFaceGroup;
    stage_face(faces + (size_t)face * kRowFloats, sface + j * kStaged);
  }
}

__device__ __forceinline__ float min_of(const float (&S)[kPixPerThread]) {
  float m = S[0];
#pragma unroll
  for (int k = 1; k < kPixPerThread; ++k) m = fminf(m, S[k]);
  return m;
}

// Forward: adds n staged subgroups to the thread's pixels, one subgroup's
// 8 faces summed before they join S.
__device__ __forceinline__ void fwd_groups(const float* sface, int n, float px,
                                           const float (&py)[kPixPerThread],
                                           float (&S)[kPixPerThread], float inv_sigma) {
  for (int g = 0; g < n; ++g) {
    float acc[kPixPerThread] = {};
    for (int k = 0; k < kFaceGroup; ++k) {
      float f[kStaged];
      load_face(sface + (g * kFaceGroup + k) * kStaged, f);
#pragma unroll
      for (int p = 0; p < kPixPerThread; ++p) acc[p] += fwd_term(px, py[p], f, inv_sigma);
    }
#pragma unroll
    for (int p = 0; p < kPixPerThread; ++p) S[p] += acc[p];
  }
}

__device__ __forceinline__ void store_tile(float* __restrict__ S_out,
                                           const float (&S)[kPixPerThread]) {
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) S_out[threadIdx.x + k * kThreads] = S[k];
}

// Backward set-up: the tile's incoming dS into sG, the NDC y of its rows
// into spy; returns (to every thread) whether any |dS| > kGradSkip.
__device__ __forceinline__ bool load_tile_grad(const float* __restrict__ gS, float* sG,
                                               float* spy, int t, int n_tx, int H, int W) {
  const float s = (float)min(H, W);
  bool any = false;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const float G = gS[threadIdx.x + k * kThreads];
    sG[threadIdx.x + k * kThreads] = G;
    any |= fabsf(G) > kGradSkip;
  }
  if (threadIdx.x < kTileH) spy[threadIdx.x] = ndc_y((t / n_tx) * kTileH + threadIdx.x, H, s);
  return __syncthreads_or(any);
}

// Backward: warp w takes staged faces w, w + 8, ...; lane l sums the
// gradient over column l of the tile; lane 0 adds the warp's sum to the
// face's row of dface (rows of the subgroups in sgroups, based at `dface`).
__device__ __forceinline__ void bwd_groups(const float* sface, const int* sgroups, int n,
                                           const float* sG, const float* spy, float px,
                                           float* __restrict__ dface, float inv_sigma) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int j = warp; j < n * kFaceGroup; j += kWarps) {
    float f[kStaged];
    load_face(sface + j * kStaged, f);
    float g[6] = {};
    for (int r = 0; r < kTileH; ++r) bwd_term(px, spy[r], sG[r * kTileW + lane], f, inv_sigma, g);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) g[i] += __shfl_xor_sync(0xffffffffu, g[i], off);
    }
    if (lane == 0) {
      float* row = dface + (size_t)(sgroups[j / kFaceGroup] * kFaceGroup + j % kFaceGroup) * kRowFloats;
#pragma unroll
      for (int i = 0; i < 6; ++i) atomicAdd(row + i, g[i]);
    }
  }
}

// K1. S tiles of the exact raster. face_data (N, C, 512, 8); mask
// (N, T, C, 4) cull words; S (N, T, 1024); work (N·T) or null.
__global__ void __launch_bounds__(kThreads)
exact_fwd_kernel(const float* __restrict__ face_data, const int* __restrict__ mask,
                 float* __restrict__ S_out, int* __restrict__ work, int C, int H, int W,
                 int n_tx, float inv_sigma) {
  __shared__ __align__(16) float sface[kFaceChunk * kStaged];
  __shared__ int sgroups[kGroupsPerChunk];
  const int t = blockIdx.x, f = blockIdx.y;
  const size_t tile = (size_t)f * gridDim.x + t;
  float px, py[kPixPerThread], S[kPixPerThread] = {};
  thread_pixels(t, n_tx, H, W, px, py);
  int n_work = 0;
  for (int c = 0; c < C; ++c) {
    const unsigned long long m = chunk_bits(mask + (tile * C + c) * kWords);
    if (m == 0ull) continue;  // block-uniform: every thread read the same words
    // also the barrier that ends the previous batch's reads of sface
    if (__syncthreads_and(min_of(S) >= kSaturationS)) break;
    list_bits(m, sgroups);
    __syncthreads();
    const int n = __popcll(m);
    stage_groups(face_data + ((size_t)f * C + c) * kFaceChunk * kRowFloats, sgroups, n, sface);
    __syncthreads();
    fwd_groups(sface, n, px, py, S, inv_sigma);
    n_work += n;
  }
  store_tile(S_out + tile * kTilePix, S);
  if (work != nullptr && threadIdx.x == 0) work[tile] = n_work;
}

// K2. dS/d(face rows) of the exact raster; dface zeroed by the caller.
__global__ void __launch_bounds__(kThreads)
exact_bwd_kernel(const float* __restrict__ face_data, const int* __restrict__ mask,
                 const float* __restrict__ gS, float* __restrict__ dface,
                 int* __restrict__ work, int C, int H, int W, int n_tx, float inv_sigma) {
  __shared__ __align__(16) float sface[kFaceChunk * kStaged];
  __shared__ float sG[kTilePix];
  __shared__ float spy[kTileH];
  __shared__ int sgroups[kGroupsPerChunk];
  const int t = blockIdx.x, f = blockIdx.y;
  const size_t tile = (size_t)f * gridDim.x + t;
  int n_work = 0;
  if (load_tile_grad(gS + tile * kTilePix, sG, spy, t, n_tx, H, W)) {
    const float px = ndc_x((t % n_tx) * kTileW + (int)threadIdx.x % 32, W, (float)min(H, W));
    for (int c = 0; c < C; ++c) {
      const unsigned long long m = chunk_bits(mask + (tile * C + c) * kWords);
      if (m == 0ull) continue;
      __syncthreads();  // the previous batch's reads of sface and sgroups are done
      list_bits(m, sgroups);
      __syncthreads();
      const int n = __popcll(m);
      const size_t chunk_rows = ((size_t)f * C + c) * kFaceChunk * kRowFloats;
      stage_groups(face_data + chunk_rows, sgroups, n, sface);
      __syncthreads();
      bwd_groups(sface, sgroups, n, sG, spy, px, dface + chunk_rows, inv_sigma);
      n_work += n;
    }
  }
  if (work != nullptr && threadIdx.x == 0) work[tile] = n_work;
}

// K3. S tiles of the work-list raster. face_flat (N, F8, 8); idx
// (N, T, k_sub) subgroup ids, nearest-z first; count (N, T).
__global__ void __launch_bounds__(kThreads)
worklist_fwd_kernel(const float* __restrict__ face_flat, const int* __restrict__ idx,
                    const int* __restrict__ count, float* __restrict__ S_out,
                    int* __restrict__ work, int F8, int k_sub, int H, int W, int n_tx,
                    float inv_sigma) {
  __shared__ __align__(16) float sface[kFaceChunk * kStaged];
  __shared__ int sgroups[kGroupsPerChunk];
  const int t = blockIdx.x, f = blockIdx.y;
  const size_t tile = (size_t)f * gridDim.x + t;
  const int* list = idx + tile * k_sub;
  const float* faces = face_flat + (size_t)f * F8 * kRowFloats;
  const int cnt = count[tile];
  float px, py[kPixPerThread], S[kPixPerThread] = {};
  thread_pixels(t, n_tx, H, W, px, py);
  int n_work = 0;
  for (int b0 = 0; b0 < cnt; b0 += kGroupsPerChunk) {
    if (__syncthreads_and(min_of(S) >= kSaturationS)) break;
    const int n = min(kGroupsPerChunk, cnt - b0);
    if ((int)threadIdx.x < n) sgroups[threadIdx.x] = list[b0 + threadIdx.x];
    __syncthreads();
    stage_groups(faces, sgroups, n, sface);
    __syncthreads();
    fwd_groups(sface, n, px, py, S, inv_sigma);
    n_work += n;
  }
  store_tile(S_out + tile * kTilePix, S);
  if (work != nullptr && threadIdx.x == 0) work[tile] = n_work;
}

// K4. dS/d(face rows) of the work-list raster; dface (N, F8, 8) zeroed by
// the caller.
__global__ void __launch_bounds__(kThreads)
worklist_bwd_kernel(const float* __restrict__ face_flat, const int* __restrict__ idx,
                    const int* __restrict__ count, const float* __restrict__ gS,
                    float* __restrict__ dface, int* __restrict__ work, int F8, int k_sub,
                    int H, int W, int n_tx, float inv_sigma) {
  __shared__ __align__(16) float sface[kFaceChunk * kStaged];
  __shared__ float sG[kTilePix];
  __shared__ float spy[kTileH];
  __shared__ int sgroups[kGroupsPerChunk];
  const int t = blockIdx.x, f = blockIdx.y;
  const size_t tile = (size_t)f * gridDim.x + t;
  const int* list = idx + tile * k_sub;
  const size_t frame_rows = (size_t)f * F8 * kRowFloats;
  const int cnt = count[tile];
  int n_work = 0;
  if (load_tile_grad(gS + tile * kTilePix, sG, spy, t, n_tx, H, W)) {
    const float px = ndc_x((t % n_tx) * kTileW + (int)threadIdx.x % 32, W, (float)min(H, W));
    for (int b0 = 0; b0 < cnt; b0 += kGroupsPerChunk) {
      __syncthreads();  // the previous batch's reads of sface and sgroups are done
      const int n = min(kGroupsPerChunk, cnt - b0);
      if ((int)threadIdx.x < n) sgroups[threadIdx.x] = list[b0 + threadIdx.x];
      __syncthreads();
      stage_groups(face_flat + frame_rows, sgroups, n, sface);
      __syncthreads();
      bwd_groups(sface, sgroups, n, sG, spy, px, dface + frame_rows, inv_sigma);
      n_work += n;
    }
  }
  if (work != nullptr && threadIdx.x == 0) work[tile] = n_work;
}

inline dim3 tile_grid(int N, int H, int W, int& n_tx) {
  n_tx = (W + kTileW - 1) / kTileW;
  const int n_ty = (H + kTileH - 1) / kTileH;
  return dim3((unsigned)(n_ty * n_tx), (unsigned)N);
}

}  // namespace
}  // namespace smil

using namespace smil;

extern "C" {

const char* smil_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int smil_exact_fwd(const float* face_data, const int* mask, float* S, int* work, int N, int C,
                   int H, int W, float inv_sigma, cudaStream_t stream) {
  if (N <= 0) return 0;
  int n_tx;
  const dim3 grid = tile_grid(N, H, W, n_tx);
  exact_fwd_kernel<<<grid, kThreads, 0, stream>>>(face_data, mask, S, work, C, H, W, n_tx,
                                                   inv_sigma);
  return (int)cudaGetLastError();
}

int smil_exact_bwd(const float* face_data, const int* mask, const float* gS, float* dface,
                   int* work, int N, int C, int H, int W, float inv_sigma, cudaStream_t stream) {
  if (N <= 0) return 0;
  int n_tx;
  const dim3 grid = tile_grid(N, H, W, n_tx);
  exact_bwd_kernel<<<grid, kThreads, 0, stream>>>(face_data, mask, gS, dface, work, C, H, W,
                                                   n_tx, inv_sigma);
  return (int)cudaGetLastError();
}

int smil_worklist_fwd(const float* face_flat, const int* idx, const int* count, float* S,
                      int* work, int N, int F8, int k_sub, int H, int W, float inv_sigma,
                      cudaStream_t stream) {
  if (N <= 0) return 0;
  int n_tx;
  const dim3 grid = tile_grid(N, H, W, n_tx);
  worklist_fwd_kernel<<<grid, kThreads, 0, stream>>>(face_flat, idx, count, S, work, F8, k_sub,
                                                      H, W, n_tx, inv_sigma);
  return (int)cudaGetLastError();
}

int smil_worklist_bwd(const float* face_flat, const int* idx, const int* count, const float* gS,
                      float* dface, int* work, int N, int F8, int k_sub, int H, int W,
                      float inv_sigma, cudaStream_t stream) {
  if (N <= 0) return 0;
  int n_tx;
  const dim3 grid = tile_grid(N, H, W, n_tx);
  worklist_bwd_kernel<<<grid, kThreads, 0, stream>>>(face_flat, idx, count, gS, dface, work, F8,
                                                      k_sub, H, W, n_tx, inv_sigma);
  return (int)cudaGetLastError();
}

}  // extern "C"
