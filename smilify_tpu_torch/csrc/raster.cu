// Soft-silhouette raster kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (smilify_tpu_torch/render/_kernels.py).
//
// They replace the four Pallas TPU kernels of the JAX package:
//   exact_fwd_kernel     ← smilify_tpu/render/rasterizer.py::_fwd_kernel (K1)
//   exact_bwd_kernel     ← smilify_tpu/render/rasterizer.py::_bwd_kernel (K2)
//   worklist_fwd_kernel  ← smilify_tpu/render/rasterizer_worklist.py::_wl_fwd_kernel (K3)
//   worklist_bwd_kernel  ← smilify_tpu/render/rasterizer_worklist.py::_wl_bwd_kernel (K4)
//
// What bounds them on this card: FP32 and transcendental (MUFU) throughput
// on the (pixel, face) pairs the cull admits — about 70 FP32 operations, an
// exp and a log1p per pair forward, 90 operations, an exp and a reciprocal
// backward. The bytes are small: the packed face rows and the cull words or
// work lists plus S are under 2 MB a frame at 512² and ~6k faces, read from
// L2. Tensor cores, TMA and wgmma do not apply: the work is elementwise FP32
// with a per-edge min and clamp, no matrix product, and the face rows a
// block reads are a data-dependent gather of a few KB that L2 holds.
//
// Forward (K1, K3). One block of 256 threads per (tile of 32×32 pixels,
// frame); the TPU's sequential grid axis over face chunks becomes a loop
// inside the block. A batch of up to 64 admitted 8-face subgroups (one
// chunk's set cull bits, or 64 work-list entries) is staged in shared
// memory, each face with its edge vectors and reciprocal squared edge
// lengths precomputed, so the per-pixel loop reads every face as a
// broadcast. Each thread keeps 4 pixels (one column, rows 8 apart) and
// their S in registers. The saturation early-out (every pixel S ≥ 20) is one
// __syncthreads_and per batch, not per subgroup.
//
// Backward (K2, K4). The gradient has no early-out and no order, so a
// tile's faces are split over many blocks: one block per (tile, slice of
// the tile's faces, frame). K2's slice is kK2Slice cull bits (8-face
// subgroups) of one chunk, K4's a span of kK4Span work-list entries (8 and
// 4: 64 and 32 faces). Only the ~20-40 tiles the mesh touches
// have work; with one block a tile the kernels left most of the 132 SMs
// idle, and the densest tile set the time. A block first reads its slice's
// cull word or its tile's list count and leaves at once when they hold no
// work. A working block loads its tile's dS and leaves when the whole
// tile's |dS| ≤ kGradSkip: the skip stays a tile's, as in the plain
// version, so every block of a tile tests all 1,024 pixels. It stages only
// its slice's faces in shared memory (2-4 KB, plus 4 KB of dS), so many
// blocks share an SM, and the launch bound holds a thread to 64 registers.
// Warp w takes the staged faces w, w + kBwdWarps, ...; a lane walks the 32
// rows of one tile column; the six xy sums go through warp shuffles and
// lane 0 adds them to dface with atomicAdd. A face lies in one slice of a
// tile, so it gets one set of atomics a (tile, frame), as with one block a
// tile. Tiles and slices run in parallel (the TPU summed in grid order), so
// the order of the sums, and the last bits of dface, vary run to run.
// `work` counts a tile's subgroups over its blocks with atomicAdd, so its
// caller zeroes it.

#include "raster.cuh"

#include <cstdint>

namespace smil {

// The backward kernels' launch shape: the fastest at 1 frame of the shapes
// scripts/bwd_sweep.py timed (PERF.md).
constexpr int kBwdThreads = 256;                        // threads a backward block
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kK2Slice = 8;                             // subgroups (cull bits) a K2 block takes
constexpr int kK2Slices = kGroupsPerChunk / kK2Slice;   // K2 blocks a (tile, chunk)
constexpr unsigned long long kK2SliceMask =
    kK2Slice == 64 ? ~0ull : (1ull << kK2Slice) - 1ull;
constexpr int kK4Span = 4;                              // list entries a K4 block takes
// 64 registers a thread: 1,024 resident threads an SM
constexpr int kBwdMinBlocks = 1024 / kBwdThreads;
static_assert(kBwdThreads % 32 == 0 && kBwdThreads >= kK2Slice && kBwdThreads >= kK4Span &&
              kBwdThreads >= kTileH && kGroupsPerChunk % kK2Slice == 0,
              "a backward block's threads must cover its slice, and slices a chunk");

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

// Backward set-up, after the block's sgroups are written: the tile's
// incoming dS into sG, the NDC y of its rows into spy; returns (to every
// thread, past a barrier) whether any |dS| of the whole tile > kGradSkip.
__device__ __forceinline__ bool load_tile_grad(const float* __restrict__ gS, float* sG,
                                               float* spy, int t, int n_tx, int H, int W) {
  bool any = false;
  for (int q = threadIdx.x; q < kTilePix / 4; q += kBwdThreads) {
    const float4 G = __ldg(reinterpret_cast<const float4*>(gS) + q);
    reinterpret_cast<float4*>(sG)[q] = G;
    any |= fmaxf(fmaxf(fabsf(G.x), fabsf(G.y)), fmaxf(fabsf(G.z), fabsf(G.w))) > kGradSkip;
  }
  if (threadIdx.x < kTileH)
    spy[threadIdx.x] = ndc_y((t / n_tx) * kTileH + threadIdx.x, H, (float)min(H, W));
  return __syncthreads_or(any);
}

// Stages the faces of the n subgroups sgroups[0..n) of the face rows at
// `faces` (a backward block's slice).
__device__ __forceinline__ void stage_slice(const float* __restrict__ faces, const int* sgroups,
                                            int n, float* sface) {
  for (int j = threadIdx.x; j < n * kFaceGroup; j += kBwdThreads) {
    const int face = sgroups[j / kFaceGroup] * kFaceGroup + j % kFaceGroup;
    stage_face(faces + (size_t)face * kRowFloats, sface + j * kStaged);
  }
}

// Backward over a staged slice: warp w takes staged faces w, w + kBwdWarps,
// ...; lane l sums the gradient over column l of the tile; lane 0 adds the
// warp's sum to the face's row of dface (rows of the subgroups in sgroups,
// based at `dface`).
__device__ __forceinline__ void bwd_slice(const float* sface, const int* sgroups, int n,
                                          const float* sG, const float* spy, float px,
                                          float* __restrict__ dface, float inv_sigma) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int j = warp; j < n * kFaceGroup; j += kBwdWarps) {
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

// K2. dS/d(face rows) of the exact raster, one block per (tile, slice of
// kK2Slice subgroups of chunk c, frame); grid (T, C·kK2Slices, N).
// dface and work (N·T, or null) zeroed by the caller.
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
exact_bwd_kernel(const float* __restrict__ face_data, const int* __restrict__ mask,
                 const float* __restrict__ gS, float* __restrict__ dface,
                 int* __restrict__ work, int C, int H, int W, int n_tx, float inv_sigma) {
  __shared__ __align__(16) float sface[kK2Slice * kFaceGroup * kStaged];
  __shared__ __align__(16) float sG[kTilePix];
  __shared__ float spy[kTileH];
  __shared__ int sgroups[kK2Slice];
  const int t = blockIdx.x, c = blockIdx.y / kK2Slices, f = blockIdx.z;
  const int g0 = (blockIdx.y % kK2Slices) * kK2Slice;   // the slice's first subgroup
  const size_t tile = (size_t)f * gridDim.x + t;
  // the slice's cull bits first: a block without work leaves before it
  // touches dS (block-uniform: every thread read the same words)
  const unsigned long long m = (chunk_bits(mask + (tile * C + c) * kWords) >> g0) & kK2SliceMask;
  if (m == 0ull) return;
  const int i = threadIdx.x;
  if (i < kK2Slice && ((m >> i) & 1ull))
    sgroups[__popcll(m & ((1ull << i) - 1ull))] = g0 + i;   // subgroup of chunk c
  if (!load_tile_grad(gS + tile * kTilePix, sG, spy, t, n_tx, H, W)) return;
  const int n = __popcll(m);
  const size_t chunk_rows = ((size_t)f * C + c) * kFaceChunk * kRowFloats;
  stage_slice(face_data + chunk_rows, sgroups, n, sface);
  __syncthreads();
  const float px = ndc_x((t % n_tx) * kTileW + (int)threadIdx.x % 32, W, (float)min(H, W));
  bwd_slice(sface, sgroups, n, sG, spy, px, dface + chunk_rows, inv_sigma);
  if (work != nullptr && threadIdx.x == 0) atomicAdd(work + tile, n);
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

// K4. dS/d(face rows) of the work-list raster, one block per (tile, span of
// kK4Span list entries, frame); grid (T, ⌈k_sub/kK4Span⌉, N). dface
// (N, F8, 8) and work (N·T, or null) zeroed by the caller.
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
worklist_bwd_kernel(const float* __restrict__ face_flat, const int* __restrict__ idx,
                    const int* __restrict__ count, const float* __restrict__ gS,
                    float* __restrict__ dface, int* __restrict__ work, int F8, int k_sub,
                    int H, int W, int n_tx, float inv_sigma) {
  __shared__ __align__(16) float sface[kK4Span * kFaceGroup * kStaged];
  __shared__ __align__(16) float sG[kTilePix];
  __shared__ float spy[kTileH];
  __shared__ int sgroups[kK4Span];
  const int t = blockIdx.x, s0 = blockIdx.y * kK4Span, f = blockIdx.z;
  const size_t tile = (size_t)f * gridDim.x + t;
  // the tile's list length first: a span past it leaves before it touches dS
  const int n = min(kK4Span, __ldg(count + tile) - s0);
  if (n <= 0) return;
  if ((int)threadIdx.x < n) sgroups[threadIdx.x] = __ldg(idx + tile * k_sub + s0 + threadIdx.x);
  if (!load_tile_grad(gS + tile * kTilePix, sG, spy, t, n_tx, H, W)) return;
  const size_t frame_rows = (size_t)f * F8 * kRowFloats;
  stage_slice(face_flat + frame_rows, sgroups, n, sface);
  __syncthreads();
  const float px = ndc_x((t % n_tx) * kTileW + (int)threadIdx.x % 32, W, (float)min(H, W));
  bwd_slice(sface, sgroups, n, sG, spy, px, dface + frame_rows, inv_sigma);
  if (work != nullptr && threadIdx.x == 0) atomicAdd(work + tile, n);
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
  if (N <= 0 || C <= 0) return 0;
  int n_tx;
  const dim3 tiles = tile_grid(N, H, W, n_tx);
  const dim3 grid(tiles.x, (unsigned)(C * kK2Slices), (unsigned)N);
  exact_bwd_kernel<<<grid, kBwdThreads, 0, stream>>>(face_data, mask, gS, dface, work, C, H, W,
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
  if (N <= 0 || k_sub <= 0) return 0;
  int n_tx;
  const dim3 tiles = tile_grid(N, H, W, n_tx);
  const dim3 grid(tiles.x, (unsigned)((k_sub + kK4Span - 1) / kK4Span), (unsigned)N);
  worklist_bwd_kernel<<<grid, kBwdThreads, 0, stream>>>(face_flat, idx, count, gS, dface, work,
                                                         F8, k_sub, H, W, n_tx, inv_sigma);
  return (int)cudaGetLastError();
}

}  // extern "C"
