// Shared device math of the soft-silhouette raster kernels (raster.cu).
//
// Per (pixel, face) pair the kernels evaluate the signed squared distance d
// from the pixel centre to the triangle in NDC xy (negative inside; the
// minimum over the three edges of the squared point-segment distance), then
// either the forward term valid·softplus(−d/σ) or its envelope gradient with
// respect to the triangle's six xy coordinates. The math follows
// smilify_tpu/render/rasterizer.py::_signed_distance and _bwd_tile_body op
// for op; the per-edge vector and reciprocal squared length are computed
// once per face when a face is staged in shared memory.

#pragma once

#include <cuda_runtime.h>

namespace smil {

constexpr int kTileW = 32;
constexpr int kTileH = 32;
constexpr int kTilePix = kTileW * kTileH;            // pixels per tile
constexpr int kThreads = 256;                        // threads per forward block (one tile)
constexpr int kPixPerThread = kTilePix / kThreads;   // forward: pixels held per thread
constexpr int kFaceGroup = 8;                        // faces per cull subgroup
constexpr int kFaceChunk = 512;                      // faces per packed chunk
constexpr int kGroupsPerChunk = kFaceChunk / kFaceGroup;
constexpr int kWords = 4;                            // 16-bit cull words per chunk
constexpr int kRowFloats = 8;                        // packed face row: ax ay bx by cx cy valid pad
constexpr int kStaged = 16;                          // floats per staged face
constexpr float kSaturationS = 20.0f;
constexpr float kGradSkip = 1e-12f;

struct Edge {
  float d, t, rx, ry, cross;
};

struct Dist {
  Edge e1, e2, e3;
  float sign, d;
};

// Squared distance from p to the segment a → a + e, its clamped parameter t,
// the residual r = p − a − t·e and the signed area e × (p − a).
__device__ __forceinline__ Edge point_segment(float px, float py, float ax, float ay,
                                              float ex, float ey, float rinv) {
  Edge e;
  const float dx = px - ax;
  const float dy = py - ay;
  e.t = fminf(fmaxf((dx * ex + dy * ey) * rinv, 0.0f), 1.0f);
  e.rx = dx - e.t * ex;
  e.ry = dy - e.t * ey;
  e.d = e.rx * e.rx + e.ry * e.ry;
  e.cross = ex * dy - ey * dx;
  return e;
}

// Staged face: a, e_ab, 1/|e_ab|², b, e_bc, 1/|e_bc|², c, e_ca, 1/|e_ca|², valid.
__device__ __forceinline__ void stage_face(const float* __restrict__ row,
                                           float* __restrict__ dst) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(row));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(row) + 1);
  const float ax = lo.x, ay = lo.y, bx = lo.z, by = lo.w, cx = hi.x, cy = hi.y;
  const float e1x = bx - ax, e1y = by - ay;
  const float e2x = cx - bx, e2y = cy - by;
  const float e3x = ax - cx, e3y = ay - cy;
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(ax, ay, e1x, e1y);
  d[1] = make_float4(1.0f / fmaxf(e1x * e1x + e1y * e1y, 1e-12f), bx, by, e2x);
  d[2] = make_float4(e2y, 1.0f / fmaxf(e2x * e2x + e2y * e2y, 1e-12f), cx, cy);
  d[3] = make_float4(e3x, e3y, 1.0f / fmaxf(e3x * e3x + e3y * e3y, 1e-12f), hi.z);
}

__device__ __forceinline__ void load_face(const float* __restrict__ src, float (&f)[kStaged]) {
  const float4* s = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int i = 0; i < kStaged / 4; ++i) {
    const float4 v = s[i];
    f[4 * i + 0] = v.x;
    f[4 * i + 1] = v.y;
    f[4 * i + 2] = v.z;
    f[4 * i + 3] = v.w;
  }
}

__device__ __forceinline__ Dist signed_distance(float px, float py, const float (&f)[kStaged]) {
  Dist s;
  s.e1 = point_segment(px, py, f[0], f[1], f[2], f[3], f[4]);
  s.e2 = point_segment(px, py, f[5], f[6], f[7], f[8], f[9]);
  s.e3 = point_segment(px, py, f[10], f[11], f[12], f[13], f[14]);
  const float dmin = fminf(fminf(s.e1.d, s.e2.d), s.e3.d);
  const bool inside = (s.e1.cross >= 0.0f && s.e2.cross >= 0.0f && s.e3.cross >= 0.0f) ||
                      (s.e1.cross <= 0.0f && s.e2.cross <= 0.0f && s.e3.cross <= 0.0f);
  s.sign = inside ? -1.0f : 1.0f;
  s.d = s.sign * dmin;
  return s;
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// Forward term of one (pixel, face) pair: valid · softplus(−d/σ).
__device__ __forceinline__ float fwd_term(float px, float py, const float (&f)[kStaged],
                                          float inv_sigma) {
  const Dist s = signed_distance(px, py, f);
  return f[15] * softplus(-s.d * inv_sigma);
}

// Adds dS/d(ax, ay, bx, by, cx, cy) of one (pixel, face) pair, weighted by
// the incoming G = dL/dS(pixel), to g. dS/dd = −sigmoid(−d/σ)/σ·sign goes to
// the argmin edge; the edge's squared distance has the envelope gradient
// ∂/∂u = −2(1−t)·r, ∂/∂v = −2t·r at its optimal t. Branch-free: the argmin
// edge's (t, r) and each vertex's weight are selects, so lanes of a warp
// that pick different edges never run apart; a vertex off the edge adds
// 0·r, which leaves its sum as it was.
__device__ __forceinline__ void bwd_term(float px, float py, float G, const float (&f)[kStaged],
                                         float inv_sigma, float (&g)[6]) {
  const Dist s = signed_distance(px, py, f);
  const float sig = 1.0f / (1.0f + expf(s.d * inv_sigma));   // sigmoid(−d/σ)
  const float wgt = G * f[15] * sig * (-inv_sigma) * s.sign;
  const float m2 = wgt * -2.0f;
  const bool e1 = s.e1.d <= s.e2.d && s.e1.d <= s.e3.d;    // edge a → b
  const bool e2 = !e1 && s.e2.d <= s.e3.d;                 // edge b → c
  const bool e3 = !e1 && !e2;                              // edge c → a
  const float t = e1 ? s.e1.t : (e2 ? s.e2.t : s.e3.t);
  const float rx = e1 ? s.e1.rx : (e2 ? s.e2.rx : s.e3.rx);
  const float ry = e1 ? s.e1.ry : (e2 ? s.e2.ry : s.e3.ry);
  const float u = m2 * (1.0f - t), v = m2 * t;             // the edge's start, end
  const float wa = e1 ? u : (e3 ? v : 0.0f);
  const float wb = e2 ? u : (e1 ? v : 0.0f);
  const float wc = e3 ? u : (e2 ? v : 0.0f);
  g[0] += wa * rx; g[1] += wa * ry;
  g[2] += wb * rx; g[3] += wb * ry;
  g[4] += wc * rx; g[5] += wc * ry;
}

// NDC coordinates of pixel centres (PyTorch3D convention: +X left, +Y up,
// the short image side spans [−1, 1]).
__device__ __forceinline__ float ndc_x(int col, int W, float s) {
  return -((float)col * 2.0f + 1.0f - (float)W) / s;
}

__device__ __forceinline__ float ndc_y(int row, int H, float s) {
  return -((float)row * 2.0f + 1.0f - (float)H) / s;
}

}  // namespace smil
