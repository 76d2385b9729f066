// Ray-cast kernel for NVIDIA Hopper (sm_90a): nearest hit of every camera
// or lidar ray against its env's primitive soup -> depth, and per mode the
// semantic id, the winner's face id and world normal, or its RGB shade.
//
// Replaces the four static modes of the TPU kernel
// aerial_gym_simulator_tpu/ops/raycast_pallas.py, raycast_pallas /
// _make_kernel (pallas_call at raycast_pallas.py:648): want_seg=False
// (kDepth), want_seg=True (kSeg), want_normals=True (kNormals) and
// want_rgb=True (kRgb). Plain version:
// aerial_gym_simulator_tpu_torch/ops/raycast_cuda.py, raycast_reference.
// Both evaluate the same expressions in the same order; this file is built
// with -fmad=false so that every multiply and add rounds on its own there
// too, and it uses IEEE division and sqrtf (no rsqrtf) wherever an output
// depends on the result.
//
// Bound on this card. Per (ray, primitive) test the kernel does 11-54 f32
// operations on data that sits in registers and shared memory, and it
// writes 4 bytes per ray (8 with seg, 24 with normal and face, 20 with
// RGB). At the main path's shapes (16384 envs x 32400 rays x 67 prims) the
// operations of the tests that a broad phase on the primitives' bounding
// spheres could not skip, over the 67 TFLOP/s f32 peak, take longer than
// the depth and seg images over 3.35 TB/s: those modes are bound by f32
// operations, not by memory. So the design
// removes tests and the work around each test.
//
// What the design does about it:
//  * 2-D ray tiles. The sensor's rays form an (H, W) grid, row-major (an
//    (R, 3) table is a grid of one row). A block of 8 warps sweeps up to 8
//    consecutive 16 x 32 patches of one env's grid, each warp an 8 x 8
//    sub-patch of each, two rays per lane (rows r and r + 4 of one column). On the 135x240 camera (87 degrees
//    HFOV) a warp's rays span about 3 x 3 degrees, on the 128x512 lidar
//    about 6 x 6; a strip of 256 consecutive rays, the tile before, spanned
//    the whole azimuth. Patches at the right and bottom edges are ragged:
//    lanes past the grid trace nothing and write nothing, and a warp with
//    no ray in the grid only takes part in the block's barriers.
//  * The block stages its env's primitive table in shared memory once for
//    all its patches (in chunks of 256 per patch where the table is larger
//    than one chunk): a 20-float record per primitive, read as five aligned
//    float4s: the rotation, the sensor origin in the primitive's frame
//    R^T (o - p), and the constants of its test that depend on the
//    primitive alone, hoisted out of the per-ray test (box slab bounds,
//    cylinder r^2, side term, half length and cap offsets, sphere c,
//    triangle -o_z and guarded divisors). Each is the plain version's
//    expression, so it rounds as there. Beside it a float4 for the broad
//    phase, with the range test done once per block.
//  * Broad phase per warp, without a block barrier: the warp's cone of
//    ray directions by shuffles, then a visibility bitmask of the chunk
//    (lane i tests primitives i, i + 32, ... with the conservative
//    sphere-in-cone test, then __ballot_sync). The sweep visits only the
//    set bits, in ascending order (__ffs), so ties still go to the lower
//    index under the strict <. The test carries a margin and holds for any
//    half-angle up to 180 degrees: a culled primitive is one whose bounding
//    sphere no ray of the warp can reach, so culling never changes an
//    output (cull=0 checks that).
//  * Every lane of a warp tests the same primitive, so the branch on its
//    kind (fixed by its index: the table is sorted box | cylinder | sphere
//    | triangle) is uniform, and one shared-memory read of a record serves
//    both of the lane's rays.
//  * the normal and RGB modes track only the winner's index in the sweep
//    (one more select per closer hit). The TPU kernel computed a normal or
//    a Lambert term for every primitive it tested, because a vector lane
//    cannot read the winner's record back; a thread can. After the sweep
//    it reloads the winner's 16 floats from device memory (they may sit in
//    an earlier chunk than the one in shared memory), recomputes the hit
//    point with the sweep's expressions, and shades once per ray. The
//    palette, sun and sky sit in constant memory.
// Kept on purpose: -fmad=false, the price of bit-equality with the plain
// version (its cost is measured in PERF.md).

#include <cuda_runtime.h>
#include <algorithm>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPatchH = 16, kPatchW = 32;   // a block's rays: 2 x 4 warp patches
constexpr int kWarpH = 8, kWarpW = 8;       // a warp's rays
constexpr int kRays = 2;                    // rays per lane: rows r and r + 4
constexpr int kChunk = 256;                 // primitives staged per pass
constexpr int kRec = 5;                     // float4s per staged primitive
constexpr int kMaxPatchesPerBlock = 8;      // patches of one env a block sweeps
constexpr long long kFillBlocks = 4096;     // fewer blocks than this: one patch each
constexpr float kBig = 1e10f;
constexpr float kNoHitRay = 1000.0f;
constexpr int kNoHitSeg = -2;
constexpr int kNoHitFace = -1;
constexpr float kTriEps = 1e-6f;

enum Mode : int { kDepth = 0, kSeg = 1, kNormals = 2, kRgb = 3 };

// RGB shading constants, copied in by raycast_set_shading: palette (10 x
// rgb, indexed by |seg| % 10), sun direction, sky colour, ambient,
// 1 - ambient
constexpr int kPalette = 10;
constexpr int kSun = 3 * kPalette, kSky = kSun + 3, kAmbient = kSky + 3;
constexpr int kShadeFloats = kAmbient + 2;
__constant__ float c_shade[kShadeFloats];

__device__ __forceinline__ float guard(float b) {
  return fabsf(b) < 1e-12f ? (b < 0.0f ? -1e-12f : 1e-12f) : b;
}

__device__ __forceinline__ float safe_div(float a, float b) { return a / guard(b); }

__device__ __forceinline__ float sgn(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// World normal of the winning primitive, oriented against the ray. rec is
// the winner's 16-float world record, kind its kind, (ox, oy, oz) the
// sensor origin, (dxw, dyw, dzw) the world ray and t its hit distance. The
// origin and direction in the primitive's frame are the sweep's
// expressions, so the hit point has the sweep's bits.
__device__ __forceinline__ void winner_normal(const float* __restrict__ rec, int kind,
                                              float ox, float oy, float oz, float dxw,
                                              float dyw, float dzw, float t, float& nx,
                                              float& ny, float& nz) {
  const float ux = ox - rec[3], uy = oy - rec[4], uz = oz - rec[5];
  if (kind == 2) {
    // sphere: radial, in the world frame
    const float hx = ux + t * dxw, hy = uy + t * dyw, hz = uz + t * dzw;
    const float len = fmaxf(sqrtf(hx * hx + hy * hy + hz * hz), 1e-9f);
    nx = hx / len;
    ny = hy / len;
    nz = hz / len;
  } else {
    float r[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) r[k] = rec[6 + k];
    const float rox = r[0] * ux + r[3] * uy + r[6] * uz;
    const float roy = r[1] * ux + r[4] * uy + r[7] * uz;
    const float roz = r[2] * ux + r[5] * uy + r[8] * uz;
    const float rdx = r[0] * dxw + r[3] * dyw + r[6] * dzw;
    const float rdy = r[1] * dxw + r[4] * dyw + r[7] * dzw;
    const float rdz = r[2] * dxw + r[5] * dyw + r[8] * dzw;
    const float hx = rox + t * rdx, hy = roy + t * rdy, hz = roz + t * rdz;
    float px = 0.0f, py = 0.0f, pz = 0.0f;
    if (kind == 0) {
      // box: dominant axis of |p| / half; x wins ties, then y
      const float qx = fabsf(hx) / fmaxf(0.5f * rec[0], 1e-9f);
      const float qy = fabsf(hy) / fmaxf(0.5f * rec[1], 1e-9f);
      const float qz = fabsf(hz) / fmaxf(0.5f * rec[2], 1e-9f);
      if (qx >= qy && qx >= qz) px = sgn(hx);
      else if (qy >= qz) py = sgn(hy);
      else pz = sgn(hz);
    } else if (kind == 1) {
      // cylinder: the cap within 1e-4 of |z| = h/2, else radial
      if (fabsf(fabsf(hz) - 0.5f * rec[1]) < 1e-4f) {
        pz = sgn(hz);
      } else {
        const float len = fmaxf(sqrtf(hx * hx + hy * hy), 1e-9f);
        px = hx / len;
        py = hy / len;
      }
    } else {
      pz = 1.0f;  // triangle: +z of its frame
    }
    nx = r[0] * px + r[1] * py + r[2] * pz;
    ny = r[3] * px + r[4] * py + r[5] * pz;
    nz = r[6] * px + r[7] * py + r[8] * pz;
  }
  if (nx * dxw + ny * dyw + nz * dzw > 0.0f) {
    nx = -nx;
    ny = -ny;
    nz = -nz;
  }
}

// Staged record of a primitive (20 floats, five float4s):
//   [0..8]   R, row-major (box, cylinder, triangle)
//   [9..11]  R^T (o - p), the sensor origin in the primitive's frame; a
//            sphere keeps o - p (world frame) there
//   [12..18] the test's constants that depend on the primitive alone
//   [19]     the semantic id
// Each constant is the plain version's expression on the same inputs, so
// it rounds as there; the broad phase's float4 is the bounding sphere's
// centre relative to the origin and its radius with margin (-inf beyond
// max_range, +inf with the broad phase off).
__device__ __forceinline__ void stage_record(const float* __restrict__ src, int kind, float ox,
                                             float oy, float oz, float max_range, int cull,
                                             float4* rec, float4* vis) {
  float d[16];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 f = reinterpret_cast<const float4*>(src)[k];
    d[4 * k] = f.x;
    d[4 * k + 1] = f.y;
    d[4 * k + 2] = f.z;
    d[4 * k + 3] = f.w;
  }
  const float ux = ox - d[3], uy = oy - d[4], uz = oz - d[5];
  float r[4 * kRec];
#pragma unroll
  for (int k = 0; k < 9; ++k) r[k] = d[6 + k];
#pragma unroll
  for (int k = 12; k < 19; ++k) r[k] = 0.0f;
  r[19] = d[15];
  if (kind == 2) {
    // sphere: world frame; c = |o - p|^2 - r^2
    r[9] = ux;
    r[10] = uy;
    r[11] = uz;
    r[12] = (ux * ux + uy * uy + uz * uz) - d[0] * d[0];
  } else {
    const float rox = d[6] * ux + d[9] * uy + d[12] * uz;
    const float roy = d[7] * ux + d[10] * uy + d[13] * uz;
    const float roz = d[8] * ux + d[11] * uy + d[14] * uz;
    r[9] = rox;
    r[10] = roy;
    r[11] = roz;
    if (kind == 0) {
      // box: slab bounds -h - o and h - o per axis, h = size / 2
      const float hx = 0.5f * d[0], hy = 0.5f * d[1], hz = 0.5f * d[2];
      r[12] = -hx - rox;
      r[13] = hx - rox;
      r[14] = -hy - roy;
      r[15] = hy - roy;
      r[16] = -hz - roz;
      r[17] = hz - roz;
    } else if (kind == 1) {
      // cylinder: r^2, the side's c, h/2, the caps' offsets +-h/2 - o_z
      const float half = 0.5f * d[1];
      r[12] = d[0] * d[0];
      r[13] = (rox * rox + roy * roy) - d[0] * d[0];
      r[14] = half;
      r[15] = half - roz;
      r[16] = -half - roz;
    } else {
      // triangle: -o_z, a, b, and the guarded divisors c and a
      r[12] = -roz;
      r[13] = d[0];
      r[14] = d[1];
      r[15] = guard(d[2]);
      r[16] = guard(d[0]);
    }
  }
#pragma unroll
  for (int k = 0; k < kRec; ++k)
    rec[k] = make_float4(r[4 * k], r[4 * k + 1], r[4 * k + 2], r[4 * k + 3]);
  // bounding sphere about the table position: box half-diagonal, cylinder
  // corner radius, sphere radius, triangle's longest edge from its first
  // vertex
  float bm = CUDART_INF_F;
  if (cull) {
    const float sx = d[0], sy = d[1], sz = d[2];
    float bound;
    if (kind == 0) bound = 0.5f * sqrtf(sx * sx + sy * sy + sz * sz);
    else if (kind == 1) bound = sqrtf(sx * sx + 0.25f * sy * sy);
    else if (kind == 2) bound = sx;
    else bound = fmaxf(sx, sqrtf(sy * sy + sz * sz));
    const float dist = sqrtf(ux * ux + uy * uy + uz * uz);
    const float margin = 1e-3f * (1.0f + dist + bound);
    bm = dist < max_range + bound + margin ? bound + margin : -CUDART_INF_F;
  }
  *vis = make_float4(-ux, -uy, -uz, bm);
}

// R^T d for a world ray d: the columns of the row-major R in the record
__device__ __forceinline__ void frame_dir(const float4* rec, float dx, float dy, float dz,
                                          float& rdx, float& rdy, float& rdz) {
  const float4 a = rec[0], b = rec[1], c = rec[2];
  rdx = a.x * dx + a.w * dy + b.z * dz;
  rdy = a.y * dx + b.x * dy + b.w * dz;
  rdz = a.z * dx + b.y * dy + c.x * dz;
}

// The per-ray tests on a staged record: the plain version's ray_box,
// ray_cylinder, ray_sphere and ray_triangle (ops/raycast.py) with the
// hoisted constants. Each returns t > 0 of the nearest hit or kBig.
__device__ __forceinline__ float test_box(const float4* rec, float dx, float dy, float dz) {
  float rdx, rdy, rdz;
  frame_dir(rec, dx, dy, dz, rdx, rdy, rdz);
  const float4 k0 = rec[3], k1 = rec[4];
  const float ix = safe_div(1.0f, rdx);
  const float iy = safe_div(1.0f, rdy);
  const float iz = safe_div(1.0f, rdz);
  const float t1x = k0.x * ix, t2x = k0.y * ix;
  const float t1y = k0.z * iy, t2y = k0.w * iy;
  const float t1z = k1.x * iz, t2z = k1.y * iz;
  const float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
  const float tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
  const bool hit = tmax >= fmaxf(tmin, 0.0f);
  const float t = tmin > 0.0f ? tmin : tmax;
  return (hit && t > 0.0f) ? t : kBig;
}

// sphere of the record's c about o - p, in the world frame
__device__ __forceinline__ float test_sphere(const float4* rec, float dx, float dy, float dz) {
  const float4 o = rec[2], k = rec[3];
  const float b = o.y * dx + o.z * dy + o.w * dz;
  const float disc = b * b - k.x;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float t0 = -b - sq;
  const float t1 = -b + sq;
  const float t = t0 > 0.0f ? t0 : t1;
  return (disc >= 0.0f && t > 0.0f) ? t : kBig;
}

// a cap at offset zc - o_z along z, radius^2 rr
__device__ __forceinline__ float cyl_cap(float off, float rox, float roy, float rdx, float rdy,
                                         float rdz, float rr) {
  const float t = safe_div(off, rdz);
  const float x = rox + t * rdx;
  const float y = roy + t * rdy;
  const bool ok = t > 0.0f && (x * x + y * y <= rr) && fabsf(rdz) > 1e-12f;
  return ok ? t : kBig;
}

// capped z-aligned cylinder
__device__ __forceinline__ float test_cylinder(const float4* rec, float dx, float dy,
                                               float dz) {
  float rdx, rdy, rdz;
  frame_dir(rec, dx, dy, dz, rdx, rdy, rdz);
  const float4 o = rec[2], k0 = rec[3], k1 = rec[4];
  const float rox = o.y, roy = o.z, roz = o.w;
  const float rr = k0.x, c = k0.y, half = k0.z;
  const float a = rdx * rdx + rdy * rdy;
  const float b = rox * rdx + roy * rdy;
  const float disc = b * b - a * c;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float inv_a = safe_div(1.0f, a);
  const float ts0 = (-b - sq) * inv_a;
  const float ts1 = (-b + sq) * inv_a;
  const float z0 = roz + ts0 * rdz;
  const float z1 = roz + ts1 * rdz;
  const bool base = disc >= 0.0f && a > 1e-12f;
  const float s0 = (base && ts0 > 0.0f && fabsf(z0) <= half) ? ts0 : kBig;
  const float s1 = (base && ts1 > 0.0f && fabsf(z1) <= half) ? ts1 : kBig;
  const float c0 = cyl_cap(k0.w, rox, roy, rdx, rdy, rdz, rr);
  const float c1 = cyl_cap(k1.x, rox, roy, rdx, rdy, rdz, rr);
  return fminf(fminf(s0, s1), fminf(c0, c1));
}

// two-sided triangle in its own frame: z = 0 plane, vertices (0,0), (a,0), (b,c)
__device__ __forceinline__ float test_triangle(const float4* rec, float dx, float dy,
                                               float dz) {
  float rdx, rdy, rdz;
  frame_dir(rec, dx, dy, dz, rdx, rdy, rdz);
  const float4 o = rec[2], k0 = rec[3], k1 = rec[4];
  const float t = safe_div(k0.x, rdz);
  const float x = o.y + t * rdx;
  const float y = o.z + t * rdy;
  const float v = y / k0.w;
  const float u = (x - v * k0.z) / k1.x;
  const bool ok = t > 0.0f && fabsf(rdz) > 1e-9f && u >= -kTriEps && v >= -kTriEps &&
                  (u + v <= 1.0f + kTriEps) && k0.y > 0.0f;
  return ok ? t : kBig;
}

// warp-wide sum and min; every lane gets the result
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
raycast_kernel(const float* __restrict__ pose, const float* __restrict__ prims,
               const float* __restrict__ dirs, const float* __restrict__ mult,
               float* __restrict__ depth, int* __restrict__ seg, int* __restrict__ face,
               float* __restrict__ vec, int H, int W, int P, int n_box, int n_cyl, int n_sph,
               float max_range, int cull, int per_block) {
  __shared__ float4 sp[kChunk * kRec];
  __shared__ float4 sv[kChunk];

  // block -> (env, per_block consecutive patches); warp -> its 8 x 8
  // sub-patch of each; lane -> one column, rows r and r + 4
  const int patches_w = (W + kPatchW - 1) / kPatchW;
  const int patches = ((H + kPatchH - 1) / kPatchH) * patches_w;
  const int groups = (patches + per_block - 1) / per_block;
  const int env = blockIdx.x / groups;
  const int first = (blockIdx.x - env * groups) * per_block;
  const int last = min(first + per_block, patches);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kWarpsW = kPatchW / kWarpW;
  const float* ps = pose + (size_t)env * 8;
  const float ox = ps[0], oy = ps[1], oz = ps[2];
  const float qx = ps[3], qy = ps[4], qz = ps[5], qw = ps[6];
  const float w2 = 2.0f * qw * qw - 1.0f;
  const float tw = 2.0f * qw;
  const int n_cs = n_box + n_cyl, n_css = n_cs + n_sph;
  const float* env_prims = prims + (size_t)env * P * 16;
  const int R = H * W;

  // the env's table, staged once for all of the block's patches when it is
  // one chunk (then the warps run through their patches without a block
  // barrier); a larger table is staged chunk by chunk for every patch
  const bool one_chunk = P <= kChunk;
  auto stage = [&](int base) {
    const int cnt = min(kChunk, P - base);
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      const int p = base + j;
      const int kind = p < n_box ? 0 : p < n_cs ? 1 : p < n_css ? 2 : 3;
      stage_record(env_prims + (size_t)p * 16, kind, ox, oy, oz, max_range, cull,
                   sp + j * kRec, sv + j);
    }
  };
  if (one_chunk) {
    stage(0);
    __syncthreads();
  }

  for (int patch = first; patch < last; ++patch) {
    const int row0 = (patch / patches_w) * kPatchH + (warp / kWarpsW) * kWarpH + lane / kWarpW;
    const int col = (patch % patches_w) * kPatchW + (warp % kWarpsW) * kWarpW + lane % kWarpW;

    int ray[kRays];
    bool valid[kRays];
    float dxw[kRays], dyw[kRays], dzw[kRays], t_best[kRays];
    int id_best[kRays];   // semantic id (kSeg) or table index (kNormals, kRgb)
#pragma unroll
    for (int i = 0; i < kRays; ++i) {
      const int row = row0 + i * (kWarpH / kRays);
      valid[i] = row < H && col < W;
      ray[i] = row * W + col;
      // sensor-frame direction -> world (quat_rotate, plain version's order)
      float dx = 0.0f, dy = 0.0f, dz = 1.0f;
      if (valid[i]) {
        dx = dirs[3 * ray[i]];
        dy = dirs[3 * ray[i] + 1];
        dz = dirs[3 * ray[i] + 2];
      }
      const float cx = qy * dz - qz * dy;
      const float cy = qz * dx - qx * dz;
      const float cz = qx * dy - qy * dx;
      const float td = 2.0f * (qx * dx + qy * dy + qz * dz);
      dxw[i] = dx * w2 + cx * tw + qx * td;
      dyw[i] = dy * w2 + cy * tw + qy * td;
      dzw[i] = dz * w2 + cz * tw + qz * td;
      t_best[i] = kBig;
      id_best[i] = kMode == kSeg ? kNoHitSeg : kNoHitFace;
    }
    const bool warp_live = __any_sync(0xffffffffu, valid[0] || valid[1]);

    // this warp's view cone: axis = normalized mean direction, half-angle
    // from the widest ray, widened a little so the test stays conservative.
    // The half-angle may pass 90 degrees (cos_h < 0): the cone test is the
    // signed distance to the cone's surface for any half-angle, and a mean of
    // exactly zero leaves the axis at 0, which keeps everything.
    float ax = 0.0f, ay = 0.0f, az = 1.0f, cos_h = -1.0f, sin_h = 0.0f;
    if (cull && warp_live) {
      float ux[kRays], uy[kRays], uz[kRays];
      float sx = 0.0f, sy = 0.0f, sz = 0.0f;
#pragma unroll
      for (int i = 0; i < kRays; ++i) {
        const float inv_len =
            valid[i] ? rsqrtf(dxw[i] * dxw[i] + dyw[i] * dyw[i] + dzw[i] * dzw[i]) : 0.0f;
        ux[i] = dxw[i] * inv_len;
        uy[i] = dyw[i] * inv_len;
        uz[i] = dzw[i] * inv_len;
        sx += ux[i];
        sy += uy[i];
        sz += uz[i];
      }
      ax = warp_sum(sx);
      ay = warp_sum(sy);
      az = warp_sum(sz);
      const float inv_a = rsqrtf(fmaxf(ax * ax + ay * ay + az * az, 1e-30f));
      ax *= inv_a;
      ay *= inv_a;
      az *= inv_a;
      float dot = 1.0f;
#pragma unroll
      for (int i = 0; i < kRays; ++i)
        if (valid[i]) dot = fminf(dot, ax * ux[i] + ay * uy[i] + az * uz[i]);
      cos_h = fminf(fmaxf(warp_min(dot) - 1e-5f, -1.0f), 1.0f);
      sin_h = sqrtf(fmaxf(1.0f - cos_h * cos_h, 0.0f));
    }

    for (int base = 0; base < P; base += kChunk) {
      const int cnt = min(kChunk, P - base);
      if (!one_chunk) {
        __syncthreads();  // previous chunk fully consumed
        stage(base);
        __syncthreads();
      }
      if (!warp_live) continue;
      for (int w = 0; w * 32 < cnt; ++w) {
        // which of primitives 32w .. 32w + 31 this warp's rays can reach
        const int j = w * 32 + lane;
        bool keep = false;
        if (j < cnt) {
          const float4 c = sv[j];
          const float along = ax * c.x + ay * c.y + az * c.z;
          const float px = ay * c.z - az * c.y, py = az * c.x - ax * c.z,
                      pz = ax * c.y - ay * c.x;
          const float perp = sqrtf(px * px + py * py + pz * pz);
          keep = perp * cos_h - along * sin_h <= c.w;
        }
        unsigned bits = __ballot_sync(0xffffffffu, keep);
        while (bits) {   // ascending table order
          const int jj = w * 32 + __ffs(bits) - 1;
          bits &= bits - 1;
          const int p = base + jj;
          const float4* rec = sp + jj * kRec;
          float t[kRays];
          if (p < n_box) {
#pragma unroll
            for (int i = 0; i < kRays; ++i) t[i] = test_box(rec, dxw[i], dyw[i], dzw[i]);
          } else if (p < n_cs) {
#pragma unroll
            for (int i = 0; i < kRays; ++i) t[i] = test_cylinder(rec, dxw[i], dyw[i], dzw[i]);
          } else if (p < n_css) {
#pragma unroll
            for (int i = 0; i < kRays; ++i) t[i] = test_sphere(rec, dxw[i], dyw[i], dzw[i]);
          } else {
#pragma unroll
            for (int i = 0; i < kRays; ++i) t[i] = test_triangle(rec, dxw[i], dyw[i], dzw[i]);
          }
#pragma unroll
          for (int i = 0; i < kRays; ++i) {
            // strict < : the first primitive in table order wins ties
            if (t[i] < t_best[i]) {
              t_best[i] = t[i];
              if (kMode == kSeg) id_best[i] = (int)rec[4].w;
              if (kMode >= kNormals) id_best[i] = p;
            }
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kRays; ++i) {
      if (!valid[i]) continue;
      const float tb = t_best[i];
      const bool miss = tb >= fminf(max_range, 0.5f * kBig);
      const size_t out = (size_t)env * R + ray[i];
      int s_best = id_best[i];
      float nx = 0.0f, ny = 0.0f, nz = 0.0f;
      if (kMode >= kNormals && !miss) {
        // the winner's record, from device memory: any chunk
        const float* rec = env_prims + (size_t)id_best[i] * 16;
        s_best = (int)rec[15];
        const int p_best = id_best[i];
        const int kind = p_best < n_box ? 0 : p_best < n_cs ? 1 : p_best < n_css ? 2 : 3;
        winner_normal(rec, kind, ox, oy, oz, dxw[i], dyw[i], dzw[i], tb, nx, ny, nz);
      }
      if (kMode == kRgb) {
        // Lambert shade of the winner on its true depth (range x multiplier),
        // faded to half brightness at max_range; sky on a miss
        const float depth_px = tb * mult[ray[i]];
        depth[out] = miss ? kNoHitRay : depth_px;
        seg[out] = miss ? kNoHitSeg : s_best;
        float* rgb = vec + 3 * out;
        if (miss) {
          rgb[0] = c_shade[kSky];
          rgb[1] = c_shade[kSky + 1];
          rgb[2] = c_shade[kSky + 2];
          continue;
        }
        const float lam =
            fabsf(nx * c_shade[kSun] + ny * c_shade[kSun + 1] + nz * c_shade[kSun + 2]);
        const float shade = c_shade[kAmbient] + c_shade[kAmbient + 1] * lam;
        const float ratio = depth_px / max_range;
        const float lit = shade * (1.0f - 0.5f * fminf(fmaxf(ratio, 0.0f), 1.0f));
        const int k = 3 * (abs(s_best) % kPalette);
        rgb[0] = c_shade[k] * lit;
        rgb[1] = c_shade[k + 1] * lit;
        rgb[2] = c_shade[k + 2] * lit;
        continue;
      }
      depth[out] = (miss ? kNoHitRay : tb) * mult[ray[i]];
      if (kMode != kDepth) seg[out] = miss ? kNoHitSeg : s_best;
      if (kMode == kNormals) {
        face[out] = miss ? kNoHitFace : id_best[i];
        vec[3 * out] = nx;
        vec[3 * out + 1] = ny;
        vec[3 * out + 2] = nz;
      }
    }
  }
}

template <int kMode>
void launch(const dim3& grid, cudaStream_t s, const void* pose, const void* prims,
            const void* dirs, const void* mult, void* depth, void* seg, void* face, void* vec,
            int H, int W, int P, int n_box, int n_cyl, int n_sph, float max_range, int cull,
            int per_block) {
  raycast_kernel<kMode><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(pose), static_cast<const float*>(prims),
      static_cast<const float*>(dirs), static_cast<const float*>(mult),
      static_cast<float*>(depth), static_cast<int*>(seg), static_cast<int*>(face),
      static_cast<float*>(vec), H, W, P, n_box, n_cyl, n_sph, max_range, cull, per_block);
}

}  // namespace

// The rays are an (H, W) grid, row-major. One block per env and run of up
// to kMaxPatchesPerBlock consecutive 16 x 32 patches, env-major: the block
// stages the env's table once for all of them, and the blocks of one env
// run close together and find its table in L2. Small launches keep one
// patch a block, so that they still fill the card.
extern "C" int raycast_launch(const void* pose, const void* prims, const void* dirs,
                              const void* mult, void* depth, void* seg, void* face,
                              void* vec, int N, int H, int W, int P, int n_box, int n_cyl,
                              int n_sph, int n_tri, float max_range, int cull, int mode,
                              void* stream) {
  (void)n_tri;  // triangles are the columns after the spheres
  const long long patches =
      (long long)((H + kPatchH - 1) / kPatchH) * ((W + kPatchW - 1) / kPatchW);
  if (patches * N > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = static_cast<int>(
      std::max(1LL, std::min((long long)kMaxPatchesPerBlock, patches * N / kFillBlocks)));
  const dim3 grid(static_cast<unsigned>(N * ((patches + per_block - 1) / per_block)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kDepth:
      launch<kDepth>(grid, s, pose, prims, dirs, mult, depth, seg, face, vec, H, W, P, n_box,
                     n_cyl, n_sph, max_range, cull, per_block);
      break;
    case kSeg:
      launch<kSeg>(grid, s, pose, prims, dirs, mult, depth, seg, face, vec, H, W, P, n_box,
                   n_cyl, n_sph, max_range, cull, per_block);
      break;
    case kNormals:
      launch<kNormals>(grid, s, pose, prims, dirs, mult, depth, seg, face, vec, H, W, P, n_box,
                       n_cyl, n_sph, max_range, cull, per_block);
      break;
    case kRgb:
      launch<kRgb>(grid, s, pose, prims, dirs, mult, depth, seg, face, vec, H, W, P, n_box,
                   n_cyl, n_sph, max_range, cull, per_block);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Copy the RGB mode's constants (kShadeFloats floats from host memory) into
// constant memory of the current device.
extern "C" int raycast_set_shading(const void* table, int n) {
  if (n != kShadeFloats) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMemcpyToSymbol(c_shade, table, n * sizeof(float)));
}

extern "C" const char* raycast_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
