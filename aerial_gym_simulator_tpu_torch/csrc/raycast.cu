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
// Bound on this card. Per (ray, primitive) test the kernel does 20-50 f32
// operations on data that sits in registers and shared memory, and it
// writes 4 bytes per ray (8 with seg, 24 with normal and face, 20 with
// RGB). At the main path's shapes (16384 envs x 32400 rays x 67 prims) the
// operations, over the 67 TFLOP/s f32 peak, take several times longer than
// the image writes over 3.35 TB/s: the kernel is bound by f32 operations,
// not by memory.
//
// What the design does about it:
//  * one thread per ray, one block per (env, tile of 256 rays): the ray
//    direction is rotated to world once, and the running minimum lives in
//    a register; nothing per (ray, primitive) touches device memory;
//  * the block stages its env's primitive table in shared memory (20
//    floats per primitive: the 16-float world record, the sensor origin
//    pre-transformed into the primitive's frame, and a visibility flag),
//    in chunks of 256 primitives for larger scenes;
//  * a conservative broad phase computed in the block removes work: a
//    primitive whose bounding sphere is beyond max_range, or outside the
//    cone of the tile's ray directions, is skipped. Both tests carry a
//    margin and hold for any half-angle up to 180 degrees (a 360-degree
//    lidar tile spans 180 degrees of azimuth), so skipping never changes
//    an output (cull=0 checks that);
//  * the flag is the same for all threads of a block, so the skip is a
//    uniform branch, and the kind of a primitive is fixed by its index
//    (the table is sorted box | cylinder | sphere | triangle), so warps do
//    not diverge on it;
//  * the normal and RGB modes track only the winner's index in the sweep
//    (one more select per closer hit). The TPU kernel computed a normal or
//    a Lambert term for every primitive it tested, because a vector lane
//    cannot read the winner's record back; a thread can. After the sweep
//    it reloads the winner's 16 floats from device memory (they may sit in
//    an earlier chunk than the one in shared memory), recomputes the hit
//    point with the sweep's expressions, and shades once per ray. The
//    palette, sun and sky sit in constant memory.
// Making it fast (fused multiply-add, tighter tiles, a sweep in registers)
// is later work; this version is simple and exact first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // rays per block
constexpr int kChunk = 256;          // primitives staged per pass
constexpr int kStride = 20;          // floats per staged primitive
constexpr int kVis = 19;             // offset of the visibility flag
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

// Slab test in the box frame; half extents hx, hy, hz.
__device__ __forceinline__ float ray_box(float rox, float roy, float roz, float rdx,
                                         float rdy, float rdz, float hx, float hy,
                                         float hz) {
  const float ix = safe_div(1.0f, rdx);
  const float iy = safe_div(1.0f, rdy);
  const float iz = safe_div(1.0f, rdz);
  const float t1x = (-hx - rox) * ix, t2x = (hx - rox) * ix;
  const float t1y = (-hy - roy) * iy, t2y = (hy - roy) * iy;
  const float t1z = (-hz - roz) * iz, t2z = (hz - roz) * iz;
  const float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
  const float tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
  const bool hit = tmax >= fmaxf(tmin, 0.0f);
  const float t = tmin > 0.0f ? tmin : tmax;
  return (hit && t > 0.0f) ? t : kBig;
}

__device__ __forceinline__ float ray_sphere(float rox, float roy, float roz, float rdx,
                                            float rdy, float rdz, float r) {
  const float b = rox * rdx + roy * rdy + roz * rdz;
  const float c = (rox * rox + roy * roy + roz * roz) - r * r;
  const float disc = b * b - c;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float t0 = -b - sq;
  const float t1 = -b + sq;
  const float t = t0 > 0.0f ? t0 : t1;
  return (disc >= 0.0f && t > 0.0f) ? t : kBig;
}

__device__ __forceinline__ float cyl_cap(float zc, float rox, float roy, float roz,
                                         float rdx, float rdy, float rdz, float r) {
  const float t = safe_div(zc - roz, rdz);
  const float x = rox + t * rdx;
  const float y = roy + t * rdy;
  const bool ok = t > 0.0f && (x * x + y * y <= r * r) && fabsf(rdz) > 1e-12f;
  return ok ? t : kBig;
}

// Capped z-aligned cylinder, radius r, full length h.
__device__ __forceinline__ float ray_cylinder(float rox, float roy, float roz, float rdx,
                                              float rdy, float rdz, float r, float h) {
  const float a = rdx * rdx + rdy * rdy;
  const float b = rox * rdx + roy * rdy;
  const float c = (rox * rox + roy * roy) - r * r;
  const float disc = b * b - a * c;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float inv_a = safe_div(1.0f, a);
  const float ts0 = (-b - sq) * inv_a;
  const float ts1 = (-b + sq) * inv_a;
  const float half = 0.5f * h;
  const float z0 = roz + ts0 * rdz;
  const float z1 = roz + ts1 * rdz;
  const bool base = disc >= 0.0f && a > 1e-12f;
  const float s0 = (base && ts0 > 0.0f && fabsf(z0) <= half) ? ts0 : kBig;
  const float s1 = (base && ts1 > 0.0f && fabsf(z1) <= half) ? ts1 : kBig;
  const float c0 = cyl_cap(half, rox, roy, roz, rdx, rdy, rdz, r);
  const float c1 = cyl_cap(-half, rox, roy, roz, rdx, rdy, rdz, r);
  return fminf(fminf(s0, s1), fminf(c0, c1));
}

// Two-sided triangle in its own frame: z = 0 plane, vertices (0,0), (a,0), (b,c).
__device__ __forceinline__ float ray_triangle(float rox, float roy, float roz, float rdx,
                                              float rdy, float rdz, float a, float b,
                                              float c) {
  const float t = safe_div(-roz, rdz);
  const float x = rox + t * rdx;
  const float y = roy + t * rdy;
  const float v = safe_div(y, c);
  const float u = safe_div(x - v * b, a);
  const bool ok = t > 0.0f && fabsf(rdz) > 1e-9f && u >= -kTriEps && v >= -kTriEps &&
                  (u + v <= 1.0f + kTriEps) && a > 0.0f;
  return ok ? t : kBig;
}

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

// Block-wide sum (kSum) or min of one float per thread; every thread gets it.
template <bool kSum>
__device__ float block_reduce(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kSum ? v + w : fminf(v, w);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = scratch[0];
  for (int i = 1; i < kThreads / 32; ++i) v = kSum ? v + scratch[i] : fminf(v, scratch[i]);
  return v;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
raycast_kernel(const float* __restrict__ pose, const float* __restrict__ prims,
               const float* __restrict__ dirs, const float* __restrict__ mult,
               float* __restrict__ depth, int* __restrict__ seg, int* __restrict__ face,
               float* __restrict__ vec, int R, int P, int n_box, int n_cyl, int n_sph,
               float max_range, int cull) {
  __shared__ float sp[kChunk * kStride];
  __shared__ float scratch[kThreads / 32];

  const int env = blockIdx.x;
  const int ray = blockIdx.y * kThreads + threadIdx.x;
  const bool valid = ray < R;
  const float* ps = pose + (size_t)env * 8;
  const float ox = ps[0], oy = ps[1], oz = ps[2];
  const float qx = ps[3], qy = ps[4], qz = ps[5], qw = ps[6];

  // sensor-frame direction -> world (quat_rotate, plain version's order)
  float dx = 0.0f, dy = 0.0f, dz = 1.0f;
  if (valid) {
    dx = dirs[3 * ray];
    dy = dirs[3 * ray + 1];
    dz = dirs[3 * ray + 2];
  }
  const float w2 = 2.0f * qw * qw - 1.0f;
  const float cx = qy * dz - qz * dy;
  const float cy = qz * dx - qx * dz;
  const float cz = qx * dy - qy * dx;
  const float td = 2.0f * (qx * dx + qy * dy + qz * dz);
  const float tw = 2.0f * qw;
  const float dxw = dx * w2 + cx * tw + qx * td;
  const float dyw = dy * w2 + cy * tw + qy * td;
  const float dzw = dz * w2 + cz * tw + qz * td;

  // view cone of this tile: axis = normalized mean direction, half-angle
  // from the widest ray, widened a little so the test stays conservative.
  // The half-angle may pass 90 degrees (cos_h < 0): the cone test below is
  // the signed distance to the cone's surface for any half-angle, and a
  // mean of exactly zero leaves the axis at 0, which keeps everything.
  float ax = 0.0f, ay = 0.0f, az = 1.0f, cos_h = -1.0f, sin_h = 0.0f;
  if (cull) {
    const float inv_len = valid ? rsqrtf(dxw * dxw + dyw * dyw + dzw * dzw) : 0.0f;
    const float ux = dxw * inv_len, uy = dyw * inv_len, uz = dzw * inv_len;
    ax = block_reduce<true>(ux, scratch);
    ay = block_reduce<true>(uy, scratch);
    az = block_reduce<true>(uz, scratch);
    const float inv_a = rsqrtf(fmaxf(ax * ax + ay * ay + az * az, 1e-30f));
    ax *= inv_a;
    ay *= inv_a;
    az *= inv_a;
    const float dot = valid ? ax * ux + ay * uy + az * uz : 1.0f;
    cos_h = fminf(fmaxf(block_reduce<false>(dot, scratch) - 1e-5f, -1.0f), 1.0f);
    sin_h = sqrtf(fmaxf(1.0f - cos_h * cos_h, 0.0f));
  }

  float t_best = kBig;
  int s_best = kNoHitSeg;
  int p_best = kNoHitFace;
  const float* env_prims = prims + (size_t)env * P * 16;
  for (int base = 0; base < P; base += kChunk) {
    const int cnt = min(kChunk, P - base);
    __syncthreads();  // previous chunk fully consumed
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      const float* src = env_prims + (size_t)(base + j) * 16;
      float* d = sp + j * kStride;
#pragma unroll
      for (int k = 0; k < 16; ++k) d[k] = src[k];
      // sensor origin in the primitive frame: R^T (o - p)
      const float ux = ox - d[3], uy = oy - d[4], uz = oz - d[5];
      d[16] = d[6] * ux + d[9] * uy + d[12] * uz;
      d[17] = d[7] * ux + d[10] * uy + d[13] * uz;
      d[18] = d[8] * ux + d[11] * uy + d[14] * uz;
      float vis = 1.0f;
      if (cull) {
        const int p = base + j;
        const float sx = d[0], sy = d[1], sz = d[2];
        float bound;
        if (p < n_box) bound = 0.5f * sqrtf(sx * sx + sy * sy + sz * sz);
        else if (p < n_box + n_cyl) bound = sqrtf(sx * sx + 0.25f * sy * sy);
        else if (p < n_box + n_cyl + n_sph) bound = sx;
        else bound = fmaxf(sx, sqrtf(sy * sy + sz * sz));
        const float vx = -ux, vy = -uy, vz = -uz;   // center - origin
        const float dist = sqrtf(vx * vx + vy * vy + vz * vz);
        const float margin = 1e-3f * (1.0f + dist + bound);
        const bool in_range = dist < max_range + bound + margin;
        const float along = ax * vx + ay * vy + az * vz;
        const float px = ay * vz - az * vy, py = az * vx - ax * vz, pz = ax * vy - ay * vx;
        const float perp = sqrtf(px * px + py * py + pz * pz);
        const bool in_cone = perp * cos_h - along * sin_h <= bound + margin;
        vis = (in_range && in_cone) ? 1.0f : 0.0f;
      }
      d[kVis] = vis;
    }
    __syncthreads();
    if (valid) {
      for (int j = 0; j < cnt; ++j) {
        const float* d = sp + j * kStride;
        if (d[kVis] == 0.0f) continue;
        const int p = base + j;
        float t;
        if (p >= n_box + n_cyl && p < n_box + n_cyl + n_sph) {
          // spheres are rotation-invariant: world frame
          t = ray_sphere(ox - d[3], oy - d[4], oz - d[5], dxw, dyw, dzw, d[0]);
        } else {
          const float rdx = d[6] * dxw + d[9] * dyw + d[12] * dzw;
          const float rdy = d[7] * dxw + d[10] * dyw + d[13] * dzw;
          const float rdz = d[8] * dxw + d[11] * dyw + d[14] * dzw;
          if (p < n_box)
            t = ray_box(d[16], d[17], d[18], rdx, rdy, rdz, 0.5f * d[0], 0.5f * d[1],
                        0.5f * d[2]);
          else if (p < n_box + n_cyl)
            t = ray_cylinder(d[16], d[17], d[18], rdx, rdy, rdz, d[0], d[1]);
          else
            t = ray_triangle(d[16], d[17], d[18], rdx, rdy, rdz, d[0], d[1], d[2]);
        }
        // strict < : the first primitive in table order wins ties
        if (t < t_best) {
          t_best = t;
          if (kMode == kSeg) s_best = (int)d[15];
          if (kMode >= kNormals) p_best = p;
        }
      }
    }
  }
  if (!valid) return;
  const bool miss = t_best >= fminf(max_range, 0.5f * kBig);
  const size_t out = (size_t)env * R + ray;
  float nx = 0.0f, ny = 0.0f, nz = 0.0f;
  if (kMode >= kNormals && !miss) {
    // the winner's record, from device memory: any chunk
    const float* rec = env_prims + (size_t)p_best * 16;
    s_best = (int)rec[15];
    const int kind = p_best < n_box ? 0
                     : p_best < n_box + n_cyl ? 1
                     : p_best < n_box + n_cyl + n_sph ? 2 : 3;
    winner_normal(rec, kind, ox, oy, oz, dxw, dyw, dzw, t_best, nx, ny, nz);
  }
  if (kMode == kRgb) {
    // Lambert shade of the winner on its true depth (range x multiplier),
    // faded to half brightness at max_range; sky on a miss
    const float depth_px = t_best * mult[ray];
    depth[out] = miss ? kNoHitRay : depth_px;
    seg[out] = miss ? kNoHitSeg : s_best;
    float* rgb = vec + 3 * out;
    if (miss) {
      rgb[0] = c_shade[kSky];
      rgb[1] = c_shade[kSky + 1];
      rgb[2] = c_shade[kSky + 2];
      return;
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
    return;
  }
  depth[out] = (miss ? kNoHitRay : t_best) * mult[ray];
  if (kMode != kDepth) seg[out] = miss ? kNoHitSeg : s_best;
  if (kMode == kNormals) {
    face[out] = miss ? kNoHitFace : p_best;
    vec[3 * out] = nx;
    vec[3 * out + 1] = ny;
    vec[3 * out + 2] = nz;
  }
}

template <int kMode>
void launch(const dim3& grid, cudaStream_t s, const void* pose, const void* prims,
            const void* dirs, const void* mult, void* depth, void* seg, void* face, void* vec,
            int R, int P, int n_box, int n_cyl, int n_sph, float max_range, int cull) {
  raycast_kernel<kMode><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(pose), static_cast<const float*>(prims),
      static_cast<const float*>(dirs), static_cast<const float*>(mult),
      static_cast<float*>(depth), static_cast<int*>(seg), static_cast<int*>(face),
      static_cast<float*>(vec), R, P, n_box, n_cyl, n_sph, max_range, cull);
}

}  // namespace

extern "C" int raycast_launch(const void* pose, const void* prims, const void* dirs,
                              const void* mult, void* depth, void* seg, void* face,
                              void* vec, int N, int R, int P, int n_box, int n_cyl,
                              int n_sph, int n_tri, float max_range, int cull, int mode,
                              void* stream) {
  (void)n_tri;  // triangles are the columns after the spheres
  const dim3 grid(N, (R + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kDepth:
      launch<kDepth>(grid, s, pose, prims, dirs, mult, depth, seg, face, vec, R, P, n_box,
                     n_cyl, n_sph, max_range, cull);
      break;
    case kSeg:
      launch<kSeg>(grid, s, pose, prims, dirs, mult, depth, seg, face, vec, R, P, n_box,
                   n_cyl, n_sph, max_range, cull);
      break;
    case kNormals:
      launch<kNormals>(grid, s, pose, prims, dirs, mult, depth, seg, face, vec, R, P, n_box,
                       n_cyl, n_sph, max_range, cull);
      break;
    case kRgb:
      launch<kRgb>(grid, s, pose, prims, dirs, mult, depth, seg, face, vec, R, P, n_box,
                   n_cyl, n_sph, max_range, cull);
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
