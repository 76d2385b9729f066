// Fused multi-head attention forward for NVIDIA Hopper (sm_90a):
//   o[b, :, h*hd:(h+1)*hd] = softmax(q_h k_h^T * scale) v_h      per (b, h)
// on the packed (B, S, D = H*hd) layout, whole sequence per head, softmax
// in f32, output in the input type. The (S, S) logits never reach device
// memory.
//
// Replaces the forward of the TPU kernel
// aerial_gym_simulator_tpu/ops/attention_pallas.py, fused_attention ->
// _fwd_call / _fwd_kernel (pallas_call at attention_pallas.py:153).
// Plain version: aerial_gym_simulator_tpu_torch/ops/attention.py,
// attention_reference.
//
// Bound on this card. At the ViT encoder's shapes (B=1024, S=225, D=256,
// H=8, bf16) a call must move q, k, v in and o out once, 0.47 GB, which
// takes 0.14 ms at 3.35 TB/s; its 53 GFLOP of products take 0.05 ms at
// the 989 TFLOP/s bf16 tensor-core peak. The kernel is bound by bytes: the
// design's job is to touch device memory once and keep the tensor cores
// and the exp unit from becoming the limit instead.
//
// Two kernels, one launcher:
//  * attention_mma_kernel (bf16, head_dim 32 or 64, positive scale): one
//    block per (batch row, head). The head's K and V are staged once in
//    shared memory with 16-byte loads and read back as mma fragments by
//    ldmatrix (V transposed on the way), rows padded so that no fragment
//    load has a bank conflict. Each of 8 warps owns 16 query rows at a
//    time, keeps their Q fragments in registers, and walks the keys in
//    chunks of 64: S = Q K^T by mma.sync m16n8k16 (bf16 operands, f32
//    accumulate), online softmax in f32 (running max and sum per row; per
//    score one multiply-add that folds the scale in and one exp2 on the
//    special-function unit), then O += P V with P re-used from the
//    accumulator registers as the next mma's A operand. The key loop is
//    bounded by S: keys past the end are masked to -inf in registers in
//    the last chunk only, nothing is padded in device memory. O is
//    normalised and written as bf16 pairs straight into the packed layout.
//    The softmax's scalar instructions, not the tensor cores or memory,
//    set its time: the loops are fully unrolled and free of branches so
//    that loads, products and exps of neighbouring tiles overlap (skipping
//    the tiles past S by a branch made it slower).
//  * attention_fma_kernel (f32, and bf16 at other head sizes): one block
//    per (batch row, head, tile of 64 query rows), K and V staged in
//    shared memory as f32, one warp per query row: lanes take keys for the
//    logits (plain f32 multiply-adds), the row's max, exp and sum are warp
//    reductions, then lanes take output columns for P V. It keeps full f32
//    accuracy, which bf16 tensor-core products cannot give f32 inputs.
// What the TPU kernel did for its own hardware and is not carried over:
// padding S to a multiple of 128 in device memory with -1e30 on padded
// keys, casting bf16 operands to f32 before the products, one sequential
// grid step per batch row looping over heads.
// Making it faster (wgmma, TMA loads, fusing the QKV projection) is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// f32-accurate kernel: plain multiply-adds
// ---------------------------------------------------------------------------

constexpr int kFmaWarps = 8;
constexpr int kFmaRows = 64;          // query rows per block

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// shared memory: Ks[S][hd+1], Vs[S][hd+1], prob[warps][S], qrow[warps][hd]
template <typename T>
__global__ void __launch_bounds__(kFmaWarps * 32)
attention_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int S, int H, int hd,
                     float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;               // odd row stride: lanes on distinct banks
  float* Ks = smem;
  float* Vs = Ks + (size_t)S * ld;
  float* prob = Vs + (size_t)S * ld;
  float* qrow = prob + (size_t)kFmaWarps * S;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int D = H * hd;
  const size_t base = (size_t)b * S * D + (size_t)h * hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < S * hd; i += blockDim.x) {
    const int key = i / hd, d = i - key * hd;
    Ks[key * ld + d] = to_float(k[base + (size_t)key * D + d]);
    Vs[key * ld + d] = to_float(v[base + (size_t)key * D + d]);
  }
  __syncthreads();

  float* p = prob + warp * S;
  float* qr = qrow + warp * hd;
  const int row_end = min(S, (int)(blockIdx.y + 1) * kFmaRows);
  for (int row = blockIdx.y * kFmaRows + warp; row < row_end; row += kFmaWarps) {
    for (int d = lane; d < hd; d += 32) qr[d] = to_float(q[base + (size_t)row * D + d]);
    __syncwarp();
    float m = -CUDART_INF_F;
    for (int key = lane; key < S; key += 32) {
      const float* kr = Ks + key * ld;
      float acc = 0.0f;
      for (int d = 0; d < hd; ++d) acc = fmaf(qr[d], kr[d], acc);
      acc *= scale;
      p[key] = acc;
      m = fmaxf(m, acc);
    }
    m = warp_max(m);
    float sum = 0.0f;
    for (int key = lane; key < S; key += 32) {
      const float e = expf(p[key] - m);
      p[key] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    __syncwarp();
    const float inv = 1.0f / sum;
    for (int d = lane; d < hd; d += 32) {
      float acc = 0.0f;
      for (int key = 0; key < S; ++key) acc = fmaf(p[key], Vs[key * ld + d], acc);
      from_float(o + base + (size_t)row * D + d, acc * inv);
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel: mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 8;
constexpr int kKeyChunk = 64;         // keys per online-softmax step
constexpr int kPad = 8;               // bf16 of padding per shared-memory row

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory into mma fragment registers:
// lanes 8i..8i+7 give the row addresses of matrix i, and register i of lane
// (g, t) receives row g, columns 2t and 2t+1 of matrix i. The transposed
// form delivers rows 2t and 2t+1 of column g instead.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 2^x on the special-function unit; 2^-inf = 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// shared memory (bf16): Ks[Sp][HD + kPad] and Vs[Sp][HD + kPad], both
// row-major by key, Sp = S rounded up to kKeyChunk; padded keys are zero.
// Rows are 16 bytes longer than the head so that the eight row addresses of
// an ldmatrix fall on distinct banks.
template <int HD>
__global__ void __launch_bounds__(kMmaWarps * 32)
attention_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S,
                     int H, float scale_log2e) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kLdK = HD + kPad;
  constexpr int kVec = HD / 8;         // 16-byte pieces per head row
  const int Sp = (S + kKeyChunk - 1) / kKeyChunk * kKeyChunk;
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + (size_t)Sp * kLdK;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int D = H * HD;
  const size_t base = (size_t)b * S * D + (size_t)h * HD;

  for (int i = threadIdx.x; i < Sp * kVec; i += blockDim.x) {
    const int key = i / kVec, part = i - key * kVec;
    uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = kk;
    if (key < S) {
      const size_t src = base + (size_t)key * D + part * 8;
      kk = *reinterpret_cast<const uint4*>(k + src);
      vv = *reinterpret_cast<const uint4*>(v + src);
    }
    *reinterpret_cast<uint4*>(Ks + key * kLdK + part * 8) = kk;
    *reinterpret_cast<uint4*>(Vs + key * kLdK + part * 8) = vv;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // fragment row group, column pair
  const int lm = lane >> 3, lr = lane & 7; // ldmatrix: matrix and row this lane addresses

  for (int row0 = warp * 16; row0 < S; row0 += kMmaWarps * 16) {
    // Q fragments of rows row0+g and row0+g+8 (zeros past the end)
    const int r_lo = row0 + g, r_hi = row0 + g + 8;
    uint32_t qf[HD / 16][4];
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const int d = ks * 16 + t * 2;
      const uint32_t* lo = reinterpret_cast<const uint32_t*>(q + base + (size_t)r_lo * D + d);
      const uint32_t* hi = reinterpret_cast<const uint32_t*>(q + base + (size_t)r_hi * D + d);
      qf[ks][0] = r_lo < S ? lo[0] : 0u;
      qf[ks][1] = r_hi < S ? hi[0] : 0u;
      qf[ks][2] = r_lo < S ? lo[4] : 0u;
      qf[ks][3] = r_hi < S ? hi[4] : 0u;
    }

    float oacc[HD / 8][4];
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[dt][e] = 0.0f;
    float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F;   // running row max (log2 units)
    float l_lo = 0.0f, l_hi = 0.0f;                     // this thread's share of the row sums

    for (int key0 = 0; key0 < S; key0 += kKeyChunk) {
      const int keys_left = S - key0;   // the last chunk may be short
      float s[kKeyChunk / 8][4];
#pragma unroll
      for (int nt = 0; nt < kKeyChunk / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
        // B = K^T: 8 keys x 32 head columns per load, two k-steps of 16
        const __nv_bfloat16* kr = Ks + (key0 + nt * 8 + lr) * kLdK + lm * 8;
#pragma unroll
        for (int kk = 0; kk < HD / 32; ++kk) {
          uint32_t kb[4];
          ldmatrix_x4(kb, kr + kk * 32);
          mma_bf16(s[nt], qf[2 * kk], kb[0], kb[1]);
          mma_bf16(s[nt], qf[2 * kk + 1], kb[2], kb[3]);
        }
      }
      if (keys_left < kKeyChunk) {   // mask the keys past the end
#pragma unroll
        for (int nt = 0; nt < kKeyChunk / 8; ++nt) {
          const int key = nt * 8 + t * 2;
          if (key >= keys_left) s[nt][0] = s[nt][2] = -CUDART_INF_F;
          if (key + 1 >= keys_left) s[nt][1] = s[nt][3] = -CUDART_INF_F;
        }
      }
      // chunk max per row on the raw scores (the scale is positive)
      float c_lo = -CUDART_INF_F, c_hi = -CUDART_INF_F;
#pragma unroll
      for (int nt = 0; nt < kKeyChunk / 8; ++nt) {
        c_lo = fmaxf(c_lo, fmaxf(s[nt][0], s[nt][1]));
        c_hi = fmaxf(c_hi, fmaxf(s[nt][2], s[nt][3]));
      }
      c_lo = fmaxf(c_lo, __shfl_xor_sync(0xffffffffu, c_lo, 1));
      c_lo = fmaxf(c_lo, __shfl_xor_sync(0xffffffffu, c_lo, 2));
      c_hi = fmaxf(c_hi, __shfl_xor_sync(0xffffffffu, c_hi, 1));
      c_hi = fmaxf(c_hi, __shfl_xor_sync(0xffffffffu, c_hi, 2));
      // every chunk holds at least one real key, so the new max is finite
      const float n_lo = fmaxf(m_lo, c_lo * scale_log2e);
      const float n_hi = fmaxf(m_hi, c_hi * scale_log2e);
      const float a_lo = fast_exp2(m_lo - n_lo), a_hi = fast_exp2(m_hi - n_hi);
      m_lo = n_lo;
      m_hi = n_hi;
      l_lo *= a_lo;
      l_hi *= a_hi;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        oacc[dt][0] *= a_lo;
        oacc[dt][1] *= a_lo;
        oacc[dt][2] *= a_hi;
        oacc[dt][3] *= a_hi;
      }
      // p = 2^(s * scale - max): one multiply-add and one exp2 per score
#pragma unroll
      for (int nt = 0; nt < kKeyChunk / 8; ++nt) {
        s[nt][0] = fast_exp2(fmaf(s[nt][0], scale_log2e, -m_lo));
        s[nt][1] = fast_exp2(fmaf(s[nt][1], scale_log2e, -m_lo));
        s[nt][2] = fast_exp2(fmaf(s[nt][2], scale_log2e, -m_hi));
        s[nt][3] = fast_exp2(fmaf(s[nt][3], scale_log2e, -m_hi));
        l_lo += s[nt][0] + s[nt][1];
        l_hi += s[nt][2] + s[nt][3];
      }
      // O += P V: two neighbouring 16x8 accumulator tiles of P are the
      // 16x16 A operand of the next product
#pragma unroll
      for (int kt = 0; kt < kKeyChunk / 16; ++kt) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
        pa[1] = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
        pa[2] = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
        pa[3] = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
        // B = V: 16 keys x 16 head columns per transposed load
        const __nv_bfloat16* vr =
            Vs + (key0 + kt * 16 + (lm & 1) * 8 + lr) * kLdK + (lm >> 1) * 8;
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vr + dp * 16);
          mma_bf16(oacc[2 * dp], pa, vb[0], vb[1]);
          mma_bf16(oacc[2 * dp + 1], pa, vb[2], vb[3]);
        }
      }
    }

    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
    const float i_lo = 1.0f / l_lo, i_hi = 1.0f / l_hi;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      const int d = dt * 8 + t * 2;
      if (r_lo < S)
        *reinterpret_cast<uint32_t*>(o + base + (size_t)r_lo * D + d) =
            pack_bf16(oacc[dt][0] * i_lo, oacc[dt][1] * i_lo);
      if (r_hi < S)
        *reinterpret_cast<uint32_t*>(o + base + (size_t)r_hi * D + d) =
            pack_bf16(oacc[dt][2] * i_hi, oacc[dt][3] * i_hi);
    }
  }
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

size_t fma_shared_bytes(int S, int hd) {
  return sizeof(float) * (2 * (size_t)S * (hd + 1) + (size_t)kFmaWarps * (S + hd));
}

size_t mma_shared_bytes(int S, int hd) {
  const size_t Sp = (size_t)(S + kKeyChunk - 1) / kKeyChunk * kKeyChunk;
  return sizeof(__nv_bfloat16) * 2 * Sp * (hd + kPad);
}

template <typename T>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o, int B, int S,
                       int H, int hd, float scale, cudaStream_t s) {
  const size_t bytes = fma_shared_bytes(S, hd);
  cudaError_t err = allow_shared(attention_fma_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + kFmaRows - 1) / kFmaRows);
  attention_fma_kernel<T><<<grid, kFmaWarps * 32, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, hd, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int B, int S,
                       int H, float scale, cudaStream_t s) {
  const size_t bytes = mma_shared_bytes(S, HD);
  cudaError_t err = allow_shared(attention_mma_kernel<HD>, bytes);
  if (err != cudaSuccess) return err;
  attention_mma_kernel<HD><<<B * H, kMmaWarps * 32, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, H,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// Shared memory one block needs for these sizes; the wrapper refuses a
// sequence that does not fit the card's 227 KB.
extern "C" long long attention_shared_bytes(int S, int hd, int use_mma) {
  return static_cast<long long>(use_mma ? mma_shared_bytes(S, hd) : fma_shared_bytes(S, hd));
}

// q, k, v, o: contiguous (B, S, H*hd), 16-byte aligned, f32 (is_bf16 = 0) or
// bf16. use_mma picks the tensor-core kernel (bf16, hd 32 or 64, scale > 0
// only: it takes the row maximum before scaling).
extern "C" int attention_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                    int B, int S, int H, int hd, float scale, int is_bf16,
                                    int use_mma, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (use_mma) {
    if (!is_bf16 || !(scale > 0.0f)) return static_cast<int>(cudaErrorInvalidValue);
    if (hd == 32)
      err = launch_mma<32>(q, k, v, o, B, S, H, scale, s);
    else if (hd == 64)
      err = launch_mma<64>(q, k, v, o, B, S, H, scale, s);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (is_bf16) {
    err = launch_fma<__nv_bfloat16>(q, k, v, o, B, S, H, hd, scale, s);
  } else {
    err = launch_fma<float>(q, k, v, o, B, S, H, hd, scale, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
