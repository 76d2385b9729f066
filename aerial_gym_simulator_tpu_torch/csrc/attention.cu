// Fused multi-head attention for NVIDIA Hopper (sm_90a), forward and backward:
//   o[b, :, h*hd:(h+1)*hd] = softmax(q_h k_h^T * scale) v_h      per (b, h)
// on the packed (B, S, D = H*hd) layout, whole sequence per head, softmax
// in f32, results in the input type. The (S, S) logits never reach device
// memory in either direction: the backward keeps q, k, v only and
// recomputes the probabilities.
//
// Replaces the TPU kernels of
// aerial_gym_simulator_tpu/ops/attention_pallas.py: the forward
// fused_attention -> _fwd_call / _fwd_kernel (pallas_call at
// attention_pallas.py:153) and the backward _bwd_call / _bwd_kernel
// (pallas_call at attention_pallas.py:169).
// Plain versions: aerial_gym_simulator_tpu_torch/ops/attention.py,
// attention_reference and attention_backward_reference.
//
// Bound on this card, forward. At the ViT encoder's shapes (B=1024, S=225,
// D=256, H=8, bf16) a call must move q, k, v in and o out once, 0.47 GB,
// which takes 0.14 ms at 3.35 TB/s; its 53 GFLOP of products take 0.05 ms
// at the 989 TFLOP/s bf16 tensor-core peak. The kernel is bound by bytes:
// the design's job is to touch device memory once and keep the tensor cores
// and the exp unit from becoming the limit instead.
//
// Bound on this card, backward. The training path is f32 at B=64, S=225,
// D=256, H=8: q, k, v, do in and dq, dk, dv out once are 103 MB (0.03 ms at
// 3.35 TB/s); the five products dV = P^T dO, dP = dO V^T, dQ = dS K,
// dK = dS^T Q and the recomputed Q K^T are 8.3 GFLOP, 0.12 ms at the
// 67 TFLOP/s f32 rate: bound by operations. f32 inputs are held to 2e-4,
// which tensor-core products of bf16 or TF32 operands do not give, so the
// backward is a multiply-add kernel like the f32 forward.
//
// Forward, two kernels behind one launcher:
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
// Backward, attention_bwd_kernel (f32 and bf16, any head size): one block
// per (batch row, head) stages that head's q, k, v and do in shared memory
// in the input type (rows padded to an odd count of 32-bit words, so lanes
// on neighbouring rows hit distinct banks) and makes two passes with f32
// arithmetic. Where the four do not fit one block together (f32 at head_dim
// 64 beyond S = 177) it stages two at a time, the pair that each pass walks
// in full: k and v for the row pass, then q and do in their place for the
// column pass, and each warp fetches the two rows it holds fixed from device
// memory into a small buffer of its own. The arithmetic and its order are
// the same, so both stagings give the same bits. Row pass, one warp per pair of query rows: logits and dP =
// do . v with lanes over keys, row max, exp and sum, delta = sum_j P dP,
// dS = P (dP - delta) scale, then dQ = dS K with lanes over head columns; the
// row's max, 1/sum and delta stay in shared memory. Column pass, one warp
// per pair of keys: P and dS of those columns recomputed from the stored row
// statistics with lanes over queries, then dV = P^T dO and dK = dS^T Q with
// lanes over head columns. What limits a multiply-add kernel here is
// shared-memory bandwidth, one 128-byte access per clock against four warp
// multiply-adds per clock: the dot products therefore keep a 2 x 256 tile
// of (pair row, running row) sums in registers, 20 accesses for 32
// multiply-adds per head column (one row at a time would take 4 accesses
// for 2), and the pair's P and dS sit interleaved so that one
// 8-byte broadcast feeds both rows' sums. dK and dV sum over queries and dQ
// over keys inside one block, so there is no float atomic and two launches
// on the same inputs give the same bits. The loops are bounded by S: no
// padded key exists, so no masked logit and no 0 * inf can arise at any
// magnitude of q and k.
// What the TPU kernels did for their own hardware and is not carried over:
// padding S to a multiple of 128 in device memory with -1e30 on padded
// keys, casting bf16 operands to f32 before the products, one sequential
// grid step per batch row looping over heads.
// Making it faster (wgmma, TMA loads, fusing the QKV projection, tensor-core
// products for the bf16 backward) is later work.

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

// ---------------------------------------------------------------------------
// backward: recompute P, dq / dk / dv with plain multiply-adds
// ---------------------------------------------------------------------------

constexpr int kBwdWarps = 16;
constexpr int kBwdTiles = 8;   // 32-wide tiles of the running axis held in registers

// elements of padding per staged row: the row then spans an odd number of
// 32-bit words (head_dim even for bf16), so lanes on neighbouring rows and
// the same column fall on distinct banks
template <typename T>
__host__ __device__ constexpr int bwd_row_pad() { return 4 / (int)sizeof(T); }

// Two fixed rows a0, a1 of A and dA against the 32 * kBwdTiles rows of B and
// dB that start at j0 (this lane takes rows j0 + 32 t + lane):
//   s[r][t] = A[a_r] . B[j],  dp[r][t] = dA[a_r] . dB[j],
// summed over the head in ascending order. The row pass calls it with
// queries fixed and keys running, the column pass the other way round; the
// products commute, so both passes see the same bits. Rows past S repeat
// row S - 1 and are dropped by the caller. Per head column this costs 4
// broadcast loads and 2 loads per tile for 4 multiply-adds per tile.
template <typename T>
__device__ __forceinline__ void pair_dots(const T* __restrict__ A, const T* __restrict__ dA,
                                          const T* __restrict__ B, const T* __restrict__ dB,
                                          int a0, int a1, int j0, int lane, int S, int hd,
                                          int ld, float (&s)[2][kBwdTiles],
                                          float (&dp)[2][kBwdTiles]) {
  int off[kBwdTiles];
#pragma unroll
  for (int t = 0; t < kBwdTiles; ++t) {
    off[t] = min(j0 + t * 32 + lane, S - 1) * ld;
    s[0][t] = s[1][t] = dp[0][t] = dp[1][t] = 0.0f;
  }
  const T* x0 = A + a0 * ld;
  const T* x1 = A + a1 * ld;
  const T* y0 = dA + a0 * ld;
  const T* y1 = dA + a1 * ld;
  for (int d = 0; d < hd; ++d) {
    const float xa = to_float(x0[d]), xb = to_float(x1[d]);
    const float ya = to_float(y0[d]), yb = to_float(y1[d]);
#pragma unroll
    for (int t = 0; t < kBwdTiles; ++t) {
      const float b = to_float(B[off[t] + d]);
      const float db = to_float(dB[off[t] + d]);
      s[0][t] = fmaf(xa, b, s[0][t]);
      s[1][t] = fmaf(xb, b, s[1][t]);
      dp[0][t] = fmaf(ya, db, dp[0][t]);
      dp[1][t] = fmaf(yb, db, dp[1][t]);
    }
  }
}

// one head of two packed (S, D) tensors into shared rows of ld elements, by
// the whole block. The loads of one pass are independent, so a block that has
// nothing else to run hides their latency behind each other: staging tensor
// by tensor in loops of their own made the whole kernel 10-20% slower.
template <typename T>
__device__ __forceinline__ void stage_two(T* dst0, const T* __restrict__ src0, T* dst1,
                                          const T* __restrict__ src1, size_t base, int S,
                                          int hd, int ld, int D) {
  for (int i = threadIdx.x; i < S * hd; i += blockDim.x) {
    const int row = i / hd, d = i - row * hd;
    const size_t src = base + (size_t)row * D + d;
    dst0[row * ld + d] = src0[src];
    dst1[row * ld + d] = src1[src];
  }
}

// rows r0, r1 of a and of da into a warp's own buffer: a[r0], a[r1], da[r0],
// da[r1], each ld elements long
template <typename T>
__device__ __forceinline__ void stage_pair(T* dst, const T* __restrict__ a,
                                           const T* __restrict__ da, size_t base, int r0,
                                           int r1, int hd, int ld, int D, int lane) {
  for (int d = lane; d < hd; d += 32) {
    dst[d] = a[base + (size_t)r0 * D + d];
    dst[ld + d] = a[base + (size_t)r1 * D + d];
    dst[2 * ld + d] = da[base + (size_t)r0 * D + d];
    dst[3 * ld + d] = da[base + (size_t)r1 * D + d];
  }
  __syncwarp();
}

// shared memory: float2 scratch[warps][2][S] (P and dP / dS of a pair of rows
// or columns per warp, the pair interleaved), float stats[3][S] (row max,
// 1 / row sum, delta), then in T with rows of hd + pad: Qs, Ks, Vs, dOs [S]
// each when kAll; else two [S] buffers (Ks and Vs, later Qs and dOs) and
// pairs[warps][4]
template <typename T, bool kAll>
__global__ void __launch_bounds__(kBwdWarps * 32)
attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, T* __restrict__ dq, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int H, int hd, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = hd + bwd_row_pad<T>();
  float2* scratch = reinterpret_cast<float2*>(smem_raw);
  float* row_max = reinterpret_cast<float*>(scratch + (size_t)kBwdWarps * 2 * S);
  float* row_inv = row_max + S;
  float* row_delta = row_inv + S;
  T* buf = reinterpret_cast<T*>(row_delta + S);
  const size_t head = (size_t)S * ld;
  // kAll: q, k, v, do side by side. Else k and v first, q and do over them
  // after the row pass, and a buffer of four rows per warp behind them.
  T* Qs = buf;
  T* dOs = kAll ? buf + 3 * head : buf + head;
  T* Ks = kAll ? buf + head : buf;
  T* Vs = kAll ? buf + 2 * head : buf + head;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int D = H * hd;
  const size_t base = (size_t)b * S * D + (size_t)h * hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* rows = buf + 2 * head + (size_t)warp * 4 * ld;   // !kAll only

  if (kAll) {
    for (int i = threadIdx.x; i < S * hd; i += blockDim.x) {
      const int row = i / hd, d = i - row * hd;
      const size_t src = base + (size_t)row * D + d;
      Qs[row * ld + d] = q[src];
      Ks[row * ld + d] = k[src];
      Vs[row * ld + d] = v[src];
      dOs[row * ld + d] = dout[src];
    }
  } else {
    stage_two(Ks, k, Vs, v, base, S, hd, ld, D);
  }
  __syncthreads();

  float2* pw = scratch + (size_t)warp * 2 * S;   // P of this warp's pair
  float2* dw = pw + S;                           // dP, then dS
  float s[2][kBwdTiles], dp[2][kBwdTiles];

  // row pass, two query rows per warp at a time: statistics and dQ
  for (int i0 = warp * 2; i0 < S; i0 += kBwdWarps * 2) {
    const bool pair = i0 + 1 < S;
    const int i1 = pair ? i0 + 1 : i0;
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
    if (!kAll) stage_pair(rows, q, dout, base, i0, i1, hd, ld, D, lane);
    for (int j0 = 0; j0 < S; j0 += 32 * kBwdTiles) {
      if (kAll)
        pair_dots<T>(Qs, dOs, Ks, Vs, i0, i1, j0, lane, S, hd, ld, s, dp);
      else
        pair_dots<T>(rows, rows + 2 * ld, Ks, Vs, 0, 1, j0, lane, S, hd, ld, s, dp);
#pragma unroll
      for (int t = 0; t < kBwdTiles; ++t) {
        const int j = j0 + t * 32 + lane;
        if (j < S) {
          const float s0 = __fmul_rn(s[0][t], scale), s1 = __fmul_rn(s[1][t], scale);
          pw[j] = make_float2(s0, s1);
          dw[j] = make_float2(dp[0][t], dp[1][t]);
          m0 = fmaxf(m0, s0);
          m1 = fmaxf(m1, s1);
        }
      }
    }
    m0 = warp_max(m0);
    m1 = warp_max(m1);
    float sum0 = 0.0f, sum1 = 0.0f;
    for (int j = lane; j < S; j += 32) {
      float2 e = pw[j];
      e.x = expf(e.x - m0);
      e.y = expf(e.y - m1);
      pw[j] = e;
      sum0 += e.x;
      sum1 += e.y;
    }
    const float inv0 = 1.0f / warp_sum(sum0), inv1 = 1.0f / warp_sum(sum1);
    float del0 = 0.0f, del1 = 0.0f;
    for (int j = lane; j < S; j += 32) {
      float2 p = pw[j];
      const float2 g = dw[j];
      p.x *= inv0;
      p.y *= inv1;
      pw[j] = p;
      del0 = fmaf(p.x, g.x, del0);
      del1 = fmaf(p.y, g.y, del1);
    }
    del0 = warp_sum(del0);
    del1 = warp_sum(del1);
    for (int j = lane; j < S; j += 32) {
      const float2 p = pw[j], g = dw[j];
      dw[j] = make_float2(p.x * (g.x - del0) * scale, p.y * (g.y - del1) * scale);
    }
    if (lane == 0) {
      row_max[i0] = m0;
      row_inv[i0] = inv0;
      row_delta[i0] = del0;
      if (pair) {
        row_max[i1] = m1;
        row_inv[i1] = inv1;
        row_delta[i1] = del1;
      }
    }
    __syncwarp();
    for (int d = lane; d < hd; d += 32) {
      float acc0 = 0.0f, acc1 = 0.0f;
      for (int j = 0; j < S; ++j) {
        const float2 g = dw[j];
        const float kk = to_float(Ks[j * ld + d]);
        acc0 = fmaf(g.x, kk, acc0);
        acc1 = fmaf(g.y, kk, acc1);
      }
      from_float(dq + base + (size_t)i0 * D + d, acc0);
      if (pair) from_float(dq + base + (size_t)i1 * D + d, acc1);
    }
    __syncwarp();
  }
  __syncthreads();
  if (!kAll) {   // q and do take the place of k and v
    stage_two(Qs, q, dOs, dout, base, S, hd, ld, D);
    __syncthreads();
  }

  // column pass, two keys per warp at a time: dK and dV from the stored row
  // statistics
  for (int k0 = warp * 2; k0 < S; k0 += kBwdWarps * 2) {
    const bool pair = k0 + 1 < S;
    const int k1 = pair ? k0 + 1 : k0;
    if (!kAll) stage_pair(rows, k, v, base, k0, k1, hd, ld, D, lane);
    for (int i0 = 0; i0 < S; i0 += 32 * kBwdTiles) {
      if (kAll)
        pair_dots<T>(Ks, Vs, Qs, dOs, k0, k1, i0, lane, S, hd, ld, s, dp);
      else
        pair_dots<T>(rows, rows + 2 * ld, Qs, dOs, 0, 1, i0, lane, S, hd, ld, s, dp);
#pragma unroll
      for (int t = 0; t < kBwdTiles; ++t) {
        const int i = i0 + t * 32 + lane;
        if (i < S) {
          const float m = row_max[i], inv = row_inv[i], del = row_delta[i];
          const float p0 = expf(__fmul_rn(s[0][t], scale) - m) * inv;
          const float p1 = expf(__fmul_rn(s[1][t], scale) - m) * inv;
          pw[i] = make_float2(p0, p1);
          dw[i] = make_float2(p0 * (dp[0][t] - del) * scale, p1 * (dp[1][t] - del) * scale);
        }
      }
    }
    __syncwarp();
    for (int d = lane; d < hd; d += 32) {
      float av0 = 0.0f, av1 = 0.0f, ak0 = 0.0f, ak1 = 0.0f;
      for (int i = 0; i < S; ++i) {
        const float2 p = pw[i], g = dw[i];
        const float od = to_float(dOs[i * ld + d]), qd = to_float(Qs[i * ld + d]);
        av0 = fmaf(p.x, od, av0);
        av1 = fmaf(p.y, od, av1);
        ak0 = fmaf(g.x, qd, ak0);
        ak1 = fmaf(g.y, qd, ak1);
      }
      from_float(dv + base + (size_t)k0 * D + d, av0);
      from_float(dk + base + (size_t)k0 * D + d, ak0);
      if (pair) {
        from_float(dv + base + (size_t)k1 * D + d, av1);
        from_float(dk + base + (size_t)k1 * D + d, ak1);
      }
    }
    __syncwarp();
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

constexpr size_t kMaxSharedBytes = 232448;   // what one block may use on sm_90

template <typename T>
size_t bwd_shared_bytes(int S, int hd, bool all) {
  const size_t staged_rows = all ? 4 * (size_t)S : 2 * (size_t)S + 4 * (size_t)kBwdWarps;
  return sizeof(float) * (3 + 4 * (size_t)kBwdWarps) * S
         + sizeof(T) * staged_rows * (hd + bwd_row_pad<T>());
}

// all four tensors of a head staged at once where they fit, else two at a time
template <typename T>
bool bwd_stages_all(int S, int hd) { return bwd_shared_bytes<T>(S, hd, true) <= kMaxSharedBytes; }

template <typename T, bool kAll>
cudaError_t launch_bwd_staged(const void* q, const void* k, const void* v, const void* dout,
                              void* dq, void* dk, void* dv, int B, int S, int H, int hd,
                              float scale, cudaStream_t s) {
  const size_t bytes = bwd_shared_bytes<T>(S, hd, kAll);
  cudaError_t err = allow_shared(attention_bwd_kernel<T, kAll>, bytes);
  if (err != cudaSuccess) return err;
  attention_bwd_kernel<T, kAll><<<B * H, kBwdWarps * 32, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), S, H, hd, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout, void* dq,
                       void* dk, void* dv, int B, int S, int H, int hd, float scale,
                       cudaStream_t s) {
  if (bwd_stages_all<T>(S, hd))
    return launch_bwd_staged<T, true>(q, k, v, dout, dq, dk, dv, B, S, H, hd, scale, s);
  return launch_bwd_staged<T, false>(q, k, v, dout, dq, dk, dv, B, S, H, hd, scale, s);
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

// Shared memory one block of the backward needs with the staging the
// launcher picks for these sizes; the wrapper refuses sizes that do not fit.
extern "C" long long attention_bwd_shared_bytes(int S, int hd, int is_bf16) {
  return static_cast<long long>(
      is_bf16 ? bwd_shared_bytes<__nv_bfloat16>(S, hd, bwd_stages_all<__nv_bfloat16>(S, hd))
              : bwd_shared_bytes<float>(S, hd, bwd_stages_all<float>(S, hd)));
}

// q, k, v, dout (the gradient of the output) in; dq, dk, dv out: contiguous
// (B, S, H*hd), f32 (is_bf16 = 0) or bf16 (hd even). P is recomputed.
extern "C" int attention_bwd_launch(const void* q, const void* k, const void* v,
                                    const void* dout, void* dq, void* dk, void* dv, int B,
                                    int S, int H, int hd, float scale, int is_bf16,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    if (hd % 2) return static_cast<int>(cudaErrorInvalidValue);
    err = launch_bwd<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, B, S, H, hd, scale, s);
  } else {
    err = launch_bwd<float>(q, k, v, dout, dq, dk, dv, B, S, H, hd, scale, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
