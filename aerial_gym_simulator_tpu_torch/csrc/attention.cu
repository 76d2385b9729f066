// Fused multi-head attention for NVIDIA Hopper (sm_90a), forward and backward:
//   o[b, :, h*hd:(h+1)*hd] = softmax(q_h k_h^T * scale) v_h      per (b, h)
// on the packed (B, S, D = H*hd) layout, softmax in f32, results in the input
// type. The (S, S) logits never reach device memory in either direction: the
// forward can write the row log-sum-exp L (B, H, S) beside o, and the
// backward recomputes the probabilities from q, k and L.
//
// Replaces the TPU kernels of
// aerial_gym_simulator_tpu/ops/attention_pallas.py: the forward
// fused_attention -> _fwd_call / _fwd_kernel (pallas_call at
// attention_pallas.py:153) and the backward _bwd_call / _bwd_kernel
// (pallas_call at attention_pallas.py:169).
// Plain versions: aerial_gym_simulator_tpu_torch/ops/attention.py,
// attention_reference, attention_lse_reference and
// attention_backward_reference.
//
// Bound on this card, forward. At the ViT encoder's serving shape (B=1024,
// S=225, D=256, H=8, bf16) a call must move q, k, v in and o out once, 0.47
// GB, 0.14 ms at 3.35 TB/s; its 53 GFLOP of products take 0.05 ms at the 989
// TFLOP/s bf16 tensor-core peak: bound by bytes. At the training shape (B=64,
// f32) the 3.3 GFLOP take 0.050 ms as f32 multiply-adds (67 TFLOP/s) or 0.020
// ms as three TF32 products each (495 TFLOP/s); bytes 0.018 ms.
// Bound, backward. Training shape f32: q, k, v, do in and dq, dk, dv out are
// 103 MB (0.031 ms); the five products Q K^T, dO V^T, dQ = dS K, dK = dS^T Q,
// dV = P^T dO are 8.3 GFLOP, 0.124 ms as f32 multiply-adds, 0.050 ms as
// 3xTF32. bf16 at the serving shape: 0.246 ms by bytes.
//
// f32 accuracy from the tensor cores ("3xTF32"). A TF32 operand keeps 10
// mantissa bits, so one TF32 product misses the f32 tolerances (1e-4 forward,
// 2e-4 backward). Split x = hi + lo with hi = tf32(x), lo = tf32(x - hi); then
// a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi with f32 accumulation, about 2^-21
// relative per product (a_lo b_lo, 2^-22, is dropped). The cross terms are
// added first so the small terms are not lost behind the large one. A bf16
// operand is exact in TF32 and takes one product; P and dS are rounded to
// TF32 there (10 bits, where the library rounds them to bf16's 7).
//
// Forward, three kernels behind one launcher:
//  * attention_mma_kernel (bf16, head_dim 32, positive scale, S up to what
//    one block's shared memory holds: 1,408 on an H100): the staged serving
//    kernel, the navigation encoder's (B=1024, S=225, H=8). One block per
//    (batch row, head). The head's K and V are
//    staged once in shared memory with 16-byte loads and read back as mma
//    fragments by ldmatrix (V transposed on the way), rows padded so that no
//    fragment load has a bank conflict. Each of 8 warps owns 16 query rows at
//    a time, keeps their Q fragments in registers, and walks the keys in
//    chunks of 64: S = Q K^T by mma.sync m16n8k16 (bf16 operands, f32
//    accumulate), online softmax in f32 (running max and sum per row; per
//    score one multiply-add that folds the scale in and one exp2 on the
//    special-function unit), then O += P V with P re-used from the
//    accumulator registers as the next mma's A operand. Keys past S are
//    masked to -inf in registers in the last chunk only; nothing is padded in
//    device memory. The softmax's scalar instructions, not the tensor cores
//    or memory, set its time: the loops are fully unrolled and free of
//    branches so that loads, products and exps of neighbouring tiles overlap.
//    kLse adds the write of L for the autograd forward; the serving
//    instantiation (kLse false) is the same code as before it existed.
//  * attention_ring_kernel (bf16, head_dim 32 or 64, positive scale, any S):
//    the serving kernel redesigned for streaming, which runs head size 64
//    and every sequence the staged kernel cannot hold. At the serving shape
//    it computes the same function within the same bars and takes a few
//    per cent longer than the staged kernel, which is why that one stays
//    (PERF.md, chip_smoke.py's timing of both); at head size 64 it is the
//    faster. Bounds at the serving shape: bytes 0.141 ms (above); one exp2
//    per score, B H S^2 = 415 M, on the special-function units (16 a clock
//    per SM, 132 SMs), 0.099 ms at 1.98 GHz, the "exp floor"; products
//    0.054 ms.
//    - K and V stream through a ring of kServeChunk-key stages in shared
//      memory: warp 0 fills a stage by cp.async, the stage's full mbarrier
//      completes when the copies land, every warp arrives on its empty
//      mbarrier when done with it. Loads overlap the products and exps
//      with no block-wide barrier after the start, and shared memory does
//      not depend on S. Each warp copies its own Q rows into shared memory
//      and reads them back by ldmatrix; O leaves the same way, staged in
//      those rows and written by 16-byte stores.
//    - Only the real keys' 8-key tiles are computed (S = 225: 240 rows x 232
//      keys, 10% over S^2, where the staged kernel's 64-key chunks compute
//      240 x 256, 21%), and a warp moves its rows' max only when one
//      outgrows it by kRescaleSlack (log2 units), so most chunks skip the
//      rescale and its exps; P stays below 2^8 and is rounded to bf16 for
//      P V either way.
//    - Each warp holds two 16-row tiles (Serve<HD>), so that each K and V
//      fragment read from shared memory feeds two products.
//    What holds both serving kernels at the serving shape, and not at a
//    bound, is that a warp runs a chunk's products and its exps one after
//    the other: dropping the exps gained little, and neither more warps, a
//    persistent grid, a head-contiguous layout nor turns on the tensor
//    cores between two warp groups helped (PERF.md). wgmma, whose products
//    run asynchronously beside the softmax, is the next step.
//  * attention_tf32_kernel (f32 at head sizes up to 128; bf16 at other head
//    sizes up to 128 or a non-positive scale): the same online softmax on
//    mma.sync m16n8k8 TF32 products, 3xTF32 for f32 inputs. One block of 4
//    warps per (batch row, head, 64 query rows), 16 rows per warp with their
//    Q fragments (hi and lo) in registers. K and V come in 64-key tiles,
//    double-buffered in shared memory by 16-byte cp.async so that a block
//    loads the next tile while it multiplies the current one, and several
//    blocks share an SM (37 KB of shared memory at head_dim 32). hi/lo are
//    split in registers as fragments are read. The head is padded with zero
//    columns to the instantiated width (32, 64 or 128: exact for every dot
//    product), rows past S are zero-filled by the copy itself.
//    P V without a shuffle: the S accumulator holds columns 2t and 2t+1 of
//    each 8-key tile in lane (g, t), and the TF32 A operand wants columns t
//    and t+4. Taking the tile's keys in the order 0, 2, 4, 6, 1, 3, 5, 7
//    makes the accumulator the A operand as it stands; V's rows are read in
//    that order (lane (g, t) reads keys 2t and 2t+1 of column g), and tiles
//    are padded to HD + 4 floats a row so that this read and the K^T read
//    (row g, columns t and t + 4) are both free of bank conflicts.
// Backward (FlashAttention-2's shape, deterministic): two tiled TF32 kernels
// after the forward has left o and L.
//  * attention_bwd_dq_kernel, one block per (batch row, head, 64 query rows):
//    delta = rowsum(dO o) from the fragments it loads anyway (written out for
//    the second kernel), then over key tiles: S = Q K^T, P = exp(S scale - L),
//    dP = dO V^T, dS = P (dP - delta), dQ += dS K (3 products).
//  * attention_bwd_dkdv_kernel, one block per (batch row, head, 64 keys): over
//    query tiles (Q, dO, L, delta staged): S^T = K Q^T, P^T, dP^T = V dO^T,
//    dS^T, dV += P^T dO, dK += dS^T Q (4 products), sums in registers.
//  Each output row belongs to one warp and is summed in one fixed order: no
//  float atomic, two calls on the same inputs give the same bits. No tile
//  holds a whole head, so S has no limit from shared memory. Keys and
//  queries past S are zero rows in the staged tiles; the dQ kernel also sets
//  P to 0 on keys past S in the last tile, so no exp of an unbounded
//  argument can reach a sum.
// Heads of 129 to 256 columns (ViT dim 256 at one head) run the one-pass
// wide kernels, attention_wide_fwd_kernel and the backward pair
// attention_wide_bwd_dq_kernel / attention_wide_bwd_dkdv_kernel: a block
// holds the whole head of its rows in shared memory and takes each product
// once (see their section). Heads of 257 to 2,048 columns (ViT dim 512 at
// one head is 512) run the cluster kernels, attention_cluster_fwd_kernel and
// attention_cluster_bwd_dq_kernel / attention_cluster_bwd_dkdv_kernel: a
// thread-block cluster of one wide block per 256-column slice of the head,
// whose partial logits are summed across the cluster through distributed
// shared memory, so every product is taken once per cluster (see their
// section). Wider heads (any width) run three sliced kernels,
// attention_sliced_fwd_kernel and attention_sliced_bwd_dq_kernel /
// attention_sliced_bwd_dkdv_kernel: the same products and softmax over
// 128-column slices of the head, one output slice per block, the logits
// recomputed for each.
// What the TPU kernels did for their own hardware and is not carried over:
// padding S to a multiple of 128 in device memory with -1e30 on padded keys,
// casting bf16 operands to f32 before the products, one sequential grid step
// per batch row looping over heads, recomputing the softmax statistics in
// the backward. Left for later: wgmma and TMA, bf16 m16n8k16 products for
// the bf16 backward.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 2^x on the special-function unit; 2^-inf = 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// src_bytes 0: the destination is zero-filled and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(shared_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(shared_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarrier in shared memory: a phase completes after `count` arrivals
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(shared_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          shared_addr(bar))
      : "memory");
}

// one arrival on bar once every cp.async this thread has issued has landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(shared_addr(bar))
               : "memory");
}

// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n .reg .pred done;\n LAB_WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra LAB_WAIT;\n}\n" ::"r"(shared_addr(bar)),
      "r"(parity)
      : "memory");
}

// ---------------------------------------------------------------------------
// bf16 serving kernels: mma.sync m16n8k16, the staged kernel and the ring
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 8;
constexpr int kKeyChunk = 64;         // keys per online-softmax step
constexpr int kPad = 8;               // bf16 of padding per shared-memory row
constexpr int kServeChunk = 32;       // the ring: keys per stage and per online-softmax step
constexpr float kRescaleSlack = 8.0f; // the ring: log2 units a row max may outgrow the one in use

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// shared memory (bf16): Ks[Sp][HD + kPad] and Vs[Sp][HD + kPad], both
// row-major by key, Sp = S rounded up to kKeyChunk; padded keys are zero.
// Rows are 16 bytes longer than the head so that the eight row addresses of
// an ldmatrix fall on distinct banks. kLse: also write the row log-sum-exp
// lse[(b * H + h) * S + row] (natural log).
template <int HD, bool kLse>
__global__ void __launch_bounds__(kMmaWarps * 32)
attention_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int S, int H, float scale_log2e) {
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
    if constexpr (kLse) {
      if (t == 0) {
        float* row_lse = lse + (size_t)blockIdx.x * S;
        if (r_lo < S) row_lse[r_lo] = (m_lo + log2f(l_lo)) * kLn2;
        if (r_hi < S) row_lse[r_hi] = (m_hi + log2f(l_hi)) * kLn2;
      }
    }
  }
}

// Shape of the ring kernel's block: kWarps warps, each holding kTiles 16-row
// query tiles (warp w takes tiles w, w + kWarps), kRows query rows in all,
// and a ring of kStages key chunks. 4 warps x 2 tiles, at 128 registers a
// thread: four blocks an SM at head size 32 (the ViT's 225 rows in two
// blocks, 8 + 7 tiles), three at 64. Each K or V fragment read from shared
// memory feeds both tiles of a warp.
template <int HD>
struct Serve {
  static constexpr int kWarps = 4;
  static constexpr int kTiles = 2;
  static constexpr int kBlocksPerSm = HD == 32 ? 4 : 3;   // caps the registers
  static constexpr int kStages = HD == 32 ? 8 : 6;
  static constexpr int kLag = kStages / 2;  // chunks a warp may trail warp 0 before it waits
  static constexpr int kRows = kWarps * kTiles * 16;
  static constexpr int kLd = HD + kPad;     // bf16 per staged row
  // a full and an empty barrier per stage, the block's Q (then O) rows, the
  // ring's K and V stages
  static constexpr size_t kSharedBytes =
      2 * kStages * sizeof(uint64_t) +
      sizeof(__nv_bfloat16) * (size_t)(kRows + 2 * kStages * kServeChunk) * kLd;
};

// f(std::integral_constant<int, n>) for the warp's n = n_mine (1 .. R) row
// tiles that hold rows of the sequence, each count its own unrolled code
template <int R, typename F>
__device__ __forceinline__ void with_tiles(int n_mine, F&& f) {
  if constexpr (R > 0) {
    if (n_mine == R)
      f(std::integral_constant<int, R>{});
    else
      with_tiles<R - 1>(n_mine, f);
  }
}

// S = Q K^T for the first NR row tiles of a warp against a staged chunk of
// kServeChunk keys (Ks): each K fragment (8 keys x 32 head columns) feeds
// all NR tiles. kFull: every key of the chunk is real. Otherwise keys_left
// (1 .. kServeChunk - 1) are: the 8-key tiles past them are skipped and the
// keys past S in the last one are set to -inf.
template <int HD, int NR, bool kFull>
__device__ __forceinline__ void serve_qk(const __nv_bfloat16* Ks, int keys_left,
                                         const uint32_t (&qf)[Serve<HD>::kTiles][HD / 16][4],
                                         float (&s)[Serve<HD>::kTiles][kServeChunk / 8][4],
                                         int lane) {
  constexpr int kLd = Serve<HD>::kLd, NT = kServeChunk / 8;
  const int t = lane & 3, lm = lane >> 3, lr = lane & 7;
  const int n_tiles = kFull ? NT : (keys_left + 7) >> 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (kFull || nt < n_tiles) {
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][nt][e] = 0.0f;
      const __nv_bfloat16* kr = Ks + (nt * 8 + lr) * kLd + lm * 8;
#pragma unroll
      for (int kk = 0; kk < HD / 32; ++kk) {
        uint32_t kb[4];
        ldmatrix_x4(kb, kr + kk * 32);
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          mma_bf16(s[i][nt], qf[i][2 * kk], kb[0], kb[1]);
          mma_bf16(s[i][nt], qf[i][2 * kk + 1], kb[2], kb[3]);
        }
      }
      if (!kFull) {
        const int key = nt * 8 + t * 2;
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          if (key >= keys_left) s[i][nt][0] = s[i][nt][2] = -CUDART_INF_F;
          if (key + 1 >= keys_left) s[i][nt][1] = s[i][nt][3] = -CUDART_INF_F;
        }
      }
    }
  }
}

// The online softmax of one chunk's scores s for NR row tiles: the rows'
// max, the rescale of O and l when it moves, p = 2^(s scale - m) summed into
// l and packed to bf16 as the A operand of P V (pa; zero for 8-key tiles
// past the keys).
template <int HD, int NR, bool kFull>
__device__ __forceinline__ void serve_softmax(int keys_left,
                                              float (&s)[Serve<HD>::kTiles][kServeChunk / 8][4],
                                              float (&oacc)[Serve<HD>::kTiles][HD / 8][4],
                                              float (&m)[Serve<HD>::kTiles][2],
                                              float (&l)[Serve<HD>::kTiles][2],
                                              uint32_t (&pa)[Serve<HD>::kTiles][kServeChunk / 16][4],
                                              float scale_log2e) {
  constexpr int NT = kServeChunk / 8;
  const int n_tiles = kFull ? NT : (keys_left + 7) >> 3;
  // each row's chunk max on the raw scores (the scale is positive), in log2
  // units; a row needs a new max once it passes the one in use by the slack
  float c[NR][2];
  bool grow = false;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    c[i][0] = c[i][1] = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (kFull || nt < n_tiles) {
        c[i][0] = fmaxf(c[i][0], fmaxf(s[i][nt][0], s[i][nt][1]));
        c[i][1] = fmaxf(c[i][1], fmaxf(s[i][nt][2], s[i][nt][3]));
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      c[i][hf] = fmaxf(c[i][hf], __shfl_xor_sync(0xffffffffu, c[i][hf], 1));
      c[i][hf] = fmaxf(c[i][hf], __shfl_xor_sync(0xffffffffu, c[i][hf], 2));
      c[i][hf] *= scale_log2e;      // finite: every chunk holds a real key
      grow |= c[i][hf] > m[i][hf] + kRescaleSlack;
    }
  }
  // The warp moves its rows' max (and rescales O and l) only when some row
  // outgrew the one in use by more than the slack, so always on the first
  // chunk (m = -inf, alpha = 0). Between moves p = 2^(s scale - m) stays
  // below 2^kRescaleSlack, and a chunk skips the rescale and its exps.
  if (__any_sync(0xffffffffu, grow)) {
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float n = fmaxf(m[i][hf], c[i][hf]);
        const float alpha = fast_exp2(m[i][hf] - n);
        m[i][hf] = n;
        l[i][hf] *= alpha;
#pragma unroll
        for (int dt = 0; dt < HD / 8; ++dt) {
          oacc[i][dt][2 * hf] *= alpha;
          oacc[i][dt][2 * hf + 1] *= alpha;
        }
      }
  }
  // p = 2^(s scale - m): one multiply-add and one exp2 per score; two
  // neighbouring 16 x 8 tiles of P are the 16 x 16 A operand of P V
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t* a = &pa[i][nt >> 1][(nt & 1) * 2];
      if (kFull || nt < n_tiles) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) p[e] = fast_exp2(fmaf(s[i][nt][e], scale_log2e, -m[i][e >> 1]));
        l[i][0] += p[0] + p[1];
        l[i][1] += p[2] + p[3];
        a[0] = pack_bf16(p[0], p[1]);
        a[1] = pack_bf16(p[2], p[3]);
      } else {
        a[0] = a[1] = 0u;
      }
    }
}

// O += P V for NR row tiles against a staged chunk's V (Vs): each V
// fragment (16 keys x 16 head columns, by a transposed load) feeds all NR
// tiles. n_k16: the 16-key steps that hold real keys.
template <int HD, int NR>
__device__ __forceinline__ void serve_pv(const __nv_bfloat16* Vs, int n_k16,
                                         const uint32_t (&pa)[Serve<HD>::kTiles][kServeChunk / 16][4],
                                         float (&oacc)[Serve<HD>::kTiles][HD / 8][4], int lane) {
  constexpr int kLd = Serve<HD>::kLd;
  const int lm = lane >> 3, lr = lane & 7;
#pragma unroll
  for (int kt = 0; kt < kServeChunk / 16; ++kt) {
    if (kt < n_k16) {
      const __nv_bfloat16* vr = Vs + (kt * 16 + (lm & 1) * 8 + lr) * kLd + (lm >> 1) * 8;
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vr + dp * 16);
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          mma_bf16(oacc[i][2 * dp], pa[i][kt], vb[0], vb[1]);
          mma_bf16(oacc[i][2 * dp + 1], pa[i][kt], vb[2], vb[3]);
        }
      }
    }
  }
}

// One block per (batch row, head, kRows query rows). Shared memory: the
// ring's barriers, then (bf16, rows of kLd) the block's Q rows, which each
// warp copies and reads once into registers and later overwrites with its
// own rows of O, then the ring: kStages stages of kServeChunk keys of K and
// of V. Warp 0 fills the ring by cp.async, chunk x into stage x % kStages,
// and each stage's full barrier completes when those copies have landed;
// every warp waits on it, uses the chunk and arrives on the stage's empty
// barrier. Warp 0 refills a stage only once every warp has left it, and
// keeps kStages - kLag chunks ahead of its own, so that warps run apart by
// up to kLag chunks: no block-wide barrier stops them after the start.
// kLse: also write the row log-sum-exp lse[(b * H + h) * S + row] (natural
// log).
template <int HD, bool kLse>
__global__ void __launch_bounds__(Serve<HD>::kWarps * 32, Serve<HD>::kBlocksPerSm)
attention_ring_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int S, int H, float scale_log2e) {
  using Sv = Serve<HD>;
  constexpr int kLd = Sv::kLd, R = Sv::kTiles, NS = Sv::kStages;
  constexpr int kVec = HD / 8;                                  // 16-byte pieces a row
  constexpr int kStage = 2 * kServeChunk * kLd;                 // bf16 of one ring stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + NS;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(empty + NS);
  __nv_bfloat16* ring = Qs + Sv::kRows * kLd;

  const int n_row_blocks = (S + Sv::kRows - 1) / Sv::kRows;
  const int bh = blockIdx.x / n_row_blocks;
  const int row0 = (blockIdx.x - bh * n_row_blocks) * Sv::kRows;
  const int D = H * HD;
  const size_t base = (size_t)(bh / H) * S * D + (size_t)(bh % H) * HD;
  const int n_chunks = (S + kServeChunk - 1) / kServeChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int st = 0; st < NS; ++st) {
      mbar_init(&full[st], 32);             // warp 0's lanes, once their copies land
      mbar_init(&empty[st], Sv::kWarps);    // one arrival a warp
    }
  }
  __syncthreads();

  // warp 0: K and V of chunk x into stage x % NS (zeros past S)
  auto fill = [&](int x) {
    __nv_bfloat16* Ks = ring + (x % NS) * kStage;
    for (int i = lane; i < kServeChunk * kVec; i += 32) {
      const int r = i / kVec, col = (i - r * kVec) * 8, key = x * kServeChunk + r;
      const size_t src = base + (size_t)min(key, S - 1) * D + col;
      cp_async16(Ks + r * kLd + col, k + src, key < S ? 16 : 0);
      cp_async16(Ks + (kServeChunk + r) * kLd + col, v + src, key < S ? 16 : 0);
    }
    cp_async_arrive(&full[x % NS]);
  };
  // each warp's own Q rows (zeros past S), as its one cp.async group
  for (int i = 0; i < R; ++i) {
    const int tr = (warp + i * Sv::kWarps) * 16;
    for (int j = lane; j < 16 * kVec; j += 32) {
      const int r = j / kVec, col = (j - r * kVec) * 8, row = row0 + tr + r;
      cp_async16(Qs + (tr + r) * kLd + col, q + base + (size_t)min(row, S - 1) * D + col,
                 row < S ? 16 : 0);
    }
  }
  cp_async_commit();
  if (warp == 0)
    for (int x = 0; x < min(NS, n_chunks); ++x) fill(x);
  cp_async_wait<0>();                     // the Q group (the ring's copies are in none)
  __syncwarp();

  const int g = lane >> 2, t = lane & 3, lm = lane >> 3, lr = lane & 7;
  int n_mine = 0;                         // this warp's tiles that hold rows < S
#pragma unroll
  for (int i = 0; i < R; ++i) n_mine += row0 + (warp + i * Sv::kWarps) * 16 < S;

  uint32_t qf[R][HD / 16][4];
  float oacc[R][HD / 8][4], m[R][2], l[R][2];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[i][dt][e] = 0.0f;
    m[i][0] = m[i][1] = -CUDART_INF_F;     // row max in use (log2 units)
    l[i][0] = l[i][1] = 0.0f;               // this lane's share of the row sums
  }

  // Q fragments: rows g, g + 8 of each tile
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i < n_mine) {
      const __nv_bfloat16* qr =
          Qs + ((warp + i * Sv::kWarps) * 16 + (lm & 1) * 8 + lr) * kLd + (lm >> 1) * 8;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) ldmatrix_x4(qf[i][ks], qr + ks * 16);
    }
  }

  float s[R][kServeChunk / 8][4];
  uint32_t pa[R][kServeChunk / 16][4];
  for (int c = 0; c < n_chunks; ++c) {
    const int x = c + NS - Sv::kLag;        // warp 0 refills the stage chunk x - NS used
    if (warp == 0 && x >= NS && x < n_chunks) {
      mbar_wait(&empty[x % NS], (x / NS - 1) & 1);
      fill(x);
    }
    const int st = c % NS, keys_left = S - c * kServeChunk;
    const __nv_bfloat16* Ks = ring + st * kStage;
    mbar_wait(&full[st], (c / NS) & 1);
    with_tiles<R>(n_mine, [&](auto nr) {
      constexpr int NR = decltype(nr)::value;
      if (keys_left >= kServeChunk) {
        serve_qk<HD, NR, true>(Ks, keys_left, qf, s, lane);
        serve_softmax<HD, NR, true>(keys_left, s, oacc, m, l, pa, scale_log2e);
        serve_pv<HD, NR>(Ks + kServeChunk * kLd, kServeChunk / 16, pa, oacc, lane);
      } else {
        serve_qk<HD, NR, false>(Ks, keys_left, qf, s, lane);
        serve_softmax<HD, NR, false>(keys_left, s, oacc, m, l, pa, scale_log2e);
        serve_pv<HD, NR>(Ks + kServeChunk * kLd, (keys_left + 15) >> 4, pa, oacc, lane);
      }
    });
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // O = acc / l in bf16, staged in the warp's own Q rows (no other warp
  // reads them), then out by 16-byte stores, a row's 2 * HD bytes from
  // neighbouring lanes; rows past S are never stored
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i < n_mine) {
      const int tr = (warp + i * Sv::kWarps) * 16;
      float sum[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        sum[hf] = l[i][hf] + __shfl_xor_sync(0xffffffffu, l[i][hf], 1);
        sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 2);
      }
      const float inv0 = 1.0f / sum[0], inv1 = 1.0f / sum[1];
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        const int col = dt * 8 + t * 2;
        *reinterpret_cast<uint32_t*>(Qs + (tr + g) * kLd + col) =
            pack_bf16(oacc[i][dt][0] * inv0, oacc[i][dt][1] * inv0);
        *reinterpret_cast<uint32_t*>(Qs + (tr + g + 8) * kLd + col) =
            pack_bf16(oacc[i][dt][2] * inv1, oacc[i][dt][3] * inv1);
      }
      if constexpr (kLse) {
        if (t == 0) {
          float* row_lse = lse + (size_t)bh * S + row0 + tr;
          if (row0 + tr + g < S) row_lse[g] = (m[i][0] + log2f(sum[0])) * kLn2;
          if (row0 + tr + g + 8 < S) row_lse[g + 8] = (m[i][1] + log2f(sum[1])) * kLn2;
        }
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i < n_mine) {
      const int tr = (warp + i * Sv::kWarps) * 16;
      for (int j = lane; j < 16 * kVec; j += 32) {
        const int r = j / kVec, col = (j - r * kVec) * 8, row = row0 + tr + r;
        if (row < S)
          *reinterpret_cast<uint4*>(o + base + (size_t)row * D + col) =
              *reinterpret_cast<const uint4*>(Qs + (tr + r) * kLd + col);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// TF32 tensor-core kernels: mma.sync m16n8k8, 3xTF32 for f32 inputs
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;                 // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kTile = kWarps * 16;        // rows a block owns, rows per staged tile

// floats per staged row: HD + 4 makes both fragment reads conflict-free
// (row g, column t: bank 4g + t; rows 2t and 2t+1, column g: bank 8t + g)
// and keeps rows 16-byte aligned for cp.async
template <int HD>
__host__ __device__ constexpr int tile_ld() { return HD + 4; }

template <int HD>
__host__ __device__ constexpr int tile_floats() { return kTile * tile_ld<HD>(); }

__device__ __forceinline__ uint32_t tf32_of(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32; lo only where the operands are f32
template <bool kSplit>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_of(x);
  if constexpr (kSplit)
    lo = tf32_of(x - __uint_as_float(hi));
  else
    lo = 0u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b: a_lo b_hi, a_hi b_lo, then a_hi b_hi (one product without kSplit)
template <bool kSplit>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if constexpr (kSplit) {
    mma_tf32(c, al, bh[0], bh[1]);
    mma_tf32(c, ah, bl[0], bl[1]);
  }
  mma_tf32(c, ah, bh[0], bh[1]);
}

template <bool kSplit>
__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&h)[4], uint32_t (&l)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split<kSplit>(x[e], h[e], l[e]);
}

// A operand (16 rows x 8 head columns from col0) of one head of a packed
// tensor, from device memory: a0 (g, t), a1 (g+8, t), a2 (g, t+4),
// a3 (g+8, t+4); zero past S and past the head
template <typename T>
__device__ __forceinline__ void a_values(const T* __restrict__ x, size_t base, int row0,
                                         int col0, int S, int D, int hd, int g, int t,
                                         float (&v)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = row0 + g + (e & 1) * 8, col = col0 + t + (e >> 1) * 4;
    v[e] = (row < S && col < hd) ? to_float(x[base + (size_t)row * D + col]) : 0.0f;
  }
}

// B operand X^T (k = head column, n = row of X) of a staged tile (f32, or
// bf16 in the one-pass wide kernels):
// b0 = X[n0 + g][k0 + t], b1 = X[n0 + g][k0 + t + 4]
template <bool kSplit, typename E>
__device__ __forceinline__ void b_rows(const E* X, int ld, int n0, int k0, int g, int t,
                                       uint32_t (&h)[2], uint32_t (&l)[2]) {
  const E* p = X + (n0 + g) * ld + k0 + t;
  split<kSplit>(to_float(p[0]), h[0], l[0]);
  split<kSplit>(to_float(p[4]), h[1], l[1]);
}

// B operand X (k = row of X, n = head column) of a staged tile, its 8 rows
// in the order of acc_as_a: b0 = X[k0 + 2t][n0 + g], b1 = X[k0 + 2t + 1][n0 + g]
template <bool kSplit, typename E>
__device__ __forceinline__ void b_cols(const E* X, int ld, int k0, int n0, int g, int t,
                                       uint32_t (&h)[2], uint32_t (&l)[2]) {
  const E* p = X + (k0 + 2 * t) * ld + n0 + g;
  split<kSplit>(to_float(p[0]), h[0], l[0]);
  split<kSplit>(to_float(p[ld]), h[1], l[1]);
}

// A 16x8 accumulator tile (lane (g, t) holds columns 2t, 2t+1 of rows g,
// g+8) as the A operand of the next product with its columns taken in the
// order 0, 2, 4, 6, 1, 3, 5, 7: column 2t goes to k-slot t, 2t+1 to t+4
template <bool kSplit>
__device__ __forceinline__ void acc_as_a(const float (&c)[4], uint32_t (&h)[4],
                                         uint32_t (&l)[4]) {
  split<kSplit>(c[0], h[0], l[0]);
  split<kSplit>(c[2], h[1], l[1]);
  split<kSplit>(c[1], h[2], l[2]);
  split<kSplit>(c[3], h[3], l[3]);
}

// Rows row0 .. row0 + kTile - 1, columns [0, hd), of one head of a packed
// (B, S, D) tensor into a staged tile of f32 rows ld floats apart; rows past
// S are zero. f32 by cp.async (16 bytes a copy where hd is a multiple of 4),
// bf16 converted to f32 on the way.
template <typename T>
__device__ __forceinline__ void stage_tile(float* dst, int ld, const T* __restrict__ src,
                                           size_t base, int row0, int S, int D, int hd) {
  if constexpr (std::is_same<T, float>::value) {
    if ((hd & 3) == 0) {
      const int per_row = hd >> 2;
      for (int i = threadIdx.x; i < kTile * per_row; i += kThreads) {
        const int r = i / per_row, c = (i - r * per_row) * 4, row = row0 + r;
        cp_async16(dst + r * ld + c, src + base + (size_t)min(row, S - 1) * D + c,
                   row < S ? 16 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < kTile * hd; i += kThreads) {
        const int r = i / hd, c = i - r * hd, row = row0 + r;
        cp_async4(dst + r * ld + c, src + base + (size_t)min(row, S - 1) * D + c,
                  row < S ? 4 : 0);
      }
    }
  } else {
    if ((hd & 3) == 0) {
      const int per_row = hd >> 2;
      for (int i = threadIdx.x; i < kTile * per_row; i += kThreads) {
        const int r = i / per_row, c = (i - r * per_row) * 4, row = row0 + r;
        float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (row < S) {
          const uint2 raw = *reinterpret_cast<const uint2*>(src + base + (size_t)row * D + c);
          const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
          const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
          f = make_float4(a.x, a.y, b.x, b.y);
        }
        *reinterpret_cast<float4*>(dst + r * ld + c) = f;
      }
    } else {
      for (int i = threadIdx.x; i < kTile * hd; i += kThreads) {
        const int r = i / hd, c = i - r * hd, row = row0 + r;
        dst[r * ld + c] = row < S ? to_float(src[base + (size_t)row * D + c]) : 0.0f;
      }
    }
  }
}

// kTile entries of a (B, H, S) row vector from row0; zero past S
__device__ __forceinline__ void stage_vec(float* dst, const float* __restrict__ src, int row0,
                                          int S) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int row = row0 + i;
    cp_async4(dst + i, src + min(row, S - 1), row < S ? 4 : 0);
  }
}

// columns [hd, HD) of n_tiles consecutive staged tiles, which the staging
// never writes, to zero
template <int HD>
__device__ __forceinline__ void zero_pad_columns(float* tiles, int n_tiles, int hd) {
  const int w = HD - hd;
  for (int i = threadIdx.x; i < n_tiles * kTile * w; i += kThreads) {
    const int r = i / w;
    tiles[r * tile_ld<HD>() + hd + (i - r * w)] = 0.0f;
  }
}

template <typename T>
__device__ __forceinline__ void store_pair(T* __restrict__ row, int col, int hd, float x,
                                           float y) {
  if (col < hd) from_float(row + col, x);
  if (col + 1 < hd) from_float(row + col + 1, y);
}

// One key tile of kN x 8 keys of the online softmax, on logits already in
// log2 units: mask the keys past the end, move the running row maxima,
// rescale the sums and the output accumulators, and turn s into the tile's
// probabilities
template <int kSteps, int kN = kTile / 8>
__device__ __forceinline__ void softmax_step(float (&s)[kN][4], int keys_left, int t,
                                             float& m_lo, float& m_hi, float& l_lo,
                                             float& l_hi, float (&oacc)[kSteps][4]) {
  if (keys_left < kN * 8) {   // mask the keys past the end
#pragma unroll
    for (int nt = 0; nt < kN; ++nt) {
      const int key = nt * 8 + t * 2;
      if (key >= keys_left) s[nt][0] = s[nt][2] = -CUDART_INF_F;
      if (key + 1 >= keys_left) s[nt][1] = s[nt][3] = -CUDART_INF_F;
    }
  }
  float c_lo = -CUDART_INF_F, c_hi = -CUDART_INF_F;
#pragma unroll
  for (int nt = 0; nt < kN; ++nt) {
    c_lo = fmaxf(c_lo, fmaxf(s[nt][0], s[nt][1]));
    c_hi = fmaxf(c_hi, fmaxf(s[nt][2], s[nt][3]));
  }
  c_lo = fmaxf(c_lo, __shfl_xor_sync(0xffffffffu, c_lo, 1));
  c_lo = fmaxf(c_lo, __shfl_xor_sync(0xffffffffu, c_lo, 2));
  c_hi = fmaxf(c_hi, __shfl_xor_sync(0xffffffffu, c_hi, 1));
  c_hi = fmaxf(c_hi, __shfl_xor_sync(0xffffffffu, c_hi, 2));
  // every tile holds at least one real key, so the new max is finite
  const float n_lo = fmaxf(m_lo, c_lo), n_hi = fmaxf(m_hi, c_hi);
  const float a_lo = fast_exp2(m_lo - n_lo), a_hi = fast_exp2(m_hi - n_hi);
  m_lo = n_lo;
  m_hi = n_hi;
  l_lo *= a_lo;
  l_hi *= a_hi;
#pragma unroll
  for (int dt = 0; dt < kSteps; ++dt) {
    oacc[dt][0] *= a_lo;
    oacc[dt][1] *= a_lo;
    oacc[dt][2] *= a_hi;
    oacc[dt][3] *= a_hi;
  }
#pragma unroll
  for (int nt = 0; nt < kN; ++nt) {
    s[nt][0] = fast_exp2(s[nt][0] - m_lo);
    s[nt][1] = fast_exp2(s[nt][1] - m_lo);
    s[nt][2] = fast_exp2(s[nt][2] - m_hi);
    s[nt][3] = fast_exp2(s[nt][3] - m_hi);
    l_lo += s[nt][0] + s[nt][1];
    l_hi += s[nt][2] + s[nt][3];
  }
}

// Forward. shared memory: K and V tiles, two stages each, kTile x tile_ld f32
template <typename T, int HD, bool kLse>
__global__ void __launch_bounds__(kThreads)
attention_tf32_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ o, float* __restrict__ lse, int S, int H, int hd,
                      float scale_log2e) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int ld = tile_ld<HD>(), kSteps = HD / 8, kTf = tile_floats<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);   // [2][kTile][ld]
  float* Vs = Ks + 2 * kTf;                         // [2][kTile][ld]

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int D = H * hd;
  const size_t base = (size_t)b * S * D + (size_t)h * hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * kTile + warp * 16;
  const int n_tiles = (S + kTile - 1) / kTile;

  zero_pad_columns<HD>(Ks, 4, hd);
  stage_tile<T>(Ks, ld, k, base, 0, S, D, hd);
  stage_tile<T>(Vs, ld, v, base, 0, S, D, hd);
  cp_async_commit();

  uint32_t qh[kSteps][4], ql[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    float x[4];
    a_values(q, base, row0, ks * 8, S, D, hd, g, t, x);
    split4<kSplit>(x, qh[ks], ql[ks]);
  }
  float oacc[kSteps][4];
#pragma unroll
  for (int dt = 0; dt < kSteps; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[dt][e] = 0.0f;
  float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F;   // running row max (log2 units)
  float l_lo = 0.0f, l_hi = 0.0f;                     // this thread's share of the row sums

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {   // the next tile loads while this one is multiplied
      const int nb = (it + 1) & 1;
      stage_tile<T>(Ks + nb * kTf, ld, k, base, (it + 1) * kTile, S, D, hd);
      stage_tile<T>(Vs + nb * kTf, ld, v, base, (it + 1) * kTile, S, D, hd);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Kt = Ks + (it & 1) * kTf;
    const float* Vt = Vs + (it & 1) * kTf;
    const int keys_left = S - it * kTile;

    float s[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        uint32_t bfh[2], bfl[2];
        b_rows<kSplit>(Kt, ld, nt * 8, ks * 8, g, t, bfh, bfl);
        mma3<kSplit>(s[nt], qh[ks], ql[ks], bfh, bfl);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= scale_log2e;   // log2 units, any sign of scale
    }
    softmax_step<kSteps>(s, keys_left, t, m_lo, m_hi, l_lo, l_hi, oacc);
    // O += P V, 8 keys per k-step, P straight from the accumulators
#pragma unroll
    for (int kt = 0; kt < kTile / 8; ++kt) {
      uint32_t ph[4], pl[4];
      acc_as_a<kSplit>(s[kt], ph, pl);
#pragma unroll
      for (int dt = 0; dt < kSteps; ++dt) {
        uint32_t bfh[2], bfl[2];
        b_cols<kSplit>(Vt, ld, kt * 8, dt * 8, g, t, bfh, bfl);
        mma3<kSplit>(oacc[dt], ph, pl, bfh, bfl);
      }
    }
    __syncthreads();   // the next iteration's copy overwrites this buffer
  }

  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float i_lo = 1.0f / l_lo, i_hi = 1.0f / l_hi;
  const int r_lo = row0 + g, r_hi = r_lo + 8;
#pragma unroll
  for (int dt = 0; dt < kSteps; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (r_lo < S)
      store_pair(o + base + (size_t)r_lo * D, col, hd, oacc[dt][0] * i_lo, oacc[dt][1] * i_lo);
    if (r_hi < S)
      store_pair(o + base + (size_t)r_hi * D, col, hd, oacc[dt][2] * i_hi, oacc[dt][3] * i_hi);
  }
  if constexpr (kLse) {
    if (t == 0) {
      float* row_lse = lse + (size_t)bh * S;
      if (r_lo < S) row_lse[r_lo] = (m_lo + log2f(l_lo)) * kLn2;
      if (r_hi < S) row_lse[r_hi] = (m_hi + log2f(l_hi)) * kLn2;
    }
  }
}

// Backward, first kernel: delta and dQ for kTile query rows. shared memory
// as the forward's: K and V tiles, two stages each
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ delta, T* __restrict__ dq, int S, int H, int hd,
                        float scale, float scale_log2e) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int ld = tile_ld<HD>(), kSteps = HD / 8, kTf = tile_floats<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + 2 * kTf;

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int D = H * hd;
  const size_t base = (size_t)b * S * D + (size_t)h * hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * kTile + warp * 16;
  const int n_tiles = (S + kTile - 1) / kTile;

  zero_pad_columns<HD>(Ks, 4, hd);
  stage_tile<T>(Ks, ld, k, base, 0, S, D, hd);
  stage_tile<T>(Vs, ld, v, base, 0, S, D, hd);
  cp_async_commit();

  // Q and dO fragments; delta = rowsum(dO o) over the same elements
  uint32_t qh[kSteps][4], ql[kSteps][4], gh[kSteps][4], gl[kSteps][4];
  float del_lo = 0.0f, del_hi = 0.0f;
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    float x[4], y[4], z[4];
    a_values(q, base, row0, ks * 8, S, D, hd, g, t, x);
    a_values(dout, base, row0, ks * 8, S, D, hd, g, t, y);
    a_values(o, base, row0, ks * 8, S, D, hd, g, t, z);
    del_lo = fmaf(y[0], z[0], fmaf(y[2], z[2], del_lo));
    del_hi = fmaf(y[1], z[1], fmaf(y[3], z[3], del_hi));
    split4<kSplit>(x, qh[ks], ql[ks]);
    split4<kSplit>(y, gh[ks], gl[ks]);
  }
  // a row's four lanes (t = 0..3) hold a quarter of its columns each
  del_lo += __shfl_xor_sync(0xffffffffu, del_lo, 1);
  del_lo += __shfl_xor_sync(0xffffffffu, del_lo, 2);
  del_hi += __shfl_xor_sync(0xffffffffu, del_hi, 1);
  del_hi += __shfl_xor_sync(0xffffffffu, del_hi, 2);
  const int r_lo = row0 + g, r_hi = r_lo + 8;
  const float* row_lse = lse + (size_t)bh * S;
  const float L_lo = r_lo < S ? row_lse[r_lo] * kLog2e : 0.0f;
  const float L_hi = r_hi < S ? row_lse[r_hi] * kLog2e : 0.0f;
  if (t == 0) {
    if (r_lo < S) delta[(size_t)bh * S + r_lo] = del_lo;
    if (r_hi < S) delta[(size_t)bh * S + r_hi] = del_hi;
  }

  float dacc[kSteps][4];
#pragma unroll
  for (int dt = 0; dt < kSteps; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dacc[dt][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      const int nb = (it + 1) & 1;
      stage_tile<T>(Ks + nb * kTf, ld, k, base, (it + 1) * kTile, S, D, hd);
      stage_tile<T>(Vs + nb * kTf, ld, v, base, (it + 1) * kTile, S, D, hd);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Kt = Ks + (it & 1) * kTf;
    const float* Vt = Vs + (it & 1) * kTf;
    const int keys_left = S - it * kTile;

    // 8 keys at a time: S, dP, then dS K into dQ
#pragma unroll 2
    for (int nt = 0; nt < kTile / 8; ++nt) {
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        uint32_t bfh[2], bfl[2];
        b_rows<kSplit>(Kt, ld, nt * 8, ks * 8, g, t, bfh, bfl);
        mma3<kSplit>(s, qh[ks], ql[ks], bfh, bfl);
        b_rows<kSplit>(Vt, ld, nt * 8, ks * 8, g, t, bfh, bfl);
        mma3<kSplit>(dp, gh[ks], gl[ks], bfh, bfl);
      }
      float p[4];
      p[0] = fast_exp2(fmaf(s[0], scale_log2e, -L_lo));
      p[1] = fast_exp2(fmaf(s[1], scale_log2e, -L_lo));
      p[2] = fast_exp2(fmaf(s[2], scale_log2e, -L_hi));
      p[3] = fast_exp2(fmaf(s[3], scale_log2e, -L_hi));
      if (keys_left < kTile) {   // keys past the end: zero rows of K and V, P set to 0
        const int key = nt * 8 + 2 * t;
        if (key >= keys_left) p[0] = p[2] = 0.0f;
        if (key + 1 >= keys_left) p[1] = p[3] = 0.0f;
      }
      float ds[4];
      ds[0] = p[0] * (dp[0] - del_lo);
      ds[1] = p[1] * (dp[1] - del_lo);
      ds[2] = p[2] * (dp[2] - del_hi);
      ds[3] = p[3] * (dp[3] - del_hi);
      uint32_t ah[4], al[4];
      acc_as_a<kSplit>(ds, ah, al);
#pragma unroll
      for (int dt = 0; dt < kSteps; ++dt) {
        uint32_t bfh[2], bfl[2];
        b_cols<kSplit>(Kt, ld, nt * 8, dt * 8, g, t, bfh, bfl);
        mma3<kSplit>(dacc[dt], ah, al, bfh, bfl);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int dt = 0; dt < kSteps; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (r_lo < S)
      store_pair(dq + base + (size_t)r_lo * D, col, hd, dacc[dt][0] * scale,
                 dacc[dt][1] * scale);
    if (r_hi < S)
      store_pair(dq + base + (size_t)r_hi * D, col, hd, dacc[dt][2] * scale,
                 dacc[dt][3] * scale);
  }
}

// Backward, second kernel: dK and dV for kTile keys, after the first has
// written delta. shared memory: Q and dO tiles, two stages each, then L and
// delta for each stage's kTile queries
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int S, int H, int hd,
                          float scale, float scale_log2e) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int ld = tile_ld<HD>(), kSteps = HD / 8, kTf = tile_floats<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // [2][kTile][ld]
  float* Gs = Qs + 2 * kTf;                         // dO, [2][kTile][ld]
  float* Ls = Gs + 2 * kTf;                         // [2][kTile]
  float* Ds = Ls + 2 * kTile;                       // [2][kTile]

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int D = H * hd;
  const size_t base = (size_t)b * S * D + (size_t)h * hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = blockIdx.y * kTile + warp * 16;
  const int n_tiles = (S + kTile - 1) / kTile;
  const float* row_lse = lse + (size_t)bh * S;
  const float* row_delta = delta + (size_t)bh * S;

  zero_pad_columns<HD>(Qs, 4, hd);
  stage_tile<T>(Qs, ld, q, base, 0, S, D, hd);
  stage_tile<T>(Gs, ld, dout, base, 0, S, D, hd);
  stage_vec(Ls, row_lse, 0, S);
  stage_vec(Ds, row_delta, 0, S);
  cp_async_commit();

  uint32_t kh[kSteps][4], kl[kSteps][4], vh[kSteps][4], vl[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    float x[4];
    a_values(k, base, key0, ks * 8, S, D, hd, g, t, x);
    split4<kSplit>(x, kh[ks], kl[ks]);
    a_values(v, base, key0, ks * 8, S, D, hd, g, t, x);
    split4<kSplit>(x, vh[ks], vl[ks]);
  }
  float kacc[kSteps][4], vacc[kSteps][4];
#pragma unroll
  for (int dt = 0; dt < kSteps; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) kacc[dt][e] = vacc[dt][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      const int nb = (it + 1) & 1, next = (it + 1) * kTile;
      stage_tile<T>(Qs + nb * kTf, ld, q, base, next, S, D, hd);
      stage_tile<T>(Gs + nb * kTf, ld, dout, base, next, S, D, hd);
      stage_vec(Ls + nb * kTile, row_lse, next, S);
      stage_vec(Ds + nb * kTile, row_delta, next, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Qt = Qs + (it & 1) * kTf;
    const float* Gt = Gs + (it & 1) * kTf;
    const float* Lt = Ls + (it & 1) * kTile;
    const float* Dt = Ds + (it & 1) * kTile;

    // 8 queries at a time. Queries past S are zero rows with L = delta = 0:
    // P = 1 there, and dO = 0 and dS = 0 keep them out of both sums.
#pragma unroll 2
    for (int nt = 0; nt < kTile / 8; ++nt) {
      float st[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dpt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        uint32_t bfh[2], bfl[2];
        b_rows<kSplit>(Qt, ld, nt * 8, ks * 8, g, t, bfh, bfl);
        mma3<kSplit>(st, kh[ks], kl[ks], bfh, bfl);
        b_rows<kSplit>(Gt, ld, nt * 8, ks * 8, g, t, bfh, bfl);
        mma3<kSplit>(dpt, vh[ks], vl[ks], bfh, bfl);
      }
      const int qa = nt * 8 + 2 * t;   // this lane's two queries: columns 0/2 and 1/3
      const float L0 = Lt[qa] * kLog2e, L1 = Lt[qa + 1] * kLog2e;
      const float d0 = Dt[qa], d1 = Dt[qa + 1];
      float p[4], ds[4];
      p[0] = fast_exp2(fmaf(st[0], scale_log2e, -L0));
      p[1] = fast_exp2(fmaf(st[1], scale_log2e, -L1));
      p[2] = fast_exp2(fmaf(st[2], scale_log2e, -L0));
      p[3] = fast_exp2(fmaf(st[3], scale_log2e, -L1));
      ds[0] = p[0] * (dpt[0] - d0);
      ds[1] = p[1] * (dpt[1] - d1);
      ds[2] = p[2] * (dpt[2] - d0);
      ds[3] = p[3] * (dpt[3] - d1);
      uint32_t ph[4], pl[4], sh[4], sl[4];
      acc_as_a<kSplit>(p, ph, pl);
      acc_as_a<kSplit>(ds, sh, sl);
#pragma unroll
      for (int dt = 0; dt < kSteps; ++dt) {
        uint32_t bfh[2], bfl[2];
        b_cols<kSplit>(Gt, ld, nt * 8, dt * 8, g, t, bfh, bfl);
        mma3<kSplit>(vacc[dt], ph, pl, bfh, bfl);
        b_cols<kSplit>(Qt, ld, nt * 8, dt * 8, g, t, bfh, bfl);
        mma3<kSplit>(kacc[dt], sh, sl, bfh, bfl);
      }
    }
    __syncthreads();
  }

  const int r_lo = key0 + g, r_hi = r_lo + 8;
#pragma unroll
  for (int dt = 0; dt < kSteps; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (r_lo < S) {
      store_pair(dk + base + (size_t)r_lo * D, col, hd, kacc[dt][0] * scale,
                 kacc[dt][1] * scale);
      store_pair(dv + base + (size_t)r_lo * D, col, hd, vacc[dt][0], vacc[dt][1]);
    }
    if (r_hi < S) {
      store_pair(dk + base + (size_t)r_hi * D, col, hd, kacc[dt][2] * scale,
                 kacc[dt][3] * scale);
      store_pair(dv + base + (size_t)r_hi * D, col, hd, vacc[dt][2], vacc[dt][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Wide heads (129 to 256 columns): one pass over the whole head
// ---------------------------------------------------------------------------
//
// The same TPU kernels (attention_pallas.py:153 forward, :169 backward) at
// head sizes above 128. Bound at (B=64, S=225, D=256, H=1) f32: the
// operations of the narrow heads at that width, 0.020 ms forward and 0.050
// ms backward as 3xTF32 (bytes 0.018 / 0.031 ms): bound by operations. The
// head is padded with zero columns to kWideHead; the contractions over the
// head stop at the last 8-column step that holds a real column.
//
// A block owns the whole head for its 64 query rows (forward, dQ) or 64
// keys (dK/dV), staged once in shared memory in the input type (f32 rows of
// 260 floats, bf16 rows of 264: both fragment reads free of bank conflicts)
// and read back as fragments, split into TF32 hi/lo on the way: no operand
// is read from device memory inside the loop over the other side's tiles,
// and every product is taken once per block. The streamed tiles come in two
// stages by cp.async (16 bytes a copy where a row allows, else 4; bf16 is
// copied as it is, so asynchronously too, and converted as fragments are
// read: a bf16 value is exact in TF32). 8 warps a block, one block per SM.
// Dynamic shared memory (wide_fwd_bytes, wide_dq_bytes, wide_dkdv_bytes):
// f32 199,680 / 216,064 / 216,320 bytes (forward, dQ, dK/dV), bf16 101,376 /
// 117,760 / 118,016. At (64, 225, 256, 1) each grid is 256 blocks, 1.94
// waves over 132 SMs.
//  * attention_wide_fwd_kernel: two warpgroups of 4 warps x 16 query rows.
//    Each 32-key tile of K and V is split between them, keys 0-15 to the
//    first and 16-31 to the second; each keeps its own online softmax
//    (m, l) and 16 x 256 output accumulator (128 registers a lane) over its
//    half of every tile, and the two states are merged once at the end
//    through shared memory in a fixed order (deterministic).
//  * attention_wide_bwd_dq_kernel (delta and dQ) and
//    attention_wide_bwd_dkdv_kernel (dK and dV from the same block): warp
//    (slab, half) owns 16 rows of the block and 128 of the head's output
//    columns. Per 16-row streamed tile the pair of warps that owns a slab
//    splits the logits (and dP) of its 16 rows against the tile's 16 rows
//    between them by head columns, each contracting its own 128, and adds
//    the two partial sums through shared memory (pair_logits): every
//    product once per block, each A operand used for two products, and P /
//    dS then in registers as the next product's A operand. Sums in one
//    fixed order, no float atomic: two calls give the same bits.
//  One block barrier per streamed tile (two in the backward, for the pair's
//  exchange): the next tile's copy is issued right after it.

constexpr int kWideHead = 256;             // head columns the one-pass kernels hold
constexpr int kWideWarps = 8;
constexpr int kWideThreads = kWideWarps * 32;
constexpr int kWideRows = 64;              // query rows (forward, dQ) or keys (dK/dV) a block owns
constexpr int kFwdKeys = 32;               // keys per streamed forward tile, 16 per warpgroup
constexpr int kBwdRows = 16;               // keys (dQ) or queries (dK/dV) per streamed tile
constexpr int kFrag = 4 * 32;              // one warp's 16 x 8 accumulator tile, in floats

// elements per staged row: 16 bytes past the head keeps rows 16-byte aligned
// and the fragment reads conflict-free (f32: 260 floats, bf16: 264)
template <typename T>
__host__ __device__ constexpr int wide_ld() {
  return kWideHead + 16 / static_cast<int>(sizeof(T));
}

template <typename T>
__device__ __forceinline__ T zero_of() {
  if constexpr (std::is_same<T, float>::value)
    return 0.0f;
  else
    return __float2bfloat16_rn(0.0f);
}

// rows row0 .. row0 + n_rows - 1, columns [0, hd) from base (a head, or a
// column slice of one), of a packed (B, S, D) tensor into staged rows ld
// elements apart, in the input type, by cp.async: 16 bytes a copy where
// every row of the whole head (hd_all columns, from a head's start) is whole
// 16-byte pieces, else 4 (a bf16 head of odd size cannot be copied in
// 4-byte pieces and is loaded plainly); rows past S are zero-filled by the
// copy. A slice starts at a multiple of 256 columns, so hd keeps hd_all's
// divisibility.
template <typename T>
__device__ __forceinline__ void stage_cols(T* dst, int ld, const T* __restrict__ src, size_t base,
                                           int row0, int n_rows, int S, int D, int hd,
                                           int hd_all) {
  constexpr int kPer16 = 16 / sizeof(T), kPer4 = 4 / sizeof(T);
  if (hd_all % kPer16 == 0) {
    const int per_row = hd / kPer16;
    for (int i = threadIdx.x; i < n_rows * per_row; i += kWideThreads) {
      const int r = i / per_row, c = (i - r * per_row) * kPer16, row = row0 + r;
      cp_async16(dst + r * ld + c, src + base + (size_t)min(row, S - 1) * D + c,
                 row < S ? 16 : 0);
    }
  } else if (hd_all % kPer4 == 0) {
    const int per_row = hd / kPer4;
    for (int i = threadIdx.x; i < n_rows * per_row; i += kWideThreads) {
      const int r = i / per_row, c = (i - r * per_row) * kPer4, row = row0 + r;
      cp_async4(dst + r * ld + c, src + base + (size_t)min(row, S - 1) * D + c, row < S ? 4 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < n_rows * hd; i += kWideThreads) {
      const int r = i / hd, c = i - r * hd, row = row0 + r;
      dst[r * ld + c] = row < S ? src[base + (size_t)row * D + c] : zero_of<T>();
    }
  }
}

// the whole head of hd columns
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* __restrict__ src, size_t base,
                                           int row0, int n_rows, int S, int D, int hd) {
  stage_cols(dst, ld, src, base, row0, n_rows, S, D, hd, hd);
}

// n entries of a (B, H, S) row vector from row0 (zero past S), by cp.async
__device__ __forceinline__ void stage_entries(float* dst, const float* __restrict__ src, int row0,
                                              int n, int S) {
  for (int i = threadIdx.x; i < n; i += kWideThreads) {
    const int row = row0 + i;
    cp_async4(dst + i, src + min(row, S - 1), row < S ? 4 : 0);
  }
}

// columns [hd, kWideHead) of n_rows consecutive staged rows, which the
// staging never writes, to zero
template <typename T>
__device__ __forceinline__ void zero_head_pad(T* rows, int n_rows, int hd) {
  constexpr int ld = wide_ld<T>();
  const int w = kWideHead - hd;
  for (int i = threadIdx.x; i < n_rows * w; i += kWideThreads) {
    const int r = i / w;
    rows[r * ld + hd + (i - r * w)] = zero_of<T>();
  }
}

// A operand of a staged tile: rows r0 .. r0 + 15, head columns k0 .. k0 + 7
// (a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)), split into TF32
template <bool kSplit, typename T>
__device__ __forceinline__ void a_rows(const T* X, int r0, int k0, int g, int t,
                                       uint32_t (&h)[4], uint32_t (&l)[4]) {
  constexpr int ld = wide_ld<T>();
  const T* p = X + (r0 + g) * ld + k0 + t;
  split<kSplit>(to_float(p[0]), h[0], l[0]);
  split<kSplit>(to_float(p[8 * ld]), h[1], l[1]);
  split<kSplit>(to_float(p[4]), h[2], l[2]);
  split<kSplit>(to_float(p[8 * ld + 4]), h[3], l[3]);
}

// one warp's 16 x 8 accumulator tile to shared memory and back, lane by lane
__device__ __forceinline__ void put_frag(float* X, const float (&c)[4], int lane) {
#pragma unroll
  for (int e = 0; e < 4; ++e) X[e * 32 + lane] = c[e];
}

__device__ __forceinline__ void get_frag(const float* X, float (&c)[4], int lane) {
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = X[e * 32 + lane];
}

template <typename T>
constexpr size_t wide_fwd_bytes() {
  return sizeof(T) * (size_t)(kWideRows + 4 * kFwdKeys) * wide_ld<T>();
}

template <typename T>
constexpr size_t wide_dq_bytes() {
  return sizeof(T) * (size_t)(2 * kWideRows + 4 * kBwdRows) * wide_ld<T>() +
         sizeof(float) * 32 * kFrag;
}

template <typename T>
constexpr size_t wide_dkdv_bytes() {
  return sizeof(T) * (size_t)(2 * kWideRows + 4 * kBwdRows) * wide_ld<T>() +
         sizeof(float) * (4 * kBwdRows + 32 * kFrag);
}

// the forward's merge of the second warpgroup's state (16 x 256 outputs per
// warp, then m and l per lane) must fit where its K and V tiles were
static_assert(sizeof(float) * (4 * (kWideHead / 8) * kFrag + 4 * kFrag) <=
                  sizeof(__nv_bfloat16) * 4 * kFwdKeys * wide_ld<__nv_bfloat16>(),
              "the forward's merge does not fit its K and V tiles");
static_assert(wide_fwd_bytes<float>() <= 232448 && wide_dq_bytes<float>() <= 232448 &&
                  wide_dkdv_bytes<float>() <= 232448,
              "a one-pass wide kernel exceeds a block's shared memory");

// Forward, heads of 129 to 256 columns: grid (B * H, query tiles of 64).
// shared memory: the block's Q rows, then K and V tiles of kFwdKeys keys,
// two stages each
template <typename T, bool kLse>
__global__ void __launch_bounds__(kWideThreads, 1)
attention_wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                          int S, int H, int hd, float scale_log2e) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int ld = wide_ld<T>(), kSteps = kWideHead / 8, kTileElems = kFwdKeys * ld;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [kWideRows][ld]
  T* Ks = Qs + kWideRows * ld;              // [2][kFwdKeys][ld]
  T* Vs = Ks + 2 * kTileElems;              // [2][kFwdKeys][ld]

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int D = H * hd;
  const size_t base = (size_t)b * S * D + (size_t)h * hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp >> 2, slab = warp & 3;   // warpgroup, and the warp's 16 rows in it
  const int r0 = slab * 16, row0 = blockIdx.y * kWideRows + r0;
  const int n_tiles = (S + kFwdKeys - 1) / kFwdKeys, n_steps = (hd + 7) / 8;

  zero_head_pad(Qs, kWideRows + 4 * kFwdKeys, hd);
  stage_rows(Qs, ld, q, base, blockIdx.y * kWideRows, kWideRows, S, D, hd);
  stage_rows(Ks, ld, k, base, 0, kFwdKeys, S, D, hd);
  stage_rows(Vs, ld, v, base, 0, kFwdKeys, S, D, hd);
  cp_async_commit();

  float oacc[kSteps][4];
#pragma unroll
  for (int dt = 0; dt < kSteps; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[dt][e] = 0.0f;
  float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F;   // running row max (log2 units)
  float l_lo = 0.0f, l_hi = 0.0f;                     // this thread's share of the row sums

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();   // this tile has landed; every warp is done with the last one
    if (it + 1 < n_tiles) {   // the next tile loads while this one is multiplied
      const int nb = (it + 1) & 1;
      stage_rows(Ks + nb * kTileElems, ld, k, base, (it + 1) * kFwdKeys, kFwdKeys, S, D, hd);
      stage_rows(Vs + nb * kTileElems, ld, v, base, (it + 1) * kFwdKeys, kFwdKeys, S, D, hd);
    }
    cp_async_commit();
    // this warpgroup's 16 keys of the tile; the second may have none in the last
    const T* Kt = Ks + (it & 1) * kTileElems + grp * 16 * ld;
    const T* Vt = Vs + (it & 1) * kTileElems + grp * 16 * ld;
    const int keys_left = S - it * kFwdKeys - grp * 16;
    if (keys_left > 0) {
      float s[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll 4
      for (int ks = 0; ks < n_steps; ++ks) {
        uint32_t ah[4], al[4];
        a_rows<kSplit>(Qs, r0, ks * 8, g, t, ah, al);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          uint32_t bfh[2], bfl[2];
          b_rows<kSplit>(Kt, ld, nt * 8, ks * 8, g, t, bfh, bfl);
          mma3<kSplit>(s[nt], ah, al, bfh, bfl);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] *= scale_log2e;   // log2 units, any sign of scale
      softmax_step<kSteps, 2>(s, keys_left, t, m_lo, m_hi, l_lo, l_hi, oacc);
      // O += P V, 8 keys per k-step, P straight from the accumulators
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        uint32_t ph[4], pl[4];
        acc_as_a<kSplit>(s[kt], ph, pl);
#pragma unroll
        for (int dt = 0; dt < kSteps; ++dt) {
          uint32_t bfh[2], bfl[2];
          b_cols<kSplit>(Vt, ld, kt * 8, dt * 8, g, t, bfh, bfl);
          mma3<kSplit>(oacc[dt], ph, pl, bfh, bfl);
        }
      }
    }
  }

  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  __syncthreads();   // every warp is done with the last tile
  // the second warpgroup's state into the first's, where the tiles were:
  // its outputs [slab][dt][fragment], then m and l [slab][fragment]. A
  // warpgroup that saw no key (S <= 16) has m = -inf, l = 0, o = 0: weight 0
  float* Ox = reinterpret_cast<float*>(Ks);
  float* Mx = Ox + 4 * kSteps * kFrag;
  if (grp == 1) {
#pragma unroll
    for (int dt = 0; dt < kSteps; ++dt) put_frag(Ox + (slab * kSteps + dt) * kFrag, oacc[dt], lane);
    const float st[4] = {m_lo, m_hi, l_lo, l_hi};
    put_frag(Mx + slab * kFrag, st, lane);
  }
  __syncthreads();
  if (grp == 1) return;
  float other[4];
  get_frag(Mx + slab * kFrag, other, lane);
  const float n_lo = fmaxf(m_lo, other[0]), n_hi = fmaxf(m_hi, other[1]);
  const float a_lo = fast_exp2(m_lo - n_lo), a_hi = fast_exp2(m_hi - n_hi);
  const float b_lo = fast_exp2(other[0] - n_lo), b_hi = fast_exp2(other[1] - n_hi);
  l_lo = l_lo * a_lo + other[2] * b_lo;
  l_hi = l_hi * a_hi + other[3] * b_hi;
  const float i_lo = 1.0f / l_lo, i_hi = 1.0f / l_hi;
  const int r_lo = row0 + g, r_hi = r_lo + 8;
#pragma unroll
  for (int dt = 0; dt < kSteps; ++dt) {
    float x[4];
    get_frag(Ox + (slab * kSteps + dt) * kFrag, x, lane);
    const int col = dt * 8 + 2 * t;
    if (r_lo < S)
      store_pair(o + base + (size_t)r_lo * D, col, hd, (oacc[dt][0] * a_lo + x[0] * b_lo) * i_lo,
                 (oacc[dt][1] * a_lo + x[1] * b_lo) * i_lo);
    if (r_hi < S)
      store_pair(o + base + (size_t)r_hi * D, col, hd, (oacc[dt][2] * a_hi + x[2] * b_hi) * i_hi,
                 (oacc[dt][3] * a_hi + x[3] * b_hi) * i_hi);
  }
  if constexpr (kLse) {
    if (t == 0) {
      float* row_lse = lse + (size_t)bh * S;
      if (r_lo < S) row_lse[r_lo] = (n_lo + log2f(l_lo)) * kLn2;
      if (r_hi < S) row_lse[r_hi] = (n_hi + log2f(l_hi)) * kLn2;
    }
  }
}

// The logits (and dP) of 16 own rows against the 16 rows of a streamed
// tile, over this warp's half of the head (columns c0 .. c0 + 127), then
// summed with the partner warp's half through shared memory (X: [slab][half]
// [4][kFrag]): both warps of a pair end with the same bits, since each adds
// the same two partial sums (IEEE addition is commutative). A operands from
// the block's own staged rows (A1 for s, A2 for d), B from the tile's (B1,
// B2); 8-column steps of the half that hold no real column are skipped.
// half_logits takes the products alone (the cluster kernels exchange them
// across the cluster instead).
template <bool kSplit, typename T>
__device__ __forceinline__ void half_logits(const T* A1, const T* A2, const T* B1, const T* B2,
                                            int r0, int c0, int hd, int g, int t,
                                            float (&s)[2][4], float (&d)[2][4]) {
  constexpr int ld = wide_ld<T>();
  const int n_steps = min((hd - c0 + 7) / 8, kWideHead / 16);
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = d[nt][e] = 0.0f;
#pragma unroll 2
  for (int ks = 0; ks < n_steps; ++ks) {
    const int col = c0 + ks * 8;
    uint32_t ah[4], al[4], gh[4], gl[4];
    a_rows<kSplit>(A1, r0, col, g, t, ah, al);
    a_rows<kSplit>(A2, r0, col, g, t, gh, gl);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      uint32_t bfh[2], bfl[2];
      b_rows<kSplit>(B1, ld, nt * 8, col, g, t, bfh, bfl);
      mma3<kSplit>(s[nt], ah, al, bfh, bfl);
      b_rows<kSplit>(B2, ld, nt * 8, col, g, t, bfh, bfl);
      mma3<kSplit>(d[nt], gh, gl, bfh, bfl);
    }
  }
}

template <bool kSplit, typename T>
__device__ __forceinline__ void pair_logits(const T* A1, const T* A2, const T* B1, const T* B2,
                                            int r0, int c0, int hd, float* X, int slab, int half,
                                            int g, int t, int lane, float (&s)[2][4],
                                            float (&d)[2][4]) {
  half_logits<kSplit>(A1, A2, B1, B2, r0, c0, hd, g, t, s, d);
  float* mine = X + (slab * 2 + half) * 4 * kFrag;
  const float* other = X + (slab * 2 + (half ^ 1)) * 4 * kFrag;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    put_frag(mine + nt * kFrag, s[nt], lane);
    put_frag(mine + (2 + nt) * kFrag, d[nt], lane);
  }
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    float x[4], y[4];
    get_frag(other + nt * kFrag, x, lane);
    get_frag(other + (2 + nt) * kFrag, y, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] += x[e];
      d[nt][e] += y[e];
    }
  }
}

// Backward, heads of 129 to 256 columns, first kernel: delta and dQ for 64
// query rows; grid (B * H, query tiles). shared memory: the block's Q and dO
// rows, K and V tiles of kBwdRows keys (two stages each), then the pairs'
// partial logits [slab][half][S 0-7, S 8-15, dP 0-7, dP 8-15][fragment]
template <typename T>
__global__ void __launch_bounds__(kWideThreads, 1)
attention_wide_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ o,
                             const T* __restrict__ dout, const float* __restrict__ lse,
                             float* __restrict__ delta, T* __restrict__ dq, int S, int H, int hd,
                             float scale, float scale_log2e) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int ld = wide_ld<T>(), kHalfSteps = kWideHead / 16, kTileElems = kBwdRows * ld;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [kWideRows][ld]
  T* Gs = Qs + kWideRows * ld;              // dO, [kWideRows][ld]
  T* Ks = Gs + kWideRows * ld;              // [2][kBwdRows][ld]
  T* Vs = Ks + 2 * kTileElems;              // [2][kBwdRows][ld]
  float* Xs = reinterpret_cast<float*>(Vs + 2 * kTileElems);   // [4][2][4][kFrag]

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int D = H * hd;
  const size_t base = (size_t)b * S * D + (size_t)h * hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int slab = warp & 3, half = warp >> 2;   // 16 rows; half of the head's columns
  const int r0 = slab * 16, row0 = blockIdx.y * kWideRows + r0, c0 = half * (kWideHead / 2);
  const int n_tiles = (S + kBwdRows - 1) / kBwdRows;

  zero_head_pad(Qs, 2 * kWideRows + 4 * kBwdRows, hd);
  stage_rows(Qs, ld, q, base, blockIdx.y * kWideRows, kWideRows, S, D, hd);
  stage_rows(Gs, ld, dout, base, blockIdx.y * kWideRows, kWideRows, S, D, hd);
  cp_async_commit();
  stage_rows(Ks, ld, k, base, 0, kBwdRows, S, D, hd);
  stage_rows(Vs, ld, v, base, 0, kBwdRows, S, D, hd);
  cp_async_commit();
  cp_async_wait<1>();   // Q and dO have landed; the first K and V tiles may not have
  __syncthreads();

  // delta = rowsum(dO o) over the whole head, in the narrow kernel's order
  const int r_lo = row0 + g, r_hi = r_lo + 8;
  float del_lo = 0.0f, del_hi = 0.0f;
  for (int col = 0; col < hd; col += 8) {
    const T* y = Gs + (r0 + g) * ld + col + t;
    float z[4];
    a_values(o, base, row0, col, S, D, hd, g, t, z);
    del_lo = fmaf(to_float(y[0]), z[0], fmaf(to_float(y[4]), z[2], del_lo));
    del_hi = fmaf(to_float(y[8 * ld]), z[1], fmaf(to_float(y[8 * ld + 4]), z[3], del_hi));
  }
  del_lo += __shfl_xor_sync(0xffffffffu, del_lo, 1);
  del_lo += __shfl_xor_sync(0xffffffffu, del_lo, 2);
  del_hi += __shfl_xor_sync(0xffffffffu, del_hi, 1);
  del_hi += __shfl_xor_sync(0xffffffffu, del_hi, 2);
  const float* row_lse = lse + (size_t)bh * S;
  const float L_lo = r_lo < S ? row_lse[r_lo] * kLog2e : 0.0f;
  const float L_hi = r_hi < S ? row_lse[r_hi] * kLog2e : 0.0f;
  if (t == 0 && half == 0) {
    if (r_lo < S) delta[(size_t)bh * S + r_lo] = del_lo;
    if (r_hi < S) delta[(size_t)bh * S + r_hi] = del_hi;
  }

  float dacc[kHalfSteps][4];
#pragma unroll
  for (int dt = 0; dt < kHalfSteps; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dacc[dt][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();   // this tile has landed; every warp is done with the last one
    if (it + 1 < n_tiles) {   // the next tile loads while this one is multiplied
      const int nb = (it + 1) & 1;
      stage_rows(Ks + nb * kTileElems, ld, k, base, (it + 1) * kBwdRows, kBwdRows, S, D, hd);
      stage_rows(Vs + nb * kTileElems, ld, v, base, (it + 1) * kBwdRows, kBwdRows, S, D, hd);
    }
    cp_async_commit();
    const T* Kt = Ks + (it & 1) * kTileElems;
    const T* Vt = Vs + (it & 1) * kTileElems;
    const int keys_left = S - it * kBwdRows;

    // S and dP of the warp's 16 rows and the tile's 16 keys, whole head
    float s[2][4], dp[2][4];
    pair_logits<kSplit>(Qs, Gs, Kt, Vt, r0, c0, hd, Xs, slab, half, g, t, lane, s, dp);
    // dS in place of S; keys past the end: zero rows of K and V, P set to 0
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float p[4];
      p[0] = fast_exp2(fmaf(s[nt][0], scale_log2e, -L_lo));
      p[1] = fast_exp2(fmaf(s[nt][1], scale_log2e, -L_lo));
      p[2] = fast_exp2(fmaf(s[nt][2], scale_log2e, -L_hi));
      p[3] = fast_exp2(fmaf(s[nt][3], scale_log2e, -L_hi));
      const int key = nt * 8 + 2 * t;
      if (key >= keys_left) p[0] = p[2] = 0.0f;
      if (key + 1 >= keys_left) p[1] = p[3] = 0.0f;
      s[nt][0] = p[0] * (dp[nt][0] - del_lo);
      s[nt][1] = p[1] * (dp[nt][1] - del_lo);
      s[nt][2] = p[2] * (dp[nt][2] - del_hi);
      s[nt][3] = p[3] * (dp[nt][3] - del_hi);
    }
    // dQ[16 rows, this half's 128 columns] += dS (16 rows x 16 keys) K
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
      uint32_t ah[4], al[4];
      acc_as_a<kSplit>(s[kt], ah, al);
#pragma unroll
      for (int dt = 0; dt < kHalfSteps; ++dt) {
        uint32_t bfh[2], bfl[2];
        b_cols<kSplit>(Kt, ld, kt * 8, c0 + dt * 8, g, t, bfh, bfl);
        mma3<kSplit>(dacc[dt], ah, al, bfh, bfl);
      }
    }
  }

#pragma unroll
  for (int dt = 0; dt < kHalfSteps; ++dt) {
    const int col = c0 + dt * 8 + 2 * t;
    if (r_lo < S)
      store_pair(dq + base + (size_t)r_lo * D, col, hd, dacc[dt][0] * scale, dacc[dt][1] * scale);
    if (r_hi < S)
      store_pair(dq + base + (size_t)r_hi * D, col, hd, dacc[dt][2] * scale, dacc[dt][3] * scale);
  }
}

// Backward, heads of 129 to 256 columns, second kernel: dK and dV for 64
// keys, after the first has written delta; grid (B * H, key tiles). shared
// memory: the block's K and V rows, Q and dO tiles of kBwdRows queries and
// their L and delta (two stages each), then the pairs' partial logits
// [slab][half][S^T 0-7, S^T 8-15, dP^T 0-7, dP^T 8-15][fragment]
template <typename T>
__global__ void __launch_bounds__(kWideThreads, 1)
attention_wide_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               T* __restrict__ dk, T* __restrict__ dv, int S, int H, int hd,
                               float scale, float scale_log2e) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int ld = wide_ld<T>(), kHalfSteps = kWideHead / 16, kTileElems = kBwdRows * ld;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);   // [kWideRows][ld]
  T* Vs = Ks + kWideRows * ld;              // [kWideRows][ld]
  T* Qs = Vs + kWideRows * ld;              // [2][kBwdRows][ld]
  T* Gs = Qs + 2 * kTileElems;              // dO, [2][kBwdRows][ld]
  float* Ls = reinterpret_cast<float*>(Gs + 2 * kTileElems);   // [2][kBwdRows]
  float* Ds = Ls + 2 * kBwdRows;                               // [2][kBwdRows]
  float* Xs = Ds + 2 * kBwdRows;                               // [4][2][4][kFrag]

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int D = H * hd;
  const size_t base = (size_t)b * S * D + (size_t)h * hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int slab = warp & 3, half = warp >> 2;   // 16 keys; half of the head's columns
  const int r0 = slab * 16, key0 = blockIdx.y * kWideRows + r0, c0 = half * (kWideHead / 2);
  const int n_tiles = (S + kBwdRows - 1) / kBwdRows;
  const float* row_lse = lse + (size_t)bh * S;
  const float* row_delta = delta + (size_t)bh * S;

  zero_head_pad(Ks, 2 * kWideRows + 4 * kBwdRows, hd);
  stage_rows(Ks, ld, k, base, blockIdx.y * kWideRows, kWideRows, S, D, hd);
  stage_rows(Vs, ld, v, base, blockIdx.y * kWideRows, kWideRows, S, D, hd);
  stage_rows(Qs, ld, q, base, 0, kBwdRows, S, D, hd);
  stage_rows(Gs, ld, dout, base, 0, kBwdRows, S, D, hd);
  stage_entries(Ls, row_lse, 0, kBwdRows, S);
  stage_entries(Ds, row_delta, 0, kBwdRows, S);
  cp_async_commit();

  float kacc[kHalfSteps][4], vacc[kHalfSteps][4];
#pragma unroll
  for (int dt = 0; dt < kHalfSteps; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) kacc[dt][e] = vacc[dt][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();   // this tile has landed; every warp is done with the last one
    if (it + 1 < n_tiles) {   // the next tile loads while this one is multiplied
      const int nb = (it + 1) & 1, next = (it + 1) * kBwdRows;
      stage_rows(Qs + nb * kTileElems, ld, q, base, next, kBwdRows, S, D, hd);
      stage_rows(Gs + nb * kTileElems, ld, dout, base, next, kBwdRows, S, D, hd);
      stage_entries(Ls + nb * kBwdRows, row_lse, next, kBwdRows, S);
      stage_entries(Ds + nb * kBwdRows, row_delta, next, kBwdRows, S);
    }
    cp_async_commit();
    const T* Qt = Qs + (it & 1) * kTileElems;
    const T* Gt = Gs + (it & 1) * kTileElems;
    const float* Lt = Ls + (it & 1) * kBwdRows;
    const float* Dt = Ds + (it & 1) * kBwdRows;

    // S^T and dP^T of the warp's 16 keys and the tile's 16 queries, whole
    // head; then P^T in place of S^T and dS^T in place of dP^T. Queries past
    // S are zero rows with L = delta = 0: P = 1 there, and dO = 0 and dS = 0
    // keep them out of both sums.
    float st[2][4], dpt[2][4];
    pair_logits<kSplit>(Ks, Vs, Qt, Gt, r0, c0, hd, Xs, slab, half, g, t, lane, st, dpt);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int qa = nt * 8 + 2 * t;   // this lane's two queries: columns 0/2 and 1/3
      const float L0 = Lt[qa] * kLog2e, L1 = Lt[qa + 1] * kLog2e;
      const float d0 = Dt[qa], d1 = Dt[qa + 1];
      st[nt][0] = fast_exp2(fmaf(st[nt][0], scale_log2e, -L0));
      st[nt][1] = fast_exp2(fmaf(st[nt][1], scale_log2e, -L1));
      st[nt][2] = fast_exp2(fmaf(st[nt][2], scale_log2e, -L0));
      st[nt][3] = fast_exp2(fmaf(st[nt][3], scale_log2e, -L1));
      dpt[nt][0] = st[nt][0] * (dpt[nt][0] - d0);
      dpt[nt][1] = st[nt][1] * (dpt[nt][1] - d1);
      dpt[nt][2] = st[nt][2] * (dpt[nt][2] - d0);
      dpt[nt][3] = st[nt][3] * (dpt[nt][3] - d1);
    }
    // dV += P^T dO, dK += dS^T Q over the tile's 16 queries, this half's columns
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      acc_as_a<kSplit>(st[kt], ph, pl);
      acc_as_a<kSplit>(dpt[kt], sh, sl);
#pragma unroll
      for (int dt = 0; dt < kHalfSteps; ++dt) {
        uint32_t bfh[2], bfl[2];
        b_cols<kSplit>(Gt, ld, kt * 8, c0 + dt * 8, g, t, bfh, bfl);
        mma3<kSplit>(vacc[dt], ph, pl, bfh, bfl);
        b_cols<kSplit>(Qt, ld, kt * 8, c0 + dt * 8, g, t, bfh, bfl);
        mma3<kSplit>(kacc[dt], sh, sl, bfh, bfl);
      }
    }
  }

  const int r_lo = key0 + g, r_hi = r_lo + 8;
#pragma unroll
  for (int dt = 0; dt < kHalfSteps; ++dt) {
    const int col = c0 + dt * 8 + 2 * t;
    if (r_lo < S) {
      store_pair(dk + base + (size_t)r_lo * D, col, hd, kacc[dt][0] * scale, kacc[dt][1] * scale);
      store_pair(dv + base + (size_t)r_lo * D, col, hd, vacc[dt][0], vacc[dt][1]);
    }
    if (r_hi < S) {
      store_pair(dk + base + (size_t)r_hi * D, col, hd, kacc[dt][2] * scale, kacc[dt][3] * scale);
      store_pair(dv + base + (size_t)r_hi * D, col, hd, vacc[dt][2], vacc[dt][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Heads above 2,048 columns: the same TF32 products over head slices
// ---------------------------------------------------------------------------
//
// A head wider than kClusterHead columns fits neither the narrow kernels
// (their register-resident fragments cover the whole head), the one-pass
// wide kernels (their staged tiles do) nor the portable clusters of the
// cluster kernels (8 blocks of 256 columns; attention_fwd_launch's and
// attention_bwd_launch's kernel 2 still runs these kernels at any head above
// 128, to compare them on the same tensors). These kernels walk the
// head in slices of kSlice columns. Dot products over the head (Q K^T,
// dO V^T) accumulate slice by slice, the register-side operand read from
// device memory (L1/L2) one 8-column step at a time and the tile-side
// operand staged one slice at a time; each block owns one kSlice-column
// slice of the output (blockIdx.z), so the logits are recomputed once per
// output slice. Nothing is sized by the head or by S: any head size runs.
// Simple and right first: one stage per tile, no overlap of copy and
// products.

constexpr int kSlice = 128;

// Rows row0 .. row0 + kTile - 1 and head columns col0 .. col0 + kSlice - 1 of
// one head of a packed (B, S, D) tensor into a staged tile of kSlice + 4
// floats a row; rows past S and columns past hd are zero
template <typename T>
__device__ __forceinline__ void stage_slice(float* dst, const T* __restrict__ src, size_t base,
                                            int row0, int col0, int S, int D, int hd) {
  constexpr int ld = tile_ld<kSlice>();
  if constexpr (std::is_same<T, float>::value) {
    if ((hd & 3) == 0) {
      constexpr int per_row = kSlice / 4;
      for (int i = threadIdx.x; i < kTile * per_row; i += kThreads) {
        const int r = i / per_row, c = (i - r * per_row) * 4, row = row0 + r, col = col0 + c;
        cp_async16(dst + r * ld + c, src + base + (size_t)min(row, S - 1) * D + min(col, hd - 4),
                   row < S && col < hd ? 16 : 0);
      }
      return;
    }
    for (int i = threadIdx.x; i < kTile * kSlice; i += kThreads) {
      const int r = i / kSlice, c = i - r * kSlice, row = row0 + r, col = col0 + c;
      cp_async4(dst + r * ld + c, src + base + (size_t)min(row, S - 1) * D + min(col, hd - 1),
                row < S && col < hd ? 4 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kTile * kSlice; i += kThreads) {
      const int r = i / kSlice, c = i - r * kSlice, row = row0 + r, col = col0 + c;
      dst[r * ld + c] = row < S && col < hd ? to_float(src[base + (size_t)row * D + col]) : 0.0f;
    }
  }
}

// the staged slice is complete and visible to every thread
__device__ __forceinline__ void slice_ready() {
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// acc += A[row0 .., head] X[n0 .., head]^T for 8 column tiles n0 = 0, 8, ..
// of the staged tiles: the slice sl of the head, A from device memory
template <bool kSplit, typename T>
__device__ __forceinline__ void slice_dots(float (&acc)[kTile / 8][4], const T* __restrict__ a,
                                           const float* X, size_t base, int row0, int col0,
                                           int S, int D, int hd, int g, int t) {
  constexpr int ld = tile_ld<kSlice>();
#pragma unroll 4
  for (int ks = 0; ks < kSlice / 8; ++ks) {
    float x[4];
    uint32_t ah[4], al[4];
    a_values(a, base, row0, col0 + ks * 8, S, D, hd, g, t, x);
    split4<kSplit>(x, ah, al);
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      uint32_t bfh[2], bfl[2];
      b_rows<kSplit>(X, ld, nt * 8, ks * 8, g, t, bfh, bfl);
      mma3<kSplit>(acc[nt], ah, al, bfh, bfl);
    }
  }
}

// acc += P X for the 8-key tiles of P (accumulator layout) and the staged
// slice X (rows in the order of acc_as_a)
template <bool kSplit>
__device__ __forceinline__ void slice_pv(float (&acc)[kSlice / 8][4],
                                         const float (&p)[kTile / 8][4], const float* X, int g,
                                         int t) {
  constexpr int ld = tile_ld<kSlice>();
#pragma unroll
  for (int kt = 0; kt < kTile / 8; ++kt) {   // unrolled: p stays in registers
    uint32_t ph[4], pl[4];
    acc_as_a<kSplit>(p[kt], ph, pl);
#pragma unroll
    for (int dt = 0; dt < kSlice / 8; ++dt) {
      uint32_t bfh[2], bfl[2];
      b_cols<kSplit>(X, ld, kt * 8, dt * 8, g, t, bfh, bfl);
      mma3<kSplit>(acc[dt], ph, pl, bfh, bfl);
    }
  }
}

// rows r_lo and r_hi of an output slice: acc times f, from head column col0
template <typename T>
__device__ __forceinline__ void store_slice(T* __restrict__ out, size_t base, int r_lo, int col0,
                                            int S, int D, int hd, int t,
                                            const float (&acc)[kSlice / 8][4], float f) {
#pragma unroll
  for (int dt = 0; dt < kSlice / 8; ++dt) {
    const int col = col0 + dt * 8 + 2 * t;
    if (r_lo < S) store_pair(out + base + (size_t)r_lo * D, col, hd, acc[dt][0] * f, acc[dt][1] * f);
    if (r_lo + 8 < S)
      store_pair(out + base + (size_t)(r_lo + 8) * D, col, hd, acc[dt][2] * f, acc[dt][3] * f);
  }
}

// Forward, heads above 2,048: grid (B * H, query tiles, output slices). shared
// memory: one K slice and one V slice of a key tile
template <typename T, bool kLse>
__global__ void __launch_bounds__(kThreads)
attention_sliced_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                          int S, int H, int hd, float scale_log2e) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int kSteps = kSlice / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);   // [kTile][tile_ld<kSlice>]
  float* Vs = Ks + tile_floats<kSlice>();

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int D = H * hd;
  const size_t base = (size_t)b * S * D + (size_t)h * hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * kTile + warp * 16, out0 = blockIdx.z * kSlice;
  const int n_tiles = (S + kTile - 1) / kTile, n_slices = (hd + kSlice - 1) / kSlice;

  float oacc[kSteps][4];
#pragma unroll
  for (int dt = 0; dt < kSteps; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[dt][e] = 0.0f;
  float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F, l_lo = 0.0f, l_hi = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    float s[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
    for (int sl = 0; sl < n_slices; ++sl) {
      __syncthreads();   // the previous slice is consumed
      stage_slice<T>(Ks, k, base, it * kTile, sl * kSlice, S, D, hd);
      if (sl == n_slices - 1) stage_slice<T>(Vs, v, base, it * kTile, out0, S, D, hd);
      slice_ready();
      slice_dots<kSplit>(s, q, Ks, base, row0, sl * kSlice, S, D, hd, g, t);
    }
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= scale_log2e;
    softmax_step<kSteps>(s, S - it * kTile, t, m_lo, m_hi, l_lo, l_hi, oacc);
    slice_pv<kSplit>(oacc, s, Vs, g, t);
  }

  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const int r_lo = row0 + g, r_hi = r_lo + 8;
  const float i_lo = 1.0f / l_lo, i_hi = 1.0f / l_hi;
#pragma unroll
  for (int dt = 0; dt < kSteps; ++dt) {
    oacc[dt][0] *= i_lo;
    oacc[dt][1] *= i_lo;
    oacc[dt][2] *= i_hi;
    oacc[dt][3] *= i_hi;
  }
  store_slice(o, base, r_lo, out0, S, D, hd, t, oacc, 1.0f);
  if constexpr (kLse) {
    if (t == 0 && blockIdx.z == 0) {
      float* row_lse = lse + (size_t)bh * S;
      if (r_lo < S) row_lse[r_lo] = (m_lo + log2f(l_lo)) * kLn2;
      if (r_hi < S) row_lse[r_hi] = (m_hi + log2f(l_hi)) * kLn2;
    }
  }
}

// Backward, heads above 2,048, first kernel: delta and one output slice of dQ for
// kTile query rows; grid (B * H, query tiles, output slices). shared
// memory: one K slice and one V slice of a key tile
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_sliced_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ o,
                             const T* __restrict__ dout, const float* __restrict__ lse,
                             float* __restrict__ delta, T* __restrict__ dq, int S, int H, int hd,
                             float scale, float scale_log2e) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + tile_floats<kSlice>();

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int D = H * hd;
  const size_t base = (size_t)b * S * D + (size_t)h * hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * kTile + warp * 16, out0 = blockIdx.z * kSlice;
  const int n_tiles = (S + kTile - 1) / kTile, n_slices = (hd + kSlice - 1) / kSlice;

  // delta = rowsum(dO o) over the whole head, in the narrow kernel's order
  float del_lo = 0.0f, del_hi = 0.0f;
  for (int c0 = 0; c0 < hd; c0 += 8) {
    float y[4], z[4];
    a_values(dout, base, row0, c0, S, D, hd, g, t, y);
    a_values(o, base, row0, c0, S, D, hd, g, t, z);
    del_lo = fmaf(y[0], z[0], fmaf(y[2], z[2], del_lo));
    del_hi = fmaf(y[1], z[1], fmaf(y[3], z[3], del_hi));
  }
  del_lo += __shfl_xor_sync(0xffffffffu, del_lo, 1);
  del_lo += __shfl_xor_sync(0xffffffffu, del_lo, 2);
  del_hi += __shfl_xor_sync(0xffffffffu, del_hi, 1);
  del_hi += __shfl_xor_sync(0xffffffffu, del_hi, 2);
  const int r_lo = row0 + g, r_hi = r_lo + 8;
  const float* row_lse = lse + (size_t)bh * S;
  const float L_lo = r_lo < S ? row_lse[r_lo] * kLog2e : 0.0f;
  const float L_hi = r_hi < S ? row_lse[r_hi] * kLog2e : 0.0f;
  if (t == 0 && blockIdx.z == 0) {
    if (r_lo < S) delta[(size_t)bh * S + r_lo] = del_lo;
    if (r_hi < S) delta[(size_t)bh * S + r_hi] = del_hi;
  }

  float dacc[kSlice / 8][4];
#pragma unroll
  for (int dt = 0; dt < kSlice / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dacc[dt][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
    for (int sl = 0; sl < n_slices; ++sl) {
      __syncthreads();
      stage_slice<T>(Ks, k, base, it * kTile, sl * kSlice, S, D, hd);
      stage_slice<T>(Vs, v, base, it * kTile, sl * kSlice, S, D, hd);
      slice_ready();
      slice_dots<kSplit>(s, q, Ks, base, row0, sl * kSlice, S, D, hd, g, t);
      slice_dots<kSplit>(dp, dout, Vs, base, row0, sl * kSlice, S, D, hd, g, t);
    }
    const int keys_left = S - it * kTile;
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      float p[4];
      p[0] = fast_exp2(fmaf(s[nt][0], scale_log2e, -L_lo));
      p[1] = fast_exp2(fmaf(s[nt][1], scale_log2e, -L_lo));
      p[2] = fast_exp2(fmaf(s[nt][2], scale_log2e, -L_hi));
      p[3] = fast_exp2(fmaf(s[nt][3], scale_log2e, -L_hi));
      const int key = nt * 8 + 2 * t;   // keys past the end: P set to 0
      if (key >= keys_left) p[0] = p[2] = 0.0f;
      if (key + 1 >= keys_left) p[1] = p[3] = 0.0f;
      s[nt][0] = p[0] * (dp[nt][0] - del_lo);   // dS in place of the logits
      s[nt][1] = p[1] * (dp[nt][1] - del_lo);
      s[nt][2] = p[2] * (dp[nt][2] - del_hi);
      s[nt][3] = p[3] * (dp[nt][3] - del_hi);
    }
    __syncthreads();
    stage_slice<T>(Ks, k, base, it * kTile, out0, S, D, hd);
    slice_ready();
    slice_pv<kSplit>(dacc, s, Ks, g, t);
  }
  store_slice(dq, base, r_lo, out0, S, D, hd, t, dacc, scale);
}

// Backward, heads above 2,048, second kernel: one output slice of dV (even
// blockIdx.z) or dK (odd) for kTile keys, after the first kernel has written
// delta; grid (B * H, key tiles, 2 x output slices). shared memory: one Q
// slice and one dO slice of a query tile, then L and delta of its queries
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_sliced_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               T* __restrict__ dk, T* __restrict__ dv, int S, int H, int hd,
                               float scale, float scale_log2e) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Gs = Qs + tile_floats<kSlice>();
  float* Ls = Gs + tile_floats<kSlice>();   // [kTile]
  float* Ds = Ls + kTile;                   // [kTile]

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int D = H * hd;
  const size_t base = (size_t)b * S * D + (size_t)h * hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = blockIdx.y * kTile + warp * 16;
  const bool want_dk = blockIdx.z & 1;
  const int out0 = (blockIdx.z >> 1) * kSlice;
  const int n_tiles = (S + kTile - 1) / kTile, n_slices = (hd + kSlice - 1) / kSlice;
  const float* row_lse = lse + (size_t)bh * S;
  const float* row_delta = delta + (size_t)bh * S;

  float acc[kSlice / 8][4];
#pragma unroll
  for (int dt = 0; dt < kSlice / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    // S^T = K Q^T and, for dK, dP^T = V dO^T over the head
    float st[kTile / 8][4], dpt[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.0f;
    for (int sl = 0; sl < n_slices; ++sl) {
      __syncthreads();
      stage_slice<T>(Qs, q, base, it * kTile, sl * kSlice, S, D, hd);
      if (want_dk) stage_slice<T>(Gs, dout, base, it * kTile, sl * kSlice, S, D, hd);
      if (sl == 0) {
        stage_vec(Ls, row_lse, it * kTile, S);
        stage_vec(Ds, row_delta, it * kTile, S);
      }
      slice_ready();
      slice_dots<kSplit>(st, k, Qs, base, key0, sl * kSlice, S, D, hd, g, t);
      if (want_dk) slice_dots<kSplit>(dpt, v, Gs, base, key0, sl * kSlice, S, D, hd, g, t);
    }
    // P^T (dV) or dS^T (dK) in place of S^T. Queries past S are zero rows
    // with L = delta = 0: P = 1 there, and dO = 0 and dS = 0 keep them out
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      const int qa = nt * 8 + 2 * t;
      const float L0 = Ls[qa] * kLog2e, L1 = Ls[qa + 1] * kLog2e;
      const float d0 = Ds[qa], d1 = Ds[qa + 1];
      float p[4];
      p[0] = fast_exp2(fmaf(st[nt][0], scale_log2e, -L0));
      p[1] = fast_exp2(fmaf(st[nt][1], scale_log2e, -L1));
      p[2] = fast_exp2(fmaf(st[nt][2], scale_log2e, -L0));
      p[3] = fast_exp2(fmaf(st[nt][3], scale_log2e, -L1));
      if (want_dk) {
        st[nt][0] = p[0] * (dpt[nt][0] - d0);
        st[nt][1] = p[1] * (dpt[nt][1] - d1);
        st[nt][2] = p[2] * (dpt[nt][2] - d0);
        st[nt][3] = p[3] * (dpt[nt][3] - d1);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] = p[e];
      }
    }
    // dV += P^T dO, dK += dS^T Q: the output slice of dO or Q
    __syncthreads();
    stage_slice<T>(Qs, want_dk ? q : dout, base, it * kTile, out0, S, D, hd);
    slice_ready();
    slice_pv<kSplit>(acc, st, Qs, g, t);
  }
  if (want_dk) store_slice(dk, base, key0 + g, out0, S, D, hd, t, acc, scale);
  else store_slice(dv, base, key0 + g, out0, S, D, hd, t, acc, 1.0f);
}

// ---------------------------------------------------------------------------
// Heads of 257 to 2,048 columns: thread-block clusters over 256-column slices
// ---------------------------------------------------------------------------
//
// The same TPU kernels (attention_pallas.py:153 forward, :169 backward; they
// take any head size) above the one-pass wide kernels' 256 columns. Bound at
// (B=64, S=225, D=512, H=1) f32, by operations as 3xTF32: 0.040 ms forward,
// 0.101 ms backward (bytes 0.035 / 0.062 ms).
//
// A head of hd columns runs on a cluster of n = ceil(hd / 256) blocks (2 to
// 8, the portable cluster size) per (batch row, head, 64 rows), placed by
// the hardware on neighbouring SMs. Block rank c owns head columns [256c,
// 256c + 256) and is a one-pass wide block on that slice: it stages its slice
// of its own 64 rows once, streams its slice of each K/V (or Q/dO) tile in
// two cp.async stages, and writes its own slice of the output. The logits
// need the whole head: each block contracts its own columns into a partial
// tile (Q K^T in the forward; S and dP in dQ; S^T and dP^T in dK/dV), writes
// it to an exchange buffer in its shared memory and, after a cluster
// barrier, reads every rank's partial through distributed shared memory
// (map_shared_rank) and sums them in rank order 0..n-1. So every block holds
// the same bits of the logits, hence the same row max, l, L and P, and runs
// its online softmax and its own P V, dQ, dK or dV slice alone. delta =
// rowsum(dO o) is exchanged the same way once, at the start of the dQ
// kernel. Rank 0 alone writes L and delta; no float atomic, so two calls on
// the same inputs give the same bits.
// What this does about the three limits of the sliced kernels (below, which
// ran these heads before):
//  * each logit product is taken once per cluster, where the sliced kernels
//    took Q K^T (and dO V^T) once per 128-column output slice, 4 times at
//    head 512, and S^T and dP^T once per dV or dK slice, 8 times;
//  * a block's own rows are staged once in shared memory, where the sliced
//    kernels read the register-side operand from device memory 8 columns at
//    a time inside the key loop;
//  * tiles stream in two stages behind one block barrier per tile, where the
//    sliced kernels staged one slice at a time between two barriers, with 4
//    warps a block; a cluster block has 8.
// The exchange buffer: the forward adds 64 x 32 f32 (8 KB, one 16 x 16
// partial a warp) to the wide forward's shared memory; the backward kernels
// use the wide kernels' pair buffer (16 KB: the partials of both 128-column
// halves of each 16-row slab), which every rank now reads, adding each
// rank's two halves (h0 + h1, the sum the wide kernels' pairs take) before
// adding across ranks. One buffer each: a second would not fit the dK/dV
// kernel (216,320 + 16,384 > 232,448 bytes). So each tile passes two cluster
// barriers: one after the writes, and one after the reads, split into an
// arrive right after them and a wait just before the next tile's writes, so
// that the tile's softmax and products run in between. Dynamic shared
// memory, f32: 207,872 / 216,064 / 216,320 bytes (forward, dQ, dK/dV), bf16
// 109,568 / 117,760 / 118,016; one block per SM. The launcher asks
// cudaOccupancyMaxActiveClusters whether the card can place one cluster of
// the kernel before each launch and returns an error where it cannot. At
// (64, 225, 512, 1) each grid is 256 clusters of 2, 3.9 waves of the 66
// that an H100 holds. Heads above 2,048 columns (a cluster above 8 blocks,
// which the card allows only as a non-portable size) keep the sliced
// kernels.

constexpr int kClusterHead = 2048;                  // the widest head the cluster kernels take
constexpr int kMaxRanks = kClusterHead / kWideHead; // 8: the largest portable cluster

// the cluster barrier in two halves: arrive (release) and wait (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// this block's rank in its cluster, and the cluster's size in blocks
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int cluster_blocks() {
  uint32_t n;
  asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return static_cast<int>(n);
}

// one warp's 16 x 8 accumulator tile as one float4 a lane, in an exchange slot
__device__ __forceinline__ void put_frag4(float* X, const float (&c)[4], int lane) {
  reinterpret_cast<float4*>(X)[lane] = make_float4(c[0], c[1], c[2], c[3]);
}

__device__ __forceinline__ float4 get_frag4(const float* X, int lane) {
  return reinterpret_cast<const float4*>(X)[lane];
}

// s[nt] = the sum over ranks 0..n-1, in that order, of the kN 16 x 8 tiles
// that this warp's counterpart in each rank wrote at X (the same offset in
// every block's shared memory)
template <int kN>
__device__ __forceinline__ void cluster_sum(const float* X, int n_ranks, int lane,
                                            float (&s)[kN][4]) {
  cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
  for (int nt = 0; nt < kN; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll 2
  for (int r = 0; r < n_ranks; ++r) {
    const float* R = cluster.map_shared_rank(X, r);
#pragma unroll
    for (int nt = 0; nt < kN; ++nt) {
      const float4 x = get_frag4(R + nt * kFrag, lane);
      s[nt][0] += x.x;
      s[nt][1] += x.y;
      s[nt][2] += x.z;
      s[nt][3] += x.w;
    }
  }
}

// The backward's logits s and d (dP, or dP^T) of one 16-row slab: at X each
// rank holds [half][s 0-7, s 8-15, d 0-7, d 8-15][kFrag], the partials of
// the slab's two warps over their 128 columns; the sum over ranks in order
// of (half 0 + half 1)
__device__ __forceinline__ void cluster_sum_halves(const float* X, int n_ranks, int lane,
                                                   float (&s)[2][4], float (&d)[2][4]) {
  cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = d[nt][e] = 0.0f;
#pragma unroll 2
  for (int r = 0; r < n_ranks; ++r) {
    const float* R = cluster.map_shared_rank(X, r);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float4 a = get_frag4(R + nt * kFrag, lane), b = get_frag4(R + (4 + nt) * kFrag, lane);
      const float4 x = get_frag4(R + (2 + nt) * kFrag, lane);
      const float4 y = get_frag4(R + (6 + nt) * kFrag, lane);
      s[nt][0] += a.x + b.x;
      s[nt][1] += a.y + b.y;
      s[nt][2] += a.z + b.z;
      s[nt][3] += a.w + b.w;
      d[nt][0] += x.x + y.x;
      d[nt][1] += x.y + y.y;
      d[nt][2] += x.z + y.z;
      d[nt][3] += x.w + y.w;
    }
  }
}

template <typename T>
constexpr size_t cluster_fwd_bytes() {
  return wide_fwd_bytes<T>() + sizeof(float) * kWideWarps * 2 * kFrag;
}

static_assert(cluster_fwd_bytes<float>() <= 232448,
              "the cluster forward exceeds a block's shared memory");

// Forward, heads of 257 to 2,048 columns: grid (clusters of n along x: B * H
// * n blocks, query tiles of 64). shared memory: the wide forward's (this
// rank's slice of the block's Q rows, K and V tiles of kFwdKeys keys, two
// stages each), then the exchange slots [warp][key tile half][kFrag]
template <typename T, bool kLse>
__global__ void __launch_bounds__(kWideThreads, 1)
attention_cluster_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                             int S, int H, int hd, float scale_log2e) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int ld = wide_ld<T>(), kSteps = kWideHead / 8, kTileElems = kFwdKeys * ld;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [kWideRows][ld]
  T* Ks = Qs + kWideRows * ld;              // [2][kFwdKeys][ld]
  T* Vs = Ks + 2 * kTileElems;              // [2][kFwdKeys][ld]
  float* Xs = reinterpret_cast<float*>(Vs + 2 * kTileElems);   // [kWideWarps][2][kFrag]

  const int rank = cluster_rank(), n_ranks = cluster_blocks();
  const int bh = blockIdx.x / n_ranks, b = bh / H, h = bh - b * H;
  const int D = H * hd, c0 = rank * kWideHead, hd_c = min(kWideHead, hd - c0);
  const size_t base = (size_t)b * S * D + (size_t)h * hd + c0;   // this rank's slice
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp >> 2, slab = warp & 3;   // warpgroup, and the warp's 16 rows in it
  const int r0 = slab * 16, row0 = blockIdx.y * kWideRows + r0;
  const int n_tiles = (S + kFwdKeys - 1) / kFwdKeys, n_steps = (hd_c + 7) / 8;
  float* mine = Xs + warp * 2 * kFrag;

  zero_head_pad(Qs, kWideRows + 4 * kFwdKeys, hd_c);
  stage_cols(Qs, ld, q, base, blockIdx.y * kWideRows, kWideRows, S, D, hd_c, hd);
  stage_cols(Ks, ld, k, base, 0, kFwdKeys, S, D, hd_c, hd);
  stage_cols(Vs, ld, v, base, 0, kFwdKeys, S, D, hd_c, hd);
  cp_async_commit();

  float oacc[kSteps][4];
#pragma unroll
  for (int dt = 0; dt < kSteps; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[dt][e] = 0.0f;
  float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F;   // running row max (log2 units)
  float l_lo = 0.0f, l_hi = 0.0f;                     // this thread's share of the row sums
  cluster_arrive();   // the first tile's wait also finds every block of the cluster running

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();   // this tile has landed; every warp is done with the last one
    if (it + 1 < n_tiles) {   // the next tile loads while this one is multiplied
      const int nb = (it + 1) & 1;
      stage_cols(Ks + nb * kTileElems, ld, k, base, (it + 1) * kFwdKeys, kFwdKeys, S, D, hd_c, hd);
      stage_cols(Vs + nb * kTileElems, ld, v, base, (it + 1) * kFwdKeys, kFwdKeys, S, D, hd_c, hd);
    }
    cp_async_commit();
    // this warpgroup's 16 keys of the tile; the second may have none in the last
    const T* Kt = Ks + (it & 1) * kTileElems + grp * 16 * ld;
    const T* Vt = Vs + (it & 1) * kTileElems + grp * 16 * ld;
    const int keys_left = S - it * kFwdKeys - grp * 16;
    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
    if (keys_left > 0) {   // the partial logits over this rank's columns
#pragma unroll 4
      for (int ks = 0; ks < n_steps; ++ks) {
        uint32_t ah[4], al[4];
        a_rows<kSplit>(Qs, r0, ks * 8, g, t, ah, al);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          uint32_t bfh[2], bfl[2];
          b_rows<kSplit>(Kt, ld, nt * 8, ks * 8, g, t, bfh, bfl);
          mma3<kSplit>(s[nt], ah, al, bfh, bfl);
        }
      }
    }
    cluster_wait();    // every rank has read the last tile's partials
    put_frag4(mine, s[0], lane);
    put_frag4(mine + kFrag, s[1], lane);
    cluster_arrive();
    cluster_wait();    // every rank's partials of this tile are written
    cluster_sum<2>(mine, n_ranks, lane, s);
    cluster_arrive();  // done reading: the next tile's writes wait for every rank's
    if (keys_left > 0) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] *= scale_log2e;   // log2 units, any sign of scale
      softmax_step<kSteps, 2>(s, keys_left, t, m_lo, m_hi, l_lo, l_hi, oacc);
      // O += P V over this rank's columns, P straight from the accumulators
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        uint32_t ph[4], pl[4];
        acc_as_a<kSplit>(s[kt], ph, pl);
#pragma unroll
        for (int dt = 0; dt < kSteps; ++dt) {
          uint32_t bfh[2], bfl[2];
          b_cols<kSplit>(Vt, ld, kt * 8, dt * 8, g, t, bfh, bfl);
          mma3<kSplit>(oacc[dt], ph, pl, bfh, bfl);
        }
      }
    }
  }
  cluster_wait();   // no rank reads this block's exchange slots any more

  // the two warpgroups' states merged as in the wide forward
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  __syncthreads();   // every warp is done with the last tile
  float* Ox = reinterpret_cast<float*>(Ks);
  float* Mx = Ox + 4 * kSteps * kFrag;
  if (grp == 1) {
#pragma unroll
    for (int dt = 0; dt < kSteps; ++dt) put_frag(Ox + (slab * kSteps + dt) * kFrag, oacc[dt], lane);
    const float st[4] = {m_lo, m_hi, l_lo, l_hi};
    put_frag(Mx + slab * kFrag, st, lane);
  }
  __syncthreads();
  if (grp == 1) return;
  float other[4];
  get_frag(Mx + slab * kFrag, other, lane);
  const float n_lo = fmaxf(m_lo, other[0]), n_hi = fmaxf(m_hi, other[1]);
  const float a_lo = fast_exp2(m_lo - n_lo), a_hi = fast_exp2(m_hi - n_hi);
  const float b_lo = fast_exp2(other[0] - n_lo), b_hi = fast_exp2(other[1] - n_hi);
  l_lo = l_lo * a_lo + other[2] * b_lo;
  l_hi = l_hi * a_hi + other[3] * b_hi;
  const float i_lo = 1.0f / l_lo, i_hi = 1.0f / l_hi;
  const int r_lo = row0 + g, r_hi = r_lo + 8;
#pragma unroll
  for (int dt = 0; dt < kSteps; ++dt) {
    float x[4];
    get_frag(Ox + (slab * kSteps + dt) * kFrag, x, lane);
    const int col = dt * 8 + 2 * t;
    if (r_lo < S)
      store_pair(o + base + (size_t)r_lo * D, col, hd_c, (oacc[dt][0] * a_lo + x[0] * b_lo) * i_lo,
                 (oacc[dt][1] * a_lo + x[1] * b_lo) * i_lo);
    if (r_hi < S)
      store_pair(o + base + (size_t)r_hi * D, col, hd_c, (oacc[dt][2] * a_hi + x[2] * b_hi) * i_hi,
                 (oacc[dt][3] * a_hi + x[3] * b_hi) * i_hi);
  }
  if constexpr (kLse) {
    if (t == 0 && rank == 0) {
      float* row_lse = lse + (size_t)bh * S;
      if (r_lo < S) row_lse[r_lo] = (n_lo + log2f(l_lo)) * kLn2;
      if (r_hi < S) row_lse[r_hi] = (n_hi + log2f(l_hi)) * kLn2;
    }
  }
}

// Backward, heads of 257 to 2,048 columns, first kernel: delta and this
// rank's slice of dQ for 64 query rows; grid as the forward's. shared
// memory: the wide dQ kernel's (this rank's slice of the block's Q and dO
// rows, K and V tiles of kBwdRows keys, two stages each), then the exchange
// slots [slab][half][S 0-7, S 8-15, dP 0-7, dP 8-15][kFrag]
template <typename T>
__global__ void __launch_bounds__(kWideThreads, 1)
attention_cluster_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const T* __restrict__ o,
                                const T* __restrict__ dout, const float* __restrict__ lse,
                                float* __restrict__ delta, T* __restrict__ dq, int S, int H,
                                int hd, float scale, float scale_log2e) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int ld = wide_ld<T>(), kHalfSteps = kWideHead / 16, kTileElems = kBwdRows * ld;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [kWideRows][ld]
  T* Gs = Qs + kWideRows * ld;              // dO, [kWideRows][ld]
  T* Ks = Gs + kWideRows * ld;              // [2][kBwdRows][ld]
  T* Vs = Ks + 2 * kTileElems;              // [2][kBwdRows][ld]
  float* Xs = reinterpret_cast<float*>(Vs + 2 * kTileElems);   // [4][2][4][kFrag]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster_rank(), n_ranks = cluster_blocks();
  const int bh = blockIdx.x / n_ranks, b = bh / H, h = bh - b * H;
  const int D = H * hd, c0 = rank * kWideHead, hd_c = min(kWideHead, hd - c0);
  const size_t base = (size_t)b * S * D + (size_t)h * hd + c0;   // this rank's slice
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int slab = warp & 3, half = warp >> 2;   // 16 rows; half of the slice's columns
  const int r0 = slab * 16, row0 = blockIdx.y * kWideRows + r0, cw = half * (kWideHead / 2);
  const int n_tiles = (S + kBwdRows - 1) / kBwdRows;
  float* slot = Xs + slab * 8 * kFrag;   // this slab's [half][4][kFrag]

  zero_head_pad(Qs, 2 * kWideRows + 4 * kBwdRows, hd_c);
  stage_cols(Qs, ld, q, base, blockIdx.y * kWideRows, kWideRows, S, D, hd_c, hd);
  stage_cols(Gs, ld, dout, base, blockIdx.y * kWideRows, kWideRows, S, D, hd_c, hd);
  cp_async_commit();
  stage_cols(Ks, ld, k, base, 0, kBwdRows, S, D, hd_c, hd);
  stage_cols(Vs, ld, v, base, 0, kBwdRows, S, D, hd_c, hd);
  cp_async_commit();
  cp_async_wait<1>();   // Q and dO have landed; the first K and V tiles may not have
  __syncthreads();

  // delta = rowsum(dO o): this rank's columns in the wide kernel's order,
  // then the ranks' partials in rank order
  const int r_lo = row0 + g, r_hi = r_lo + 8;
  float del_lo = 0.0f, del_hi = 0.0f;
  for (int col = 0; col < hd_c; col += 8) {
    const T* y = Gs + (r0 + g) * ld + col + t;
    float z[4];
    a_values(o, base, row0, col, S, D, hd_c, g, t, z);
    del_lo = fmaf(to_float(y[0]), z[0], fmaf(to_float(y[4]), z[2], del_lo));
    del_hi = fmaf(to_float(y[8 * ld]), z[1], fmaf(to_float(y[8 * ld + 4]), z[3], del_hi));
  }
  del_lo += __shfl_xor_sync(0xffffffffu, del_lo, 1);
  del_lo += __shfl_xor_sync(0xffffffffu, del_lo, 2);
  del_hi += __shfl_xor_sync(0xffffffffu, del_hi, 1);
  del_hi += __shfl_xor_sync(0xffffffffu, del_hi, 2);
  if (half == 0) reinterpret_cast<float2*>(slot)[lane] = make_float2(del_lo, del_hi);
  cluster_arrive();
  cluster_wait();   // every rank's partial delta is written (and every block runs)
  del_lo = del_hi = 0.0f;
  for (int r = 0; r < n_ranks; ++r) {
    const float2 x = reinterpret_cast<const float2*>(cluster.map_shared_rank(slot, r))[lane];
    del_lo += x.x;
    del_hi += x.y;
  }
  cluster_arrive();   // done reading: the first tile's writes wait for every rank's
  const float* row_lse = lse + (size_t)bh * S;
  const float L_lo = r_lo < S ? row_lse[r_lo] * kLog2e : 0.0f;
  const float L_hi = r_hi < S ? row_lse[r_hi] * kLog2e : 0.0f;
  if (t == 0 && half == 0 && rank == 0) {
    if (r_lo < S) delta[(size_t)bh * S + r_lo] = del_lo;
    if (r_hi < S) delta[(size_t)bh * S + r_hi] = del_hi;
  }

  float dacc[kHalfSteps][4];
#pragma unroll
  for (int dt = 0; dt < kHalfSteps; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dacc[dt][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();   // this tile has landed; every warp is done with the last one
    if (it + 1 < n_tiles) {   // the next tile loads while this one is multiplied
      const int nb = (it + 1) & 1;
      stage_cols(Ks + nb * kTileElems, ld, k, base, (it + 1) * kBwdRows, kBwdRows, S, D, hd_c, hd);
      stage_cols(Vs + nb * kTileElems, ld, v, base, (it + 1) * kBwdRows, kBwdRows, S, D, hd_c, hd);
    }
    cp_async_commit();
    const T* Kt = Ks + (it & 1) * kTileElems;
    const T* Vt = Vs + (it & 1) * kTileElems;
    const int keys_left = S - it * kBwdRows;

    // S and dP of the warp's 16 rows and the tile's 16 keys: this warp's 128
    // columns, then the whole head through the cluster
    float s[2][4], dp[2][4];
    half_logits<kSplit>(Qs, Gs, Kt, Vt, r0, cw, hd_c, g, t, s, dp);
    cluster_wait();    // every rank has read the last tile's partials
    float* mine = slot + half * 4 * kFrag;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      put_frag4(mine + nt * kFrag, s[nt], lane);
      put_frag4(mine + (2 + nt) * kFrag, dp[nt], lane);
    }
    cluster_arrive();
    cluster_wait();    // every rank's partials of this tile are written
    cluster_sum_halves(slot, n_ranks, lane, s, dp);
    cluster_arrive();  // done reading
    // dS in place of S; keys past the end: zero rows of K and V, P set to 0
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float p[4];
      p[0] = fast_exp2(fmaf(s[nt][0], scale_log2e, -L_lo));
      p[1] = fast_exp2(fmaf(s[nt][1], scale_log2e, -L_lo));
      p[2] = fast_exp2(fmaf(s[nt][2], scale_log2e, -L_hi));
      p[3] = fast_exp2(fmaf(s[nt][3], scale_log2e, -L_hi));
      const int key = nt * 8 + 2 * t;
      if (key >= keys_left) p[0] = p[2] = 0.0f;
      if (key + 1 >= keys_left) p[1] = p[3] = 0.0f;
      s[nt][0] = p[0] * (dp[nt][0] - del_lo);
      s[nt][1] = p[1] * (dp[nt][1] - del_lo);
      s[nt][2] = p[2] * (dp[nt][2] - del_hi);
      s[nt][3] = p[3] * (dp[nt][3] - del_hi);
    }
    // dQ[16 rows, this warp's 128 columns] += dS (16 rows x 16 keys) K
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
      uint32_t ah[4], al[4];
      acc_as_a<kSplit>(s[kt], ah, al);
#pragma unroll
      for (int dt = 0; dt < kHalfSteps; ++dt) {
        uint32_t bfh[2], bfl[2];
        b_cols<kSplit>(Kt, ld, kt * 8, cw + dt * 8, g, t, bfh, bfl);
        mma3<kSplit>(dacc[dt], ah, al, bfh, bfl);
      }
    }
  }
  cluster_wait();   // no rank reads this block's exchange slots any more

#pragma unroll
  for (int dt = 0; dt < kHalfSteps; ++dt) {
    const int col = cw + dt * 8 + 2 * t;
    if (r_lo < S)
      store_pair(dq + base + (size_t)r_lo * D, col, hd_c, dacc[dt][0] * scale,
                 dacc[dt][1] * scale);
    if (r_hi < S)
      store_pair(dq + base + (size_t)r_hi * D, col, hd_c, dacc[dt][2] * scale,
                 dacc[dt][3] * scale);
  }
}

// Backward, heads of 257 to 2,048 columns, second kernel: this rank's slices
// of dK and dV for 64 keys, after the first has written delta; grid as the
// forward's. shared memory: the wide dK/dV kernel's (this rank's slice of the
// block's K and V rows, Q and dO tiles of kBwdRows queries and their L and
// delta, two stages each), then the exchange slots [slab][half][S^T 0-7,
// S^T 8-15, dP^T 0-7, dP^T 8-15][kFrag]
template <typename T>
__global__ void __launch_bounds__(kWideThreads, 1)
attention_cluster_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                  const T* __restrict__ v, const T* __restrict__ dout,
                                  const float* __restrict__ lse, const float* __restrict__ delta,
                                  T* __restrict__ dk, T* __restrict__ dv, int S, int H, int hd,
                                  float scale, float scale_log2e) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int ld = wide_ld<T>(), kHalfSteps = kWideHead / 16, kTileElems = kBwdRows * ld;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);   // [kWideRows][ld]
  T* Vs = Ks + kWideRows * ld;              // [kWideRows][ld]
  T* Qs = Vs + kWideRows * ld;              // [2][kBwdRows][ld]
  T* Gs = Qs + 2 * kTileElems;              // dO, [2][kBwdRows][ld]
  float* Ls = reinterpret_cast<float*>(Gs + 2 * kTileElems);   // [2][kBwdRows]
  float* Ds = Ls + 2 * kBwdRows;                               // [2][kBwdRows]
  float* Xs = Ds + 2 * kBwdRows;                               // [4][2][4][kFrag]

  const int rank = cluster_rank(), n_ranks = cluster_blocks();
  const int bh = blockIdx.x / n_ranks, b = bh / H, h = bh - b * H;
  const int D = H * hd, c0 = rank * kWideHead, hd_c = min(kWideHead, hd - c0);
  const size_t base = (size_t)b * S * D + (size_t)h * hd + c0;   // this rank's slice
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int slab = warp & 3, half = warp >> 2;   // 16 keys; half of the slice's columns
  const int r0 = slab * 16, key0 = blockIdx.y * kWideRows + r0, cw = half * (kWideHead / 2);
  const int n_tiles = (S + kBwdRows - 1) / kBwdRows;
  const float* row_lse = lse + (size_t)bh * S;
  const float* row_delta = delta + (size_t)bh * S;
  float* slot = Xs + slab * 8 * kFrag;   // this slab's [half][4][kFrag]

  zero_head_pad(Ks, 2 * kWideRows + 4 * kBwdRows, hd_c);
  stage_cols(Ks, ld, k, base, blockIdx.y * kWideRows, kWideRows, S, D, hd_c, hd);
  stage_cols(Vs, ld, v, base, blockIdx.y * kWideRows, kWideRows, S, D, hd_c, hd);
  stage_cols(Qs, ld, q, base, 0, kBwdRows, S, D, hd_c, hd);
  stage_cols(Gs, ld, dout, base, 0, kBwdRows, S, D, hd_c, hd);
  stage_entries(Ls, row_lse, 0, kBwdRows, S);
  stage_entries(Ds, row_delta, 0, kBwdRows, S);
  cp_async_commit();

  float kacc[kHalfSteps][4], vacc[kHalfSteps][4];
#pragma unroll
  for (int dt = 0; dt < kHalfSteps; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) kacc[dt][e] = vacc[dt][e] = 0.0f;
  cluster_arrive();   // the first tile's wait also finds every block of the cluster running

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();   // this tile has landed; every warp is done with the last one
    if (it + 1 < n_tiles) {   // the next tile loads while this one is multiplied
      const int nb = (it + 1) & 1, next = (it + 1) * kBwdRows;
      stage_cols(Qs + nb * kTileElems, ld, q, base, next, kBwdRows, S, D, hd_c, hd);
      stage_cols(Gs + nb * kTileElems, ld, dout, base, next, kBwdRows, S, D, hd_c, hd);
      stage_entries(Ls + nb * kBwdRows, row_lse, next, kBwdRows, S);
      stage_entries(Ds + nb * kBwdRows, row_delta, next, kBwdRows, S);
    }
    cp_async_commit();
    const T* Qt = Qs + (it & 1) * kTileElems;
    const T* Gt = Gs + (it & 1) * kTileElems;
    const float* Lt = Ls + (it & 1) * kBwdRows;
    const float* Dt = Ds + (it & 1) * kBwdRows;

    // S^T and dP^T of the warp's 16 keys and the tile's 16 queries: this
    // warp's 128 columns, then the whole head through the cluster; then P^T
    // in place of S^T and dS^T in place of dP^T. Queries past S are zero
    // rows with L = delta = 0: P = 1 there, and dO = 0 and dS = 0 keep them
    // out of both sums.
    float st[2][4], dpt[2][4];
    half_logits<kSplit>(Ks, Vs, Qt, Gt, r0, cw, hd_c, g, t, st, dpt);
    cluster_wait();    // every rank has read the last tile's partials
    float* mine = slot + half * 4 * kFrag;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      put_frag4(mine + nt * kFrag, st[nt], lane);
      put_frag4(mine + (2 + nt) * kFrag, dpt[nt], lane);
    }
    cluster_arrive();
    cluster_wait();    // every rank's partials of this tile are written
    cluster_sum_halves(slot, n_ranks, lane, st, dpt);
    cluster_arrive();  // done reading
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int qa = nt * 8 + 2 * t;   // this lane's two queries: columns 0/2 and 1/3
      const float L0 = Lt[qa] * kLog2e, L1 = Lt[qa + 1] * kLog2e;
      const float d0 = Dt[qa], d1 = Dt[qa + 1];
      st[nt][0] = fast_exp2(fmaf(st[nt][0], scale_log2e, -L0));
      st[nt][1] = fast_exp2(fmaf(st[nt][1], scale_log2e, -L1));
      st[nt][2] = fast_exp2(fmaf(st[nt][2], scale_log2e, -L0));
      st[nt][3] = fast_exp2(fmaf(st[nt][3], scale_log2e, -L1));
      dpt[nt][0] = st[nt][0] * (dpt[nt][0] - d0);
      dpt[nt][1] = st[nt][1] * (dpt[nt][1] - d1);
      dpt[nt][2] = st[nt][2] * (dpt[nt][2] - d0);
      dpt[nt][3] = st[nt][3] * (dpt[nt][3] - d1);
    }
    // dV += P^T dO, dK += dS^T Q over the tile's 16 queries, this warp's columns
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      acc_as_a<kSplit>(st[kt], ph, pl);
      acc_as_a<kSplit>(dpt[kt], sh, sl);
#pragma unroll
      for (int dt = 0; dt < kHalfSteps; ++dt) {
        uint32_t bfh[2], bfl[2];
        b_cols<kSplit>(Gt, ld, kt * 8, cw + dt * 8, g, t, bfh, bfl);
        mma3<kSplit>(vacc[dt], ph, pl, bfh, bfl);
        b_cols<kSplit>(Qt, ld, kt * 8, cw + dt * 8, g, t, bfh, bfl);
        mma3<kSplit>(kacc[dt], sh, sl, bfh, bfl);
      }
    }
  }
  cluster_wait();   // no rank reads this block's exchange slots any more

  const int r_lo = key0 + g, r_hi = r_lo + 8;
#pragma unroll
  for (int dt = 0; dt < kHalfSteps; ++dt) {
    const int col = cw + dt * 8 + 2 * t;
    if (r_lo < S) {
      store_pair(dk + base + (size_t)r_lo * D, col, hd_c, kacc[dt][0] * scale,
                 kacc[dt][1] * scale);
      store_pair(dv + base + (size_t)r_lo * D, col, hd_c, vacc[dt][0], vacc[dt][1]);
    }
    if (r_hi < S) {
      store_pair(dk + base + (size_t)r_hi * D, col, hd_c, kacc[dt][2] * scale,
                 kacc[dt][3] * scale);
      store_pair(dv + base + (size_t)r_hi * D, col, hd_c, vacc[dt][2], vacc[dt][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int HD>
size_t tf32_shared_bytes(bool with_vectors) {
  return sizeof(float) * (4 * (size_t)tile_floats<HD>() + (with_vectors ? 4 * kTile : 0));
}

size_t mma_shared_bytes(int S, int hd) {
  const size_t Sp = (size_t)(S + kKeyChunk - 1) / kKeyChunk * kKeyChunk;
  return sizeof(__nv_bfloat16) * 2 * Sp * (hd + kPad);
}

template <int HD, bool kLse>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int S, int H, float scale, cudaStream_t s) {
  const size_t bytes = mma_shared_bytes(S, HD);
  cudaError_t err = allow_shared(attention_mma_kernel<HD, kLse>, bytes);
  if (err != cudaSuccess) return err;
  attention_mma_kernel<HD, kLse><<<B * H, kMmaWarps * 32, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, S, H,
      scale * kLog2e);
  return cudaGetLastError();
}

template <int HD, bool kLse>
cudaError_t launch_ring(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                        int S, int H, float scale, cudaStream_t s) {
  // shared memory does not depend on S: any sequence length runs
  using Sv = Serve<HD>;
  cudaError_t err = allow_shared(attention_ring_kernel<HD, kLse>, Sv::kSharedBytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * ((S + Sv::kRows - 1) / Sv::kRows);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  attention_ring_kernel<HD, kLse><<<(unsigned)blocks, Sv::kWarps * 32, Sv::kSharedBytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, S, H,
      scale * kLog2e);
  return cudaGetLastError();
}

template <typename T, int HD, bool kLse>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                        int S, int H, int hd, float scale, cudaStream_t s) {
  const size_t bytes = tf32_shared_bytes<HD>(false);
  cudaError_t err = allow_shared(attention_tf32_kernel<T, HD, kLse>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + kTile - 1) / kTile);
  attention_tf32_kernel<T, HD, kLse><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, S, H, hd, scale * kLog2e);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_tf32_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                            int B, int S, int H, int hd, float scale, cudaStream_t s) {
  if (lse) return launch_tf32<T, HD, true>(q, k, v, o, lse, B, S, H, hd, scale, s);
  return launch_tf32<T, HD, false>(q, k, v, o, lse, B, S, H, hd, scale, s);
}

template <typename T, int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int B, int S, int H, int hd, float scale, cudaStream_t s) {
  const dim3 grid(B * H, (S + kTile - 1) / kTile);
  const size_t dq_bytes = tf32_shared_bytes<HD>(false);
  cudaError_t err = allow_shared(attention_bwd_dq_kernel<T, HD>, dq_bytes);
  if (err != cudaSuccess) return err;
  attention_bwd_dq_kernel<T, HD><<<grid, kThreads, dq_bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq),
      S, H, hd, scale, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t kv_bytes = tf32_shared_bytes<HD>(true);
  err = allow_shared(attention_bwd_dkdv_kernel<T, HD>, kv_bytes);
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_kernel<T, HD><<<grid, kThreads, kv_bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, H,
      hd, scale, scale * kLog2e);
  return cudaGetLastError();
}

size_t sliced_shared_bytes(bool with_vectors) {
  return sizeof(float) * (2 * (size_t)tile_floats<kSlice>() + (with_vectors ? 2 * kTile : 0));
}

template <typename T>
cudaError_t launch_sliced_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                            int B, int S, int H, int hd, float scale, cudaStream_t s) {
  const size_t bytes = sliced_shared_bytes(false);
  const dim3 grid(B * H, (S + kTile - 1) / kTile, (hd + kSlice - 1) / kSlice);
  if (lse) {
    cudaError_t err = allow_shared(attention_sliced_fwd_kernel<T, true>, bytes);
    if (err != cudaSuccess) return err;
    attention_sliced_fwd_kernel<T, true><<<grid, kThreads, bytes, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), lse, S, H, hd, scale * kLog2e);
  } else {
    cudaError_t err = allow_shared(attention_sliced_fwd_kernel<T, false>, bytes);
    if (err != cudaSuccess) return err;
    attention_sliced_fwd_kernel<T, false><<<grid, kThreads, bytes, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), lse, S, H, hd, scale * kLog2e);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sliced_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const float* lse, float* delta, void* dq,
                            void* dk, void* dv, int B, int S, int H, int hd, float scale,
                            cudaStream_t s) {
  const int n_slices = (hd + kSlice - 1) / kSlice;
  const dim3 grid(B * H, (S + kTile - 1) / kTile, n_slices);
  const size_t dq_bytes = sliced_shared_bytes(false);
  cudaError_t err = allow_shared(attention_sliced_bwd_dq_kernel<T>, dq_bytes);
  if (err != cudaSuccess) return err;
  attention_sliced_bwd_dq_kernel<T><<<grid, kThreads, dq_bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq),
      S, H, hd, scale, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t kv_bytes = sliced_shared_bytes(true);
  err = allow_shared(attention_sliced_bwd_dkdv_kernel<T>, kv_bytes);
  if (err != cudaSuccess) return err;
  const dim3 kv_grid(B * H, (S + kTile - 1) / kTile, 2 * n_slices);
  attention_sliced_bwd_dkdv_kernel<T><<<kv_grid, kThreads, kv_bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, H,
      hd, scale, scale * kLog2e);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wide_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                            int B, int S, int H, int hd, float scale, cudaStream_t s) {
  constexpr size_t bytes = wide_fwd_bytes<T>();
  const dim3 grid(B * H, (S + kWideRows - 1) / kWideRows);
  if (lse) {
    cudaError_t err = allow_shared(attention_wide_fwd_kernel<T, true>, bytes);
    if (err != cudaSuccess) return err;
    attention_wide_fwd_kernel<T, true><<<grid, kWideThreads, bytes, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), lse, S, H, hd, scale * kLog2e);
  } else {
    cudaError_t err = allow_shared(attention_wide_fwd_kernel<T, false>, bytes);
    if (err != cudaSuccess) return err;
    attention_wide_fwd_kernel<T, false><<<grid, kWideThreads, bytes, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), lse, S, H, hd, scale * kLog2e);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wide_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const float* lse, float* delta, void* dq,
                            void* dk, void* dv, int B, int S, int H, int hd, float scale,
                            cudaStream_t s) {
  const dim3 grid(B * H, (S + kWideRows - 1) / kWideRows);
  cudaError_t err = allow_shared(attention_wide_bwd_dq_kernel<T>, wide_dq_bytes<T>());
  if (err != cudaSuccess) return err;
  attention_wide_bwd_dq_kernel<T><<<grid, kWideThreads, wide_dq_bytes<T>(), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq),
      S, H, hd, scale, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = allow_shared(attention_wide_bwd_dkdv_kernel<T>, wide_dkdv_bytes<T>());
  if (err != cudaSuccess) return err;
  attention_wide_bwd_dkdv_kernel<T><<<grid, kWideThreads, wide_dkdv_bytes<T>(), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, H,
      hd, scale, scale * kLog2e);
  return cudaGetLastError();
}

// The launch of a cluster kernel: clusters of n blocks along x, kWideThreads
// threads a block. Not copyable: cfg points at attr.
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  ClusterLaunch(int n, dim3 grid, size_t bytes, cudaStream_t s) : attr{}, cfg{} {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kWideThreads, 1, 1);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
  ClusterLaunch& operator=(const ClusterLaunch&) = delete;
};

// The most clusters of n blocks of kKernel that the current device holds at
// once (cudaOccupancyMaxActiveClusters), after lifting the kernel's dynamic
// shared-memory limit to bytes
template <auto kKernel>
cudaError_t cluster_capacity(int n, size_t bytes, int* clusters) {
  cudaError_t err = allow_shared(kKernel, bytes);
  if (err != cudaSuccess) return err;
  ClusterLaunch l(n, dim3(n, 1, 1), bytes, nullptr);
  return cudaOccupancyMaxActiveClusters(clusters, reinterpret_cast<const void*>(kKernel), &l.cfg);
}

// kKernel on clusters of n blocks, once the device has been found to hold
// one such cluster; a device that cannot is an error (nothing falls back)
template <auto kKernel, typename... Args>
cudaError_t launch_cluster(int n, dim3 grid, size_t bytes, cudaStream_t s, Args... args) {
  int clusters = 0;
  cudaError_t err = cluster_capacity<kKernel>(n, bytes, &clusters);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  ClusterLaunch l(n, grid, bytes, s);
  err = cudaLaunchKernelEx(&l.cfg, kKernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// blocks per cluster for a head of hd columns, and the grid: (B * H * n,
// tiles of 64 rows); a grid too large for x is an error
cudaError_t cluster_grid(int B, int S, int H, int hd, int* n, dim3* grid) {
  *n = (hd + kWideHead - 1) / kWideHead;
  if (hd <= kWideHead || *n > kMaxRanks) return cudaErrorInvalidValue;
  const long long blocks = (long long)B * H * *n;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  *grid = dim3((unsigned)blocks, (S + kWideRows - 1) / kWideRows, 1);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_cluster_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                               int B, int S, int H, int hd, float scale, cudaStream_t s) {
  int n = 0;
  dim3 grid;
  cudaError_t err = cluster_grid(B, S, H, hd, &n, &grid);
  if (err != cudaSuccess) return err;
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  if (lse)
    return launch_cluster<attention_cluster_fwd_kernel<T, true>>(
        n, grid, cluster_fwd_bytes<T>(), s, qt, kt, vt, ot, lse, S, H, hd, scale * kLog2e);
  return launch_cluster<attention_cluster_fwd_kernel<T, false>>(
      n, grid, cluster_fwd_bytes<T>(), s, qt, kt, vt, ot, lse, S, H, hd, scale * kLog2e);
}

template <typename T>
cudaError_t launch_cluster_bwd(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const float* lse, float* delta, void* dq,
                               void* dk, void* dv, int B, int S, int H, int hd, float scale,
                               cudaStream_t s) {
  int n = 0;
  dim3 grid;
  cudaError_t err = cluster_grid(B, S, H, hd, &n, &grid);
  if (err != cudaSuccess) return err;
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *gt = static_cast<const T*>(dout);
  err = launch_cluster<attention_cluster_bwd_dq_kernel<T>>(
      n, grid, wide_dq_bytes<T>(), s, qt, kt, vt, static_cast<const T*>(o), gt, lse, delta,
      static_cast<T*>(dq), S, H, hd, scale, scale * kLog2e);
  if (err != cudaSuccess) return err;
  return launch_cluster<attention_cluster_bwd_dkdv_kernel<T>>(
      n, grid, wide_dkdv_bytes<T>(), s, qt, kt, vt, gt, lse, static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, hd, scale, scale * kLog2e);
}

// what the device holds of each cluster kernel at n blocks a cluster:
// clusters[0..3] = forward, forward with L, dQ, dK/dV
template <typename T>
cudaError_t cluster_occupancy(int n, int* clusters) {
  cudaError_t err =
      cluster_capacity<attention_cluster_fwd_kernel<T, false>>(n, cluster_fwd_bytes<T>(), clusters);
  if (err == cudaSuccess)
    err = cluster_capacity<attention_cluster_fwd_kernel<T, true>>(n, cluster_fwd_bytes<T>(),
                                                                 clusters + 1);
  if (err == cudaSuccess)
    err = cluster_capacity<attention_cluster_bwd_dq_kernel<T>>(n, wide_dq_bytes<T>(), clusters + 2);
  if (err == cudaSuccess)
    err = cluster_capacity<attention_cluster_bwd_dkdv_kernel<T>>(n, wide_dkdv_bytes<T>(),
                                                                clusters + 3);
  return err;
}

// head_dim -> the instantiated tile width: 32, 64 or 128 (the narrow
// kernels), kWideHead (the one-pass wide kernels), kClusterHead (the
// cluster kernels), 0 beyond (the sliced kernels)
int padded_head(int hd) {
  return hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128 : hd <= kWideHead ? kWideHead
         : hd <= kClusterHead ? kClusterHead : 0;
}

template <typename T, int HD>
struct Instance {
  using type = T;
  static constexpr int width = HD;
};

// calls launch(Instance<input type, tile width>{}) for this type and head
// size; width 0 stands for the sliced kernels
template <typename F>
cudaError_t dispatch(int hd, int is_bf16, F&& launch) {
  switch (padded_head(hd)) {
    case 32:
      return is_bf16 ? launch(Instance<__nv_bfloat16, 32>{}) : launch(Instance<float, 32>{});
    case 64:
      return is_bf16 ? launch(Instance<__nv_bfloat16, 64>{}) : launch(Instance<float, 64>{});
    case 128:
      return is_bf16 ? launch(Instance<__nv_bfloat16, 128>{}) : launch(Instance<float, 128>{});
    case kWideHead:
      return is_bf16 ? launch(Instance<__nv_bfloat16, kWideHead>{})
                     : launch(Instance<float, kWideHead>{});
    case kClusterHead:
      return is_bf16 ? launch(Instance<__nv_bfloat16, kClusterHead>{})
                     : launch(Instance<float, kClusterHead>{});
    default:
      return is_bf16 ? launch(Instance<__nv_bfloat16, 0>{}) : launch(Instance<float, 0>{});
  }
}

}  // namespace

// q, k, v, o: contiguous (B, S, H*hd), 16-byte aligned, f32 (is_bf16 = 0) or
// bf16. lse: null, or (B, H, S) f32 for the row log-sum-exp. kernel 0: the
// TF32 kernel, hd up to 128, the one-pass wide kernel up to 256, the cluster
// kernel up to 2,048 and the sliced kernel above that; 1: the bf16 serving
// kernels (hd 32 or 64, scale > 0 only: they take the row maximum before
// scaling), the staged one at hd 32 while the sequence fits its shared
// memory, else the ring; 2: the sliced kernel at any hd above 128 (what the
// one-pass wide and the cluster kernels replaced, for comparison); 3: the
// ring at hd 32 or 64 and any S (to compare the two serving kernels on the
// same tensors).
extern "C" int attention_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                    float* lse, int B, int S, int H, int hd, float scale,
                                    int is_bf16, int kernel, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == 2) {
    if (hd <= 128) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        is_bf16 ? launch_sliced_fwd<__nv_bfloat16>(q, k, v, o, lse, B, S, H, hd, scale, s)
                : launch_sliced_fwd<float>(q, k, v, o, lse, B, S, H, hd, scale, s));
  }
  if (kernel == 1 || kernel == 3) {
    if (!is_bf16 || !(scale > 0.0f) || (hd != 32 && hd != 64))
      return static_cast<int>(cudaErrorInvalidValue);
    // head size 32 keeps the staged kernel while one block's shared memory
    // holds the whole sequence (S <= 1,408 on an H100: the faster of the two
    // at the ViT's S = 225); head size 64 and longer sequences run the ring
    if (kernel == 1 && hd == 32) {
      int device = 0, optin = 0;
      cudaError_t err = cudaGetDevice(&device);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (mma_shared_bytes(S, 32) <= (size_t)optin)
        return static_cast<int>(lse ? launch_mma<32, true>(q, k, v, o, lse, B, S, H, scale, s)
                                    : launch_mma<32, false>(q, k, v, o, lse, B, S, H, scale, s));
    }
    if (hd == 32)
      return static_cast<int>(lse ? launch_ring<32, true>(q, k, v, o, lse, B, S, H, scale, s)
                                  : launch_ring<32, false>(q, k, v, o, lse, B, S, H, scale, s));
    return static_cast<int>(lse ? launch_ring<64, true>(q, k, v, o, lse, B, S, H, scale, s)
                                : launch_ring<64, false>(q, k, v, o, lse, B, S, H, scale, s));
  }
  return static_cast<int>(dispatch(hd, is_bf16, [&](auto inst) {
    using I = decltype(inst);
    if constexpr (I::width == 0)
      return launch_sliced_fwd<typename I::type>(q, k, v, o, lse, B, S, H, hd, scale, s);
    else if constexpr (I::width == kClusterHead)
      return launch_cluster_fwd<typename I::type>(q, k, v, o, lse, B, S, H, hd, scale, s);
    else if constexpr (I::width == kWideHead)
      return launch_wide_fwd<typename I::type>(q, k, v, o, lse, B, S, H, hd, scale, s);
    else
      return launch_tf32_fwd<typename I::type, I::width>(q, k, v, o, lse, B, S, H, hd, scale, s);
  }));
}

// q, k, v, o (the forward's output), dout (its gradient): contiguous (B, S,
// H*hd); lse: (B, H, S) f32 from the forward; delta: (B, H, S) f32 scratch;
// dq, dk, dv out. Two launches on the stream: delta and dq, then dk and dv.
// kernel 0: the kernels of the head size's family; 2: the sliced kernels at
// any hd above 128 (for comparison, as the forward's kernel 2).
extern "C" int attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                                    const void* dout, const float* lse, float* delta, void* dq,
                                    void* dk, void* dv, int B, int S, int H, int hd,
                                    float scale, int is_bf16, int kernel, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == 2) {
    if (hd <= 128) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        is_bf16 ? launch_sliced_bwd<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S,
                                                   H, hd, scale, s)
                : launch_sliced_bwd<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, hd,
                                           scale, s));
  }
  if (kernel != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(hd, is_bf16, [&](auto inst) {
    using I = decltype(inst);
    if constexpr (I::width == 0)
      return launch_sliced_bwd<typename I::type>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S,
                                                 H, hd, scale, s);
    else if constexpr (I::width == kClusterHead)
      return launch_cluster_bwd<typename I::type>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S,
                                                  H, hd, scale, s);
    else if constexpr (I::width == kWideHead)
      return launch_wide_bwd<typename I::type>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H,
                                               hd, scale, s);
    else
      return launch_bwd<typename I::type, I::width>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                                    S, H, hd, scale, s);
  }));
}

// The most clusters of each cluster kernel the current device holds at once
// for a head of hd columns (257 to 2,048): clusters[0..3] = the forward
// without and with L, the dQ kernel, the dK/dV kernel.
extern "C" int attention_cluster_occupancy(int hd, int is_bf16, int* clusters) {
  if (hd <= kWideHead || hd > kClusterHead) return static_cast<int>(cudaErrorInvalidValue);
  const int n = (hd + kWideHead - 1) / kWideHead;
  return static_cast<int>(is_bf16 ? cluster_occupancy<__nv_bfloat16>(n, clusters)
                                  : cluster_occupancy<float>(n, clusters));
}

extern "C" const char* attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
