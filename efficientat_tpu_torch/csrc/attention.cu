// PaSST's multi-head attention forward in bf16x3, CUDA C++ for sm_90a:
// softmax(q k^T / 8) v for every (clip, head), written straight
// into the (B, N, H x 64) layout that the block's output projection reads.
//
// It replaces no TPU kernel: the JAX package has no transformer. It was added
// because PaSST-S's attention ran on SDPA's memory-efficient fp32 kernel on
// the CUDA cores (fmha_cutlassF_f32_aligned_64x64_rf_sm80, flash and cuDNN
// refuse fp32) at 3.3 % of its roofline, a quarter of a B=32 serving call.
//
// What bounds it, at B = 32 clips of 10 s (N = 1,190 tokens, 12 heads of 64,
// 12 blocks): q k^T and p v are 4 N^2 x 64 FLOPs a (clip, head), 1.67 TFLOP
// a call, 1.69 ms at the 989 TFLOP/s bf16 dense peak; the bytes (q, k, v read
// and o written in fp32, 1.4 GB a call) take 0.42 ms at 3.35 TB/s. The
// products run as bf16x3, three bf16 products each (hi hi + hi lo + lo hi),
// so the bound of this design is 3 x 1.69 = 5.07 ms a call. bf16x3 is below
// fp32's precision: the parts keep 16 of an operand's 24 bits, a product
// rounds at about 2^-16 of its size, and the output lies 8-13x further from
// float64 than fp32 products put it (one-pass bf16 some 1000x further).
//
// The design (FA3's shape):
// - split_kv_kernel, one byte-bound pass before: k and v, read in place
//   from any strided view (the qkv product's (B, N, 3, H, 64) output), are
//   split into bf16 hi and lo parts (lo the bf16 of what hi leaves) and
//   written as 32 KB tiles of 64 keys, [k hi | k lo | v hi | v lo], each part
//   in the canonical K-major layout of a wgmma B operand without swizzle
//   (mel_wgmma::b_desc): k as (d x keys), v transposed as (keys x d). Keys
//   past N are zero. (Split on load inside attention_kernel, from fp32 rows
//   staged by the producer, both warpgroups splitting each key tile behind
//   a shared barrier, the call read 2.68 ms against 0.84 + 0.16 here: the
//   split is redone for each of a head's 10 query tiles, and the barrier
//   locks the two warpgroups in step.)
// - attention_kernel: persistent blocks of two consumer warpgroups and a
//   producer warpgroup, whose first warp copies and whose registers go to
//   the consumers (setmaxnreg: 232 a consumer thread, no spill). A work tile
//   is 128 query rows of one (clip, head), 64 a consumer warpgroup. The
//   producer brings the tile's q rows (fp32, one 256-byte bulk copy a row)
//   into a shared-memory buffer and the key tiles through a ring of STAGES
//   32 KB slots, one bulk copy each, each on its mbarrier; the consumers
//   release the buffer and each slot on its empty barrier.
// - A consumer warpgroup splits its 64 q rows into bf16 hi and lo parts once
//   a work tile, into an A tile in shared memory (b_desc's layout): the A
//   operand of every S product of the tile. (Held in registers across the
//   key loop, as the A operand of wgmma's register form, q's lo part read
//   p's lo part of the tile before on the card: ptxas gave the two one
//   register set. Through shared memory every call matched the emulation.)
// - S = q_hi k_hi + (q_hi k_lo + q_lo k_hi): wgmma m64n64k16, A and B from
//   shared memory; the main product and the corrections have separate
//   accumulators, so the corrections are not rounded at the main sum's
//   scale.
// - Online softmax in fp32 registers: keys past N masked to -inf in the last
//   key tile, each row's running max and sum, upstream's scale 64^-0.5
//   folded into exp2 (ex2.approx).
// - P, in [0, 1], is split into bf16 hi and lo in registers, straight from
//   the S accumulators' layout into the A fragments' (FA3's register reuse),
//   made and consumed within the tile; O += p_hi v_hi + (p_hi v_lo + p_lo
//   v_hi), wgmma's register form, again two accumulators. (P through shared
//   memory gave the same bits and read 8 % slower.)
// - O / l is written once, fp32, rows past N not at all.
// Rows past N in the last query tile read row N - 1 and are dropped; a key
// tile never lies wholly past N, so every row's max is finite after the
// first tile, and any N >= 1 takes the same path.
//
// On one NVIDIA H100 80GB HBM3 at 700 W, B = 32, N = 1,190, one block's call:
// 1.05 ms (CUDA events), attention_kernel alone 0.85 and split_kv_kernel 0.16
// (2.9 TB/s), against 4.30 for SDPA's fp32 kernel and the count's bound of
// 0.141 (x3: 0.422): 13 % of the count's bound, 40 % of this design's.
// Tried without a gain, each in turns with this kernel in one call: P
// through shared memory as an A tile (+8 %); S_{j+1} issued beside O += P_j
// v_j with the softmax between their waits (ptxas serialised the groups,
// C7514 / C7515: 1.16 ms); the two warpgroups' products in turns on named
// barriers, P in shared memory (0.925 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mel_wgmma.cuh"

namespace attn {

using mel_wgmma::b_desc;
using mel_wgmma::bulk_copy;
using mel_wgmma::expect_bytes;
using mel_wgmma::fence_regs;
using mel_wgmma::mbar_init;
using mel_wgmma::mbar_wait;
using mel_wgmma::smem_addr;
using mel_wgmma::split;
using mel_wgmma::wgmma64;
using mel_wgmma::wgmma_commit;
using mel_wgmma::wgmma_fence;
using mel_wgmma::wgmma_wait;

constexpr int D = 64;                        // head width
constexpr int BM = 128;                      // query rows a work tile
constexpr int BN = 64;                       // keys a key tile
constexpr int PART = BN * D;                 // bf16 values of a part of a key tile
constexpr int PART_BYTES = 2 * PART;         // 8 KB
constexpr int PRODUCT_BYTES = 16 * D * 2;    // one k16 product's B tile: 2 KB
constexpr int KV_BYTES = 4 * PART_BYTES;     // k hi, k lo, v hi, v lo: 32 KB
constexpr int STAGES = 4;                    // ring slots
constexpr int Q_LD = D + 8;                  // floats a q row in shared memory
constexpr int Q_BYTES = BM * Q_LD * 4;       // the q buffer
constexpr int A_TILE_BYTES = 2 * PART_BYTES; // a warpgroup's A operand, hi and lo
constexpr int BARRIER_BYTES = 128;
constexpr int CONSUMER_WARPS = 8;
constexpr int THREADS = 32 * CONSUMER_WARPS + 128;  // and the producer's warpgroup
// registers a thread after setmaxnreg: 128 x 40 + 256 x 232 <= 65,536
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr size_t SMEM = BARRIER_BYTES + (size_t)STAGES * KV_BYTES + Q_BYTES + 2 * A_TILE_BYTES;
constexpr float NEG_INF = -__builtin_huge_valf();
// upstream's scale of the scores, D^-0.5 = 1/8, times log2 e for ex2
constexpr float SCALE_LOG2 = 0.125f * 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// 8 fp32 values -> their bf16 hi parts and lo parts, each 16 bytes in order
__device__ __forceinline__ void split8(const float (&x)[8], uint4& hi, uint4& lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t parts[2];
    split<2>(x[2 * i], x[2 * i + 1], parts);
    h[i] = parts[0];
    l[i] = parts[1];
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// One block a (key tile j, clip b x heads + head): its 64 keys of k and v,
// split into bf16 hi and lo and written as the 32 KB tile attention_kernel
// copies whole. In a part, the 16-byte unit i holds, for k, 8 d of one key:
// key 8 (i / 16 % 8) + i % 8, d 16 (i / 128) + 8 (i / 8 % 2), the order of
// b_desc's core matrices (k16 product i / 128, key group, d half, key); for
// v, 8 keys of one d: d 8 (i / 16 % 8) + i % 8, keys 16 (i / 128) + 8 (i / 8
// % 2) + 0..7.
__global__ void __launch_bounds__(256) split_kv_kernel(
    const float* __restrict__ k, long long kb, long long kh, long long kn,
    const float* __restrict__ v, long long vb, long long vh, long long vn, int H, int N,
    int n_kt, uint4* __restrict__ out) {
  __shared__ float vs[BN][D + 1];
  const int j = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int key0 = j * BN, tid = threadIdx.x;
  uint4* dst = out + ((size_t)bh * n_kt + j) * (KV_BYTES / 16);
  const float* kp = k + b * kb + h * kh;
  const float* vp = v + b * vb + h * vh;
  // v's tile into shared memory, a float4 a thread and step
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int c = tid + 256 * r, key = c / 16, d = 4 * (c % 16);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (key0 + key < N) x = __ldg(reinterpret_cast<const float4*>(vp + (key0 + key) * vn + d));
    vs[key][d] = x.x;
    vs[key][d + 1] = x.y;
    vs[key][d + 2] = x.z;
    vs[key][d + 3] = x.w;
  }
  // k: 512 units a part, two a thread
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = tid + 256 * r;
    const int key = 8 * (i / 16 % 8) + i % 8, d = 16 * (i / 128) + 8 * (i / 8 % 2);
    float x[8];
    if (key0 + key < N) {
      const float4* p = reinterpret_cast<const float4*>(kp + (key0 + key) * kn + d);
      const float4 a = __ldg(p), c = __ldg(p + 1);
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
      x[4] = c.x; x[5] = c.y; x[6] = c.z; x[7] = c.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    }
    split8(x, dst[i], dst[512 + i]);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = tid + 256 * r;
    const int d = 8 * (i / 16 % 8) + i % 8, key = 16 * (i / 128) + 8 * (i / 8 % 2);
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = vs[key + e][d];
    split8(x, dst[1024 + i], dst[1536 + i]);
  }
}

// wgmma m64n64k16 with A and B from shared memory (K-major, no swizzle)
__device__ __forceinline__ void wgmma64ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WGMMA_ACC8(d, 0), WGMMA_ACC8(d, 8), WGMMA_ACC8(d, 16), WGMMA_ACC8(d, 24)
      : "l"(a), "l"(b), "r"(1));
}

// the 128 threads of consumer warpgroup wg
__device__ __forceinline__ void bar_sync_wg(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// A fragments of a warpgroup's 64 x 64 operand, hi and lo ([part][k16
// product s][register r]: rows 16 w4 + g + 8 (r % 2), columns 16 s + 8 (r /
// 2) + 2t + {0, 1}), into its shared tile in the layout b_desc reads: part
// p at p PART_BYTES, product s at s PRODUCT_BYTES, element (m, k) at (m / 8)
// 256 + (k / 8) 128 + (m % 8) 16 + (k % 8) 2. A warp's 32 threads write 128
// consecutive bytes a register.
__device__ __forceinline__ void store_a(unsigned char* tile, const uint32_t (&a)[2][4][4],
                                        int w4, int g, int t) {
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<uint32_t*>(tile + p * PART_BYTES + s * PRODUCT_BYTES +
                                     (2 * w4 + r % 2) * 256 + (r / 2) * 128 + g * 16 + 4 * t) =
            a[p][s][r];
}

// S or O (64 x 64 a warpgroup) += A x B in bf16x3: acc += a_hi
// b_hi, corr += a_hi b_lo + a_lo b_hi, the four k16 products of a 64-deep
// product; the A and B tiles in shared memory, each lo part PART_BYTES after
// its hi part
__device__ __forceinline__ void product3(float (&acc)[32], float (&corr)[32], uint32_t a_hi,
                                         uint32_t b_hi) {
  uint64_t da[2][4], db[2][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      da[p][s] = b_desc(a_hi + p * PART_BYTES + s * PRODUCT_BYTES);
      db[p][s] = b_desc(b_hi + p * PART_BYTES + s * PRODUCT_BYTES);
    }
  fence_regs(acc);
  fence_regs(corr);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    wgmma64ss(acc, da[0][s], db[0][s]);
    wgmma64ss(corr, da[0][s], db[1][s]);
    wgmma64ss(corr, da[1][s], db[0][s]);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(corr);
}

// the same with A from registers
__device__ __forceinline__ void product3_rs(float (&acc)[32], float (&corr)[32],
                                            uint32_t (&a)[2][4][4], uint32_t b_hi) {
  uint64_t d[2][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int s = 0; s < 4; ++s) d[p][s] = b_desc(b_hi + p * PART_BYTES + s * PRODUCT_BYTES);
  fence_regs(a);
  fence_regs(acc);
  fence_regs(corr);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    wgmma64(acc, a[0][s], d[0][s]);
    wgmma64(corr, a[0][s], d[1][s]);
    wgmma64(corr, a[1][s], d[0][s]);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(corr);
  fence_regs(a);
}

// q: (B, H, N, 64) at element strides qb, qh, qn (d contiguous); kv:
// split_kv_kernel's tiles, n_kt a (clip, head); out: (B, N, H x 64). Work
// tile t is query rows 128 (t % n_qt) .. of (clip, head) t / n_qt.
__global__ void __launch_bounds__(THREADS, 1) attention_kernel(
    const float* __restrict__ q, long long qb, long long qh, long long qn,
    const unsigned char* __restrict__ kv, float* __restrict__ out, int H, int N, int n_qt,
    int n_kt, int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* kv_empty = kv_full + STAGES;
  uint64_t* q_full = kv_empty + STAGES;
  uint64_t* q_empty = q_full + 1;
  unsigned char* ring = smem + BARRIER_BYTES;
  float* qs = reinterpret_cast<float*>(ring + STAGES * KV_BYTES);  // [BM][Q_LD]
  // the consumers' A tiles of q, warpgroup 0's and 1's
  unsigned char* a_tiles = ring + STAGES * KV_BYTES + Q_BYTES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(kv_full + i, 1);
      mbar_init(kv_empty + i, CONSUMER_WARPS);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMER_WARPS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    // the producer: its warpgroup gives its registers to the consumers, and
    // its first warp alone copies; a slot or the q buffer is refilled once
    // every consumer warp has released it (the first round passes: parity 1
    // of a fresh barrier counts as done)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp != CONSUMER_WARPS) return;
    int kv_it = 0;
    for (int tile = blockIdx.x, it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
      const int bh = tile / n_qt, q0 = tile % n_qt * BM;
      mbar_wait(q_empty, (it & 1) ^ 1);
      if (lane == 0) expect_bytes(q_full, BM * D * 4);
      __syncwarp();
      const float* qp = q + bh / H * qb + bh % H * qh;
      for (int r = lane; r < BM; r += 32)
        bulk_copy(qs + r * Q_LD, qp + min(q0 + r, N - 1) * qn, D * 4, q_full);
      const unsigned char* src = kv + (size_t)bh * n_kt * KV_BYTES;
      for (int j = 0; j < n_kt; ++j, ++kv_it) {
        const int st = kv_it % STAGES;
        mbar_wait(kv_empty + st, ((kv_it / STAGES) & 1) ^ 1);
        if (lane == 0) {
          expect_bytes(kv_full + st, KV_BYTES);
          bulk_copy(ring + st * KV_BYTES, src + (size_t)j * KV_BYTES, KV_BYTES, kv_full + st);
        }
        __syncwarp();
      }
    }
    return;
  }

  // a consumer: warpgroup wg takes rows 64 wg .. of each work tile; this
  // thread rows r0 and r0 + 8 of them, and of its accumulators' 64 columns
  // 8i + 2t + {0, 1} (accumulator 4i + e: row r0 + 8 (e / 2), column 8i +
  // 2t + e % 2)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = warp / 4, w4 = warp % 4, g = lane / 4, t = lane % 4;
  const int r0 = 16 * w4 + g;
  unsigned char* qt = a_tiles + wg * A_TILE_BYTES;
  int kv_it = 0;
  for (int tile = blockIdx.x, it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
    const int bh = tile / n_qt, q0 = tile % n_qt * BM;
    // the warpgroup's 64 q rows, split into bf16 hi and lo, into its A tile
    mbar_wait(q_full, it & 1);
    {
      const float* row = qs + (64 * wg + r0) * Q_LD + 2 * t;
      uint32_t qa[2][4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 x =
              *reinterpret_cast<const float2*>(row + (r % 2) * 8 * Q_LD + 16 * s + 8 * (r / 2));
          uint32_t parts[2];
          split<2>(x.x, x.y, parts);
          qa[0][s][r] = parts[0];
          qa[1][s][r] = parts[1];
        }
      store_a(qt, qa, w4, g, t);
    }
    // the q buffer's reads are done before the copy engine refills it, and
    // the A tile's writes are seen by the tensor cores
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(q_empty);
    bar_sync_wg(wg);

    float om[32], oc[32], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 32; ++e) om[e] = oc[e] = 0.f;
    for (int j = 0; j < n_kt; ++j, ++kv_it) {
      const int st = kv_it % STAGES;
      mbar_wait(kv_full + st, (kv_it / STAGES) & 1);
      __syncwarp();  // the warp converged for the .aligned wgmma
      const uint32_t slot = smem_addr(ring + st * KV_BYTES);
      float sm[32], sc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sm[e] = sc[e] = 0.f;
      product3(sm, sc, smem_addr(qt), slot);
      float p[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) p[e] = sm[e] + sc[e];
      const int valid = N - j * BN;  // keys of the tile inside N
      if (valid < BN) {
#pragma unroll
        for (int e = 0; e < 32; ++e)
          if (8 * (e / 4) + 2 * t + e % 2 >= valid) p[e] = NEG_INF;
      }
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int e = 0; e < 32; ++e) mx[e / 2 % 2] = fmaxf(mx[e / 2 % 2], p[e]);
      float alpha[2], ms[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffff, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffff, mx[h], 2));
        const float mn = fmaxf(m[h], mx[h]);
        alpha[h] = ex2((m[h] - mn) * SCALE_LOG2);
        m[h] = mn;
        ms[h] = mn * SCALE_LOG2;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        p[e] = ex2(fmaf(p[e], SCALE_LOG2, -ms[e / 2 % 2]));
        l[e / 2 % 2] += p[e];
        om[e] *= alpha[e / 2 % 2];
        oc[e] *= alpha[e / 2 % 2];
      }
      // P's A fragments: register r of product s is accumulators 4i + e, 4i
      // + e + 1 with i = 2s + r / 2, e = 2 (r % 2)
      uint32_t pa[2][4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = 4 * (2 * s + r / 2) + 2 * (r % 2);
          uint32_t parts[2];
          split<2>(p[e], p[e + 1], parts);
          pa[0][s][r] = parts[0];
          pa[1][s][r] = parts[1];
        }
      product3_rs(om, oc, pa, slot + 2 * PART_BYTES);
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty + st);
    }

    // each row's sum over its quad, then O / l into (B, N, H x 64)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffff, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffff, l[h], 2);
      l[h] = 1.f / l[h];
    }
    const int b = bh / H, hd = bh % H;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = q0 + 64 * wg + r0 + 8 * h;
      if (n < N) {
        float* o = out + ((size_t)b * N + n) * (H * D) + hd * D + 2 * t;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          *reinterpret_cast<float2*>(o + 8 * i) =
              make_float2((om[4 * i + 2 * h] + oc[4 * i + 2 * h]) * l[h],
                          (om[4 * i + 2 * h + 1] + oc[4 * i + 2 * h + 1]) * l[h]);
      }
    }
  }
}

}  // namespace attn

namespace {

// k and v's views and the shape as split_kv_kernel takes them: rows 16-byte
// aligned, 1 to 65535 (clip, head) pairs, N >= 1
bool valid_kv(const float* k, const long long (&ks)[3], const float* v,
              const long long (&vs)[3], int B, int H, int N, const void* kv) {
  for (int i = 0; i < 3; ++i)
    if (ks[i] % 4 != 0 || vs[i] % 4 != 0) return false;
  return reinterpret_cast<uintptr_t>(k) % 16 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(kv) % 16 == 0 && B >= 1 && H >= 1 && N >= 1 &&
         (long long)B * H <= 65535;
}

cudaError_t launch_split_kv(const float* k, const long long (&ks)[3], const float* v,
                            const long long (&vs)[3], int B, int H, int N, void* kv,
                            cudaStream_t s) {
  const int n_kt = (N + attn::BN - 1) / attn::BN;
  attn::split_kv_kernel<<<dim3(n_kt, B * H), 256, 0, s>>>(
      k, ks[0], ks[1], ks[2], v, vs[0], vs[1], vs[2], H, N, n_kt, static_cast<uint4*>(kv));
  return cudaGetLastError();
}

}  // namespace

// k, v: (B, H, N, 64) fp32 views at element strides (b, h, n), d contiguous,
// each 16-byte aligned with strides multiples of 4; kv: B x H x ceil(N / 64)
// tiles of 32 KB, split_kv_kernel's output. Returns a cudaError_t.
extern "C" int eat_attention_split_kv(const float* k, long long kb, long long kh, long long kn,
                                      const float* v, long long vb, long long vh, long long vn,
                                      int B, int H, int N, void* kv, void* stream) {
  const long long ks[3] = {kb, kh, kn}, vs[3] = {vb, vh, vn};
  if (!valid_kv(k, ks, v, vs, B, H, N, kv)) return (int)cudaErrorInvalidValue;
  return (int)launch_split_kv(k, ks, v, vs, B, H, N, kv, static_cast<cudaStream_t>(stream));
}

// q as k and v; the head width D must be 64 (the scores' scale is upstream's
// 64^-0.5, SCALE_LOG2); kv scratch for split_kv_kernel's tiles; out (B, N, H x 64) fp32,
// contiguous; blocks the persistent grid (the SM count). Runs both kernels.
// Returns a cudaError_t.
extern "C" int eat_attention(const float* q, long long qb, long long qh, long long qn,
                             const float* k, long long kb, long long kh, long long kn,
                             const float* v, long long vb, long long vh, long long vn, int B,
                             int H, int N, int D, void* kv, float* out,
                             int blocks, void* stream) {
  using namespace attn;
  const long long ks[3] = {kb, kh, kn}, vs[3] = {vb, vh, vn};
  if (!valid_kv(k, ks, v, vs, B, H, N, kv) || D != attn::D || blocks < 1 || qb % 4 != 0 ||
      qh % 4 != 0 || qn % 4 != 0 || reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int n_kt = (N + BN - 1) / BN, n_qt = (N + BM - 1) / BM;
  const long long n_tiles = (long long)B * H * n_qt;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_split_kv(k, ks, v, vs, B, H, N, kv, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  attention_kernel<<<(int)(blocks < n_tiles ? blocks : n_tiles), THREADS, SMEM, s>>>(
      q, qb, qh, qn, static_cast<const unsigned char*>(kv), out, H, N, n_qt, n_kt,
      (int)n_tiles);
  return (int)cudaGetLastError();
}


extern "C" const char* eat_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
