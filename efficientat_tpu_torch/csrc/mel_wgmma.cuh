// The Hopper design of the fused log-mel at bf16x3 and fp32, CUDA C++ for
// sm_90a: one kernel body, mel_kernel_wgmma<WG, STAGED, PASSES, KC, MELS>, and
// its launch.
//
// Two libraries include this header and launch it:
//   K1, csrc/mel_kernel.cu::eat_mel_log_wgmma: bf16x3 (mel_kernel_wgmma<2,
//     false, 3, 128> at n_mels <= 128, <2, false, 3, 128, 256> at 129-256)
//     and fp32 (<2, false, 6, 128> and <2, false, 6, 128, 256>), in place of
//     the Pallas kernel efficientat_tpu/ops/mel_pallas.py::_mel_kernel at
//     bf16x3 and at Precision.HIGHEST (its DFT at :190-192); a wider bank
//     takes a launch for each group of 256 mels;
//   the probe variants P1-P3, csrc/mel_probe_kernel.cu, in place of the
//     Pallas kernels of scripts/probe_mel_kernel.py.
// For one clip and one tile of frames, in one kernel:
//   frame i is x[s, s + 1024) of its row, s = clamp(hop * i - lead, 0,
//   max_start): K1 reads the caller's raw wave in place (lead 512, max_start
//   the last multiple of 8 at or below S - 1024), the probe the rows of
//   ops/mel_kernel.py::_block_rows (lead 0: the raw wave behind a 512-sample
//   zero pad for the folded basis, or the pre-emphasised, reflect-padded
//   wave for the plain one); P2 reads them as they are, through its staged
//   segment. Split here into bf16 parts (part 0 = bf16(f),
//   part p the bf16 of what parts 0 .. p-1 leave): hi + lo, or hi + mid + lo
//   at 6 passes;
//   times the basis, split into as many bf16 parts by the wrapper (1024 x
//   1024: 512 cos columns, then 512 sin columns, no Nyquist bin), in PASSES:
//     3:  fh * bhi + (fh * blo + fl * bhi)   (the JAX package's bf16x3)
//     6:  fh * bhi + (the five products of parts i + j < 3 but hi * hi)
//         (fp32: the six passes the TPU runs for Precision.HIGHEST)
//     21: fh * bhi + fl * bhi    (frames exact, basis hi only; P3)
//     22: fh * bhi + fh * blo    (basis exact, frames hi only; P3)
//   -> power re^2 + im^2 -> times banks^T (512 x n_mels, n_mels <= MELS: 128
//   or 256) at fp32's precision (the TPU's Precision.HIGHEST, mel_pallas.py:197-198)
//   -> (log(x + 1e-5) + 4.5) / 5, written into rows 0 .. n_mels - 1 of each
//   clip's out_mels rows of the (B, out_mels, n_frames) output.
// The wrappers patch the few frames whose window reaches the reflect pad, as
// the JAX functions do (K1 with the mel_edges kernel, csrc/mel_edges.cuh):
// the clamp gives those frames a window of the wave that is not theirs, and
// every other frame the window a zero pad would, so the hot loop carries no
// predicate for the clip's ends.
//
// What bounds it, at B = 64 clips of 10 s and hop 320 (64,000 frames): the
// DFT product, 64,000 x 1024 x 1024 x 2 = 134.2 GFLOP a pass, 402.7 GFLOP for
// 3 passes, 0.41 ms at 989 TFLOP/s bf16; the mel product, 8.4 GFLOP, here 6
// bf16 passes on the tensor cores, 0.05 ms; 0.46 ms together (0.32 ms at 2
// DFT passes; 0.865 ms at fp32's 6, 805.3 GFLOP of DFT). The bytes (82 MB
// of wave, 33 MB of output) take 34 us at 3.35 TB/s, so the arithmetic
// bounds every variant. What held the first CUDA
// version (mma.sync, 4 warps on 64 frames, 2.6-2.7 ms) was traffic: every
// warp read the whole 4.2 MB basis (both parts) from L2 through L1 for
// every 64 frames, 16.8 GB a call (32 TB/s through L1 to meet the bound);
// every warp reloaded and re-split its frames for each of the 16 chunks,
// 4.2 GB of L1 reads; and the mel product ran between two barriers with the
// tensor cores idle.
//
// The design:
// - The basis comes through a ring of RING stages in shared memory (3 at 6
//   passes, ring_stages). The wrapper pre-tiles it
//   (ops/mel_kernel.py::_tiled_basis) so that a stage, KC samples x a
//   chunk's 64 columns (32 cos + the 32 matching sin) of a bf16 part, is
//   one contiguous block: one elected thread brings each part (two, or
//   three at 6 passes: a slot is 256 or 384 KC bytes) in with one
//   cp.async.bulk completed on the slot's mbarrier. A block covers 128
//   frames (two warpgroups), so the basis leaves L2 once per 128 frames:
//   2.1 GB a call at B = 64 (3.1 GB at 6 passes).
// - The DFT products are wgmma.mma_async m64n64k16 (bf16 in, fp32
//   accumulators): a warpgroup owns 64 frames, A comes from registers (its
//   frames, split into bf16 parts as they are loaded, a step ahead), B from
//   the ring stage through a matrix descriptor, so the four warps of a
//   warpgroup share one read of B: 6.3 GB of shared-memory reads a call at
//   3 passes. The tiles hold the canonical K-major layout without swizzle
//   (8 columns x 16 bytes a core matrix) with the samples of each k16 step
//   permuted as the A registers take them (_k_perm): a thread loads 8
//   consecutive samples of each of its two frame rows and fills both k16
//   products of a 32-sample step with no shuffle. The main product (hi x
//   hi) and the corrections have separate accumulators, so the corrections
//   are not rounded at the main sum's scale. A warpgroup keeps one wgmma
//   group in flight while it makes the next group's A fragments: a group is
//   a 32-sample step's two k16 products at 2 parts (3 wgmma each, 32 A
//   registers for two groups), but one k16 product at 6 passes (6 wgmma,
//   24 registers for two), so that fp32's third part fits beside the 128
//   accumulators: 254 registers, no spill (bf16x3's 230), where two k32
//   steps of three parts (48 A registers) spilled 104 bytes and read 2-4 %
//   slower.
// - The mel product runs on the tensor cores at fp32's precision, as the
//   TPU's Precision.HIGHEST does it: at a chunk's end the power, computed
//   in the DFT accumulators' registers, is split into three bf16 parts and
//   is the A operand of wgmma m64n128k16 against banks^T in three parts
//   (_tiled_banks), the six products of parts i + j < 3, smallest first
//   (what the other three add is 2^-24 of the sum or less). They sum into
//   the freed DFT accumulators, which are then added to the mel sums in
//   fp32, so the tensor cores' truncation acts at one chunk's scale, a few
//   times a chunk. The banks^T parts of a chunk pass through the same ring
//   slots as the basis, one to three stages after its basis stages. The
//   power never leaves the registers.
// - 256 mels (MELS 256): the mel wgmma's N is 128 and a warpgroup keeps its
//   64 frames x 128 mels of sums in registers (fp32 at 128 mels already
//   holds 254), so the power's parts go through the mel product twice, once
//   for each half of banks^T: mels 0-127 into the registers' sums as at
//   128, mels 128-255 added in fp32 to a tile of sums in shared memory, 64
//   frames x 128 mels a warpgroup (64 KB a block), laid out [sum][thread]
//   so that the read-modify-write is conflict-free (2 MB of shared-memory
//   traffic a block at B = 64, beside some 8 MB of basis reads). A chunk's
//   banks^T is two halves of three 8 KB parts: two ring stages at two basis
//   parts a slot, one at three. Everything else (the 128-frame blocks, the
//   DFT loop, the ring and its basis traffic) is the 128-mel kernel's. The
//   DFT loop there needs a few registers more than at 128 mels, so the
//   write-out's coordinates are made afresh after it (fresh_sreg), where
//   held across it they spilled 24 bytes at fp32: 228 registers at bf16x3
//   and 254 at fp32, no spill. The kernel alone at B = 64 and 256 mels:
//   1.04-1.08 ms at bf16x3 and 1.51-1.54 at fp32, against 2.53-2.54 and
//   3.41-3.56 for mel_kernel_tc<64, 2 | 3> (mma.sync, 64-frame blocks, the
//   mel product as fp32 FMAs on the CUDA cores), which it replaced
//   (tools/time_k1.py in turns, one NVIDIA H100 80GB HBM3 at 700 W;
//   PERF.md section 6).
// - P2 (the TPU's DMA frame assembly): the copy engine brings each
//   sub-tile's wave segment ((frames - 1) hop + 1024 fp32) into shared
//   memory with one bulk copy, and the A fragments are read from there: 128
//   frames (two warpgroups) up to hop 320, else 64 (one); plan().
//
// The steps, P1 folded_t128 at B = 64 (ms on one NVIDIA H100 80GB HBM3 at
// 700 W, tools/probe_mel_kernel.py, each beside the first version and K1
// bf16x3 in the same call; PERF.md section 6):
//   the first version (mma.sync, 64-frame blocks)        2.61-2.86
//   (a) the bulk-copy ring, 128-frame blocks, mma.sync,
//       mel on the CUDA cores with banks read through L1   4.01-4.03
//   (b) the same with wgmma                                3.51-3.64
//       + banks^T rows in the ring slots, 16-byte reads    1.64-1.75
//       + the mel product on the tensor cores, bf16x3      1.21-1.48
//       + that product at fp32's precision (landed)        1.24-1.59
//   K1 bf16x3 then (mel_kernel_tc<128, 2>, mma.sync)       2.02-2.24
// K1 fp32 (6 passes) on this kernel, the wrapper call at B = 64 with the
// banks tiled once: 1.59-1.65 ms against 2.98-3.10 for mel_kernel_tc<128,
// 3> (mma.sync, the six products' first tensor-core kernel) in the same
// call; the kernel alone 1.34-1.35 against 2.74 (tools/time_k1.py).
// The bf16x3 mel product (a two-part split, three products) was off by
// 2^-16 of the mel sums; at six products the landed kernel reads 1.24-1.59
// ms against 1.30-1.43 for the bf16x3 one in the same calls, a gap within
// the spread of either (the same kernel as P3 read 1.50-1.53 against
// 1.49-1.54).
// Without the mel product step (b) read 1.31 ms: the CUDA-core mel product,
// its banks loaded through L1 a float at a time, cost more than the DFT.
// Tried without a gain: a ring of 3, 5 or 6 stages (6 spills at KC 128), KC
// 64 (more L1 for the frames), an L1 prefetch of the frames 2-8 steps ahead,
// one wgmma.fence a stage, two P2 segment buffers (KC 32 to fit at hop 320:
// 2.70-2.77 ms against 2.00-2.15 with one, both at 64-frame blocks).
//
// frame_tile is the number of frames a block covers, rounded up to the
// block's frames (128, or 64 for P2 past hop 320): the block loops over
// them, as the TPU's sequential grid axis did, and masks frames past the
// clip. K1 launches one 128-frame sub-tile a block, so that a B = 64 call
// has 512 blocks for the 132 SMs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mel_wgmma {

constexpr int N_FFT = 1024;
constexpr int N_BINS = 512;            // rDFT bins kept (the Nyquist bin is dropped)
constexpr int NB = 32;                 // bins a chunk: NB cos + NB sin columns
constexpr int N_CHUNKS = N_BINS / NB;
constexpr int COLS = 2 * NB;           // the DFT wgmma's N
constexpr int TF = 64;                 // frames a warpgroup: the wgmma's M
constexpr int PRODUCT = COLS * 16;     // bf16 values of one k16 product of a chunk
constexpr int CHUNK = N_FFT / 16 * PRODUCT;  // bf16 values of a chunk's tiles
constexpr int MAX_MELS = 128;          // the mel wgmma's N: mels a half of banks^T
constexpr int MEL_SPLIT = 3;           // bf16 parts of the power and of banks^T
constexpr int MEL_PART = NB * MAX_MELS;      // bf16 values of a chunk's banks^T tiles, a part
constexpr int MEL_PART_BYTES = 2 * MEL_PART;
constexpr int RING = 4;                // ring stages at two basis parts a slot
constexpr int BARRIER_BYTES = 128;     // the ring's and the segment's mbarriers
constexpr size_t MAX_SMEM = 232448;    // 227 KB, a block's most on sm_90

// The shared-memory plan of a launch (ops/mel_probe.py::smem_plan mirrors
// it): `wg` warpgroups of 64 frames a block and a ring of ring_stages
// slots of KC samples (the chunk's 64 columns of each of `parts` basis
// parts, 128 KC bytes a part: 2 parts, or 3 at 6 passes; the chunk's
// banks^T tiles pass through the same slots), the sums of mels 128-255 at
// `mels` 256 (32 KB a warpgroup), and P2's segment of the block's frames.
// K1, P1 and P3 take P1_PLAN; P2 the first of P2_PLANS that fits: two
// warpgroups while their segment fits (hop <= 320), else one.
constexpr int P1_PLAN[2] = {2, 128};  // warpgroups, KC
constexpr int P2_PLANS[3][2] = {{2, 64}, {1, 64}, {1, 32}};
struct Plan {
  int wg, kc;
  size_t bytes;
};

// the basis parts a ring slot holds at PASSES, and the ring's stages at
// `parts` a slot: RING, but 3 at three parts, where 4 x 48 KB read 1.3 %
// slower (the kernel alone at B = 64 and 120, PERF.md section 6)
__host__ __device__ constexpr int slot_parts(int passes) { return passes == 6 ? 3 : 2; }
__host__ __device__ constexpr int ring_stages(int parts) { return parts == 3 ? 3 : RING; }

// the bytes of the shared-memory sums of mels MAX_MELS .. mels - 1, for `wg`
// warpgroups
__host__ __device__ constexpr size_t mel_sum_bytes(int mels, int wg) {
  return sizeof(float) * (size_t)(mels - MAX_MELS) * TF * wg;
}

inline size_t plan_bytes(bool staged, int hop, int parts, int mels, const int (&c)[2]) {
  const size_t seg = staged ? sizeof(float) * ((size_t)(TF * c[0] - 1) * hop + N_FFT) : 0;
  return BARRIER_BYTES + (size_t)ring_stages(parts) * 128 * parts * c[1] +
         mel_sum_bytes(mels, c[0]) + seg;
}

inline Plan plan(bool staged, int hop, int parts, int mels = MAX_MELS) {
  if (!staged) return {P1_PLAN[0], P1_PLAN[1], plan_bytes(false, hop, parts, mels, P1_PLAN)};
  for (const auto& c : P2_PLANS) {
    const size_t bytes = plan_bytes(true, hop, parts, mels, c);
    if (bytes <= MAX_SMEM) return {c[0], c[1], bytes};
  }
  return {0, 0, 0};
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// one bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// into shared memory, completed on `bar`, which was told to expect it
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void expect_bytes(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// A descriptor of one k16 product's B tile in shared memory: K-major, no
// swizzle, core matrices of 8 columns x 16 bytes; the two k halves 128
// bytes apart (leading byte offset), the 8-column groups 256 bytes apart
// (stride byte offset)
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// %tid.x (R 0), %ctaid.x (1) or %ctaid.y (2), read where it is used: an
// asm volatile is not hoisted, so what is made from it holds no register
// across the loops before
template <int R>
__device__ __forceinline__ int fresh_sreg() {
  int v;
  if constexpr (R == 0) {
    asm volatile("mov.u32 %0, %%tid.x;" : "=r"(v));
  } else if constexpr (R == 1) {
    asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(v));
  } else {
    asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(v));
  }
  return v;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of this warpgroup's wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep registers an asynchronous wgmma reads or writes where they are
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int P, int G>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[P][G][4]) {
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int s = 0; s < G; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[p][s][i])::"memory");
}

#define WGMMA_ACC8(d, i)                                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64, fp32) += A (64 x 16, bf16, registers) x B (16 x 64, bf16,
// shared memory): accumulator 4i + e of a thread is row 16 (warp % 4) + g +
// 8 (e / 2), column 8i + 2t + e % 2
__device__ __forceinline__ void wgmma64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : WGMMA_ACC8(d, 0), WGMMA_ACC8(d, 8), WGMMA_ACC8(d, 16), WGMMA_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// the same at N = 128, columns 0-63 in d0 and 64-127 in d1: accumulator
// 4j + e is row 16 (warp % 4) + g + 8 (e / 2), column 64h + 8j + 2t + e % 2
// of dh
__device__ __forceinline__ void wgmma128(float (&d0)[32], float (&d1)[32], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : WGMMA_ACC8(d0, 0), WGMMA_ACC8(d0, 8), WGMMA_ACC8(d0, 16), WGMMA_ACC8(d0, 24),
        WGMMA_ACC8(d1, 0), WGMMA_ACC8(d1, 8), WGMMA_ACC8(d1, 16), WGMMA_ACC8(d1, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// (a, b) -> P bf16x2 parts: part 0 = (bf16(a), bf16(b)), part p the bf16 of
// what parts 0 .. p-1 leave (each difference exact in fp32)
template <int P>
__device__ __forceinline__ void split(float a, float b, uint32_t* parts) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(h);
    a -= hf.x;
    b -= hf.y;
    parts[p] = *reinterpret_cast<const uint32_t*>(&h);
  }
}

template <bool STAGED>
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  float4 a, b;
  if (STAGED) {  // shared memory
    a = reinterpret_cast<const float4*>(p)[0];
    b = reinterpret_cast<const float4*>(p)[1];
  } else {       // device memory, read-only
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// A fragments of 8 consecutive samples of each of rows g and g + 8, in P
// bf16 parts: [part][k16 product][register]. Product s0 + s of the step
// takes the four from 4 (s0 + s): its registers 0/2 (k pairs 2t and 2t + 8)
// hold samples 4 (s0 + s) + {0, 1} / {2, 3}, rows g (0, 2) and g + 8 (1, 3):
// the order _tiled_basis gives the basis rows. G is 2 (the step's two
// products) or 1 (product s0 alone)
template <int P, int G>
__device__ __forceinline__ void split_group(const float (&v0)[8], const float (&v1)[8], int s0,
                                            uint32_t (&a)[P][G][4]) {
#pragma unroll
  for (int s = 0; s < G; ++s) {
    const int v = 4 * (s0 + s);
    uint32_t parts[4][P];
    split<P>(v0[v], v0[v + 1], parts[0]);
    split<P>(v1[v], v1[v + 1], parts[1]);
    split<P>(v0[v + 2], v0[v + 3], parts[2]);
    split<P>(v1[v + 2], v1[v + 3], parts[3]);
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int r = 0; r < 4; ++r) a[p][s][r] = parts[r][p];
  }
}

// the DFT's k16 products k0 .. k0 + G - 1 of a stage, committed as one
// wgmma group: st is the stage's part 0 in shared memory, part j j * KC *
// COLS values after it; product k0 + s takes A group s. At 6 passes the
// five corrections go smallest first: lo * hi, mid * mid, hi * lo (2^-16
// of the main product), then mid * hi, hi * mid (2^-8)
template <int PASSES, int KC, int P, int G>
__device__ __forceinline__ void group_products(float (&cm)[32], float (&cc)[32],
                                               uint32_t (&a)[P][G][4], uint32_t st, int k0) {
  constexpr int BP = slot_parts(PASSES);
  // the descriptors are made before the fence: a register a wgmma reads,
  // defined between the fence and the commit, makes ptxas serialise the group
  uint64_t d[BP][G];
#pragma unroll
  for (int j = 0; j < BP; ++j)
#pragma unroll
    for (int s = 0; s < G; ++s) d[j][s] = b_desc(st + 2 * ((k0 + s) * PRODUCT + j * KC * COLS));
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < G; ++s) {
    wgmma64(cm, a[0][s], d[0][s]);
    if constexpr (PASSES == 6) {
      wgmma64(cc, a[2][s], d[0][s]);
      wgmma64(cc, a[1][s], d[1][s]);
      wgmma64(cc, a[0][s], d[2][s]);
      wgmma64(cc, a[1][s], d[0][s]);
      wgmma64(cc, a[0][s], d[1][s]);
    } else {
      if (PASSES != 21) wgmma64(cc, a[0][s], d[1][s]);
      if (PASSES != 22) wgmma64(cc, a[1][s], d[0][s]);
    }
  }
  wgmma_commit();
}

// A fragments of a chunk's power (64 frames x its 32 bins), split into
// MEL_SPLIT bf16 parts: [part][k16 product][register]. The power of bin 8i
// + 2t + e % 2 is re^2 + im^2 of the DFT accumulators 4i + e (cos) and 4 (i
// + 4) + e (sin), which is where k16 product s of an A fragment wants bins
// 16s + 2t + {0, 1} (registers 0/1, i = 2s) and 16s + 8 + 2t + {0, 1}
// (registers 2/3, i = 2s + 1): the power never leaves the registers
__device__ __forceinline__ void power_frags(const float (&cm)[32], const float (&cc)[32],
                                            uint32_t (&pa)[MEL_SPLIT][2][4]) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // register r: rows g (r = 0, 2) or g + 8 (1, 3), k half r / 2
      const int i = 2 * s + r / 2, e = 2 * (r % 2);
      float pw[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float re = cm[4 * i + e + h] + cc[4 * i + e + h];
        const float im = cm[4 * (i + 4) + e + h] + cc[4 * (i + 4) + e + h];
        pw[h] = re * re + im * im;
      }
      uint32_t parts[MEL_SPLIT];
      split<MEL_SPLIT>(pw[0], pw[1], parts);
#pragma unroll
      for (int p = 0; p < MEL_SPLIT; ++p) pa[p][s][r] = parts[p];
    }
}

// One ring stage of the mel product, as the TPU's Precision.HIGHEST does it:
// d0|d1 (the chunk's 64 frames x 128 mels) += power x banks^T, both in
// MEL_SPLIT = 3 bf16 parts, the six products of parts i + j < 3 (what the
// others add is 2^-24 of the sum or less). The stage holds banks^T parts
// [lo, hi) (_tiled_banks, 8 KB each, part lo at st); the smallest products
// go first, so they are not truncated at the main product's scale
template <int LO, int HI>
__device__ __forceinline__ void mel_stage(float (&d0)[32], float (&d1)[32],
                                          uint32_t (&pa)[MEL_SPLIT][2][4], uint32_t st) {
  uint64_t desc[HI - LO][2];
#pragma unroll
  for (int j = LO; j < HI; ++j)
#pragma unroll
    for (int s = 0; s < 2; ++s)
      desc[j - LO][s] = b_desc(st + (j - LO) * MEL_PART_BYTES + 2 * s * 16 * MAX_MELS);
  fence_regs(d0);
  fence_regs(d1);
  wgmma_fence();
#pragma unroll
  for (int j = HI - 1; j >= LO; --j)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int i = MEL_SPLIT - 1 - j; i >= 0; --i) wgmma128(d0, d1, pa[i][s], desc[j - LO][s]);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d0);
  fence_regs(d1);
  fence_regs(pa);
}

// WG warpgroups of 64 frames a block; STAGED: P2's segment in shared memory;
// KC samples a ring stage; MELS: the most mels, 128 or 256 (unstaged, KC 128)
template <int WG, bool STAGED, int PASSES, int KC, int MELS = MAX_MELS>
__global__ void __launch_bounds__(128 * WG, 1)
mel_kernel_wgmma(const float* __restrict__ x, int row_len, int hop, int n_frames, int tile,
             const __nv_bfloat16* __restrict__ b0,   // _tiled_basis, part 0
             const __nv_bfloat16* __restrict__ b1,   // part 1
             const __nv_bfloat16* __restrict__ b2,   // part 2 (6 passes)
             const __nv_bfloat16* __restrict__ mel,  // _tiled_banks: per chunk, halves x parts
             int n_mels, float* __restrict__ out,    // (B, out_mels, n_frames)
             int out_mels, int lead, int max_start) { // the unstaged frames' window
  constexpr int BF = TF * WG;             // frames a block computes at a time
  constexpr int A_PARTS = slot_parts(PASSES);  // bf16 parts of the frames
  constexpr int PARTS = PASSES == 21 ? 1 : A_PARTS;  // basis parts a stage brings in
  constexpr int G = A_PARTS == 3 ? 1 : 2; // k16 products a wgmma group
  constexpr int GROUPS = KC / 16 / G;  // wgmma groups a stage
  constexpr int K_ST = N_FFT / KC;        // basis stages a chunk
  constexpr int PART_BYTES = 2 * KC * COLS;   // a basis part of a stage
  constexpr int SLOT_BYTES = A_PARTS * PART_BYTES;
  constexpr int STAGES = ring_stages(A_PARTS);  // ring slots
  constexpr int PER_SLOT = SLOT_BYTES / MEL_PART_BYTES;  // banks^T parts a slot
  constexpr int HALVES = MELS / MAX_MELS;  // halves of banks^T, MEL_SPLIT parts each
  constexpr int HALF_SLOT = PER_SLOT / MEL_SPLIT;  // whole halves a slot
  // banks^T stages a chunk: its parts, PER_SLOT a stage, or its halves
  constexpr int M_ST = HALVES == 1 ? (MEL_SPLIT + PER_SLOT - 1) / PER_SLOT : HALVES / HALF_SLOT;
  constexpr int SPC = K_ST + M_ST;        // ring stages a chunk
  static_assert(PER_SLOT >= 1 && M_ST <= 3, "a slot holds a banks^T part");
  static_assert(HALVES == 1 || (HALVES == 2 && !STAGED && HALF_SLOT >= 1 &&
                                HALVES % HALF_SLOT == 0),
                "256 mels: unstaged, a slot holds a half of banks^T");
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);          // [STAGES]
  uint64_t* seg_full = full + STAGES;
  unsigned char* slots = smem + BARRIER_BYTES;                 // [STAGES][SLOT_BYTES]
  // the sums of mels 128-255 at MELS 256: [sum 4j + e][thread]
  float* msum = reinterpret_cast<float*>(slots + STAGES * SLOT_BYTES);
  float* seg = msum + mel_sum_bytes(MELS, WG) / sizeof(float);  // P2's segment
  const int seg_len = STAGED ? (BF - 1) * hop + N_FFT : 0;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;   // fragment row group and column pair
  const int r0 = 16 * warp + g;           // this thread's fragment rows r0, r0 + 8 of the block
  const int b = blockIdx.y;
  const float* xb = x + (size_t)b * row_len;
  float* o = out + (size_t)b * out_mels * n_frames;
  const int tile0 = blockIdx.x * tile;
  const int tile_end = min(n_frames, tile0 + tile);
  const int n_sub = (tile_end - tile0 + BF - 1) / BF;
  const int total = n_sub * N_CHUNKS * SPC;

  // stage q of the walk into slot q % STAGES: of chunk q / SPC of its
  // sub-tile, K_ST basis stages (samples j KC .. of each part), then M_ST
  // of banks^T parts, the last parts first (at 256 mels, HALF_SLOT halves
  // of three parts a stage, the first half first); the segment of sub-tile u
  auto issue_stage = [&](int q) {
    const int j = q % SPC, c = q / SPC % N_CHUNKS;
    unsigned char* dst = slots + q % STAGES * SLOT_BYTES;
    uint64_t* bar = full + q % STAGES;
    if (j < K_ST) {
      const size_t off = (size_t)c * CHUNK + (size_t)j * KC / 16 * PRODUCT;
      expect_bytes(bar, PARTS * PART_BYTES);
      bulk_copy(dst, b0 + off, PART_BYTES, bar);
      if (PARTS >= 2) bulk_copy(dst + PART_BYTES, b1 + off, PART_BYTES, bar);
      if (PARTS == 3) bulk_copy(dst + 2 * PART_BYTES, b2 + off, PART_BYTES, bar);
    } else if constexpr (HALVES == 2) {
      const int bytes = HALF_SLOT * MEL_SPLIT * MEL_PART_BYTES;
      expect_bytes(bar, bytes);
      bulk_copy(dst, mel + (size_t)(c * HALVES + (j - K_ST) * HALF_SLOT) * MEL_SPLIT * MEL_PART,
                bytes, bar);
    } else {
      const int hi = MEL_SPLIT - (j - K_ST) * PER_SLOT, lo = max(0, hi - PER_SLOT);
      expect_bytes(bar, (hi - lo) * MEL_PART_BYTES);
      bulk_copy(dst, mel + (size_t)(c * MEL_SPLIT + lo) * MEL_PART, (hi - lo) * MEL_PART_BYTES,
                bar);
    }
  };
  auto issue_segment = [&](int u) {
    const int bytes = (int)sizeof(float) * seg_len;
    expect_bytes(seg_full, bytes);
    bulk_copy(seg, xb + (size_t)hop * (tile0 + u * BF), bytes, seg_full);
  };
  // the stage's slot, once its copy has landed; the copy of stage q + STAGES
  // - 2 starts now, once every thread has passed this barrier: its slot's
  // last reader, stage q - 2, ended its wgmma groups by then (a thread keeps
  // one group in flight past a basis stage, none past a banks^T stage)
  auto next_stage = [&](int q) {
    __syncthreads();
    if (tid == 0 && q + STAGES - 2 < total) issue_stage(q + STAGES - 2);
    __syncwarp();
    mbar_wait(full + q % STAGES, (q / STAGES) & 1);
    return smem_addr(slots + q % STAGES * SLOT_BYTES);
  };

  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) mbar_init(full + i, 1);  // and seg_full
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int q = 0; q < min(STAGES - 2, total); ++q) issue_stage(q);
    if (STAGED) issue_segment(0);
  }
  __syncthreads();

  // the mel sums of the warpgroup's 64 frames x 128 mels; main (hi * hi)
  // and correction sums of its 64 frames x the chunk's 64 columns, which
  // then take the chunk's mel sums
  float macc[64], cm[32], cc[32];
#pragma unroll
  for (int e = 0; e < 64; ++e) macc[e] = 0.f;
  if constexpr (HALVES == 2) {
#pragma unroll
    for (int e = 0; e < 64; ++e) msum[e * 128 * WG + tid] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) cm[e] = cc[e] = 0.f;
  // the A fragments of two wgmma groups: group n's in a[n % 2], read by its
  // wgmma group while the next group's are made
  uint32_t a[2][A_PARTS][G][4];

  int q = 0;
  for (int u = 0; u < n_sub; ++u) {
    const int f0 = tile0 + u * BF;
    const float* row0;
    const float* row1;
    if (STAGED) {
      mbar_wait(seg_full, u & 1);
      row0 = seg + (size_t)hop * r0 + 8 * t;
      row1 = row0 + (size_t)hop * 8;
    } else {
      // frame f at clamp(hop f - lead, 0, max_start): a frame whose window
      // leaves the row (an edge frame, or one past the clip, never written)
      // reads one inside it
      row0 = xb + min(max(hop * (f0 + r0) - lead, 0), max_start) + 8 * t;
      row1 = xb + min(max(hop * (f0 + r0 + 8) - lead, 0), max_start) + 8 * t;
    }
    // samples 8t .. 8t + 7 of the next k32 step, both rows, loaded a step
    // ahead
    float v0[8], v1[8];
    load8<STAGED>(row0, v0);
    load8<STAGED>(row1, v1);

    for (int chunk = 0; chunk < N_CHUNKS; ++chunk) {
      for (int ks = 0; ks < K_ST; ++ks, ++q) {
        const uint32_t st = next_stage(q);
#pragma unroll
        for (int n = 0; n < GROUPS; ++n) {
          // products n G .. n G + G - 1 of the stage: of k32 step n G / 2
          const int s0 = n * G % 2;
          split_group(v0, v1, s0, a[n % 2]);
          group_products<PASSES, KC>(cm, cc, a[n % 2], st, n * G);
          if (s0 + G == 2) {  // the step's last group: load the next step
            const int k_next = (ks * KC + n * G / 2 * 32 + 32) % N_FFT;
            load8<STAGED>(row0 + k_next, v0);
            load8<STAGED>(row1 + k_next, v1);
          }
          // the previous group is done: its A registers are free
          wgmma_wait<1>();
          fence_regs(a[(n + 1) % 2]);
        }
        if (GROUPS % 2) {  // the next stage's first group refills a[0]
          wgmma_wait<0>();
          fence_regs(a[0]);
        }
      }
      // the chunk's power, from its accumulators, times its banks^T tiles
      // into cm|cc, which are then added to the mel sums in fp32
      wgmma_wait<0>();
      fence_regs(cm);
      fence_regs(cc);
      fence_regs(a[0]);
      fence_regs(a[1]);
      uint32_t pa[MEL_SPLIT][2][4];
      power_frags(cm, cc, pa);
#pragma unroll
      for (int e = 0; e < 32; ++e) cm[e] = cc[e] = 0.f;
      if constexpr (HALVES == 2) {
        // mels 0-127 into the registers' sums, then 128-255 into shared
        // memory's, from the next stage (HALF_SLOT 1) or the same one
        uint32_t st = next_stage(q++);
        mel_stage<0, 3>(cm, cc, pa, st);
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          macc[e] += cm[e];
          macc[32 + e] += cc[e];
          cm[e] = cc[e] = 0.f;
        }
        if constexpr (HALF_SLOT == 1) {
          st = next_stage(q++);
        } else {
          st += MEL_SPLIT * MEL_PART_BYTES;
        }
        mel_stage<0, 3>(cm, cc, pa, st);
        const int id = fresh_sreg<0>();
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          msum[e * 128 * WG + id] += cm[e];
          msum[(32 + e) * 128 * WG + id] += cc[e];
          cm[e] = cc[e] = 0.f;
        }
      } else {
        // PER_SLOT is 4 or 6 (KC 128), 2 or 3 (KC 64) or 1 (KC 32)
        if constexpr (PER_SLOT >= MEL_SPLIT) {
          mel_stage<0, 3>(cm, cc, pa, next_stage(q++));
        } else if constexpr (PER_SLOT == 2) {
          mel_stage<1, 3>(cm, cc, pa, next_stage(q++));
          mel_stage<0, 1>(cm, cc, pa, next_stage(q++));
        } else {
          mel_stage<2, 3>(cm, cc, pa, next_stage(q++));
          mel_stage<1, 2>(cm, cc, pa, next_stage(q++));
          mel_stage<0, 1>(cm, cc, pa, next_stage(q++));
        }
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          macc[e] += cm[e];
          macc[32 + e] += cc[e];
          cm[e] = cc[e] = 0.f;
        }
      }
    }

    // the write-out's coordinates; at 256 mels made afresh from the special
    // registers (fresh_sreg): the DFT loop there needs a few registers more
    // than at 128 mels, and these, held across it, spilled 24 bytes
    const int wid = HALVES == 2 ? fresh_sreg<0>() : tid;
    const int wr0 = HALVES == 2 ? 16 * (wid / 32) + wid % 32 / 4 : r0;
    const int wt = HALVES == 2 ? wid % 4 : t;
    const int wf0 = HALVES == 2 ? fresh_sreg<1>() * tile + u * BF : f0;
    const int wend = HALVES == 2 ? min(n_frames, fresh_sreg<1>() * tile + tile) : tile_end;
    float* wo = HALVES == 2 ? out + (size_t)fresh_sreg<2>() * out_mels * n_frames : o;
    // mel sum 4j + e: frame r0 + 8 (e / 2), mel 8j + 2t + e % 2 (and 128 +
    // that of shared memory's, at 256 mels)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = wf0 + wr0 + 8 * (e / 2), m = 8 * j + 2 * wt + e % 2;
        if (f < wend && m < n_mels)
          wo[(size_t)m * n_frames + f] = (logf(macc[4 * j + e] + 1e-5f) + 4.5f) / 5.0f;
        macc[4 * j + e] = 0.f;
        if constexpr (HALVES == 2) {
          float& s = msum[(4 * j + e) * 128 * WG + wid];
          if (f < wend && MAX_MELS + m < n_mels)
            wo[(size_t)(MAX_MELS + m) * n_frames + f] = (logf(s + 1e-5f) + 4.5f) / 5.0f;
          s = 0.f;
        }
      }
    // every thread is done with this sub-tile's segment: the copy engine
    // refills it with the next sub-tile's
    __syncthreads();
    if (STAGED && tid == 0 && u + 1 < n_sub) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue_segment(u + 1);
    }
  }
}

template <int WG, bool STAGED, int PASSES, int KC, int MELS>
cudaError_t launch_kc(const float* x, int B, int row_len, int hop, int n_frames, int tile,
                      int lead, int max_start, const void* b0, const void* b1,
                      const void* b2, const void* mel, int n_mels, int out_mels, float* out,
                      const Plan& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(mel_kernel_wgmma<WG, STAGED, PASSES, KC, MELS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_frames + tile - 1) / tile, B);
  mel_kernel_wgmma<WG, STAGED, PASSES, KC, MELS><<<grid, 128 * WG, p.bytes, stream>>>(
      x, row_len, hop, n_frames, tile, static_cast<const __nv_bfloat16*>(b0),
      static_cast<const __nv_bfloat16*>(b1), static_cast<const __nv_bfloat16*>(b2),
      static_cast<const __nv_bfloat16*>(mel), n_mels, out, out_mels, lead, max_start);
  return cudaGetLastError();
}

// K1, P1 and P3 (P1_PLAN) or P2 (STAGED, by its plan): x (B, row_len) f32,
// frame i at x[:, clamp(hop * i - lead, 0, max_start)] (unstaged) or at
// x[:, hop * i] (P2); b0, b1 (and b2 at 6 passes, else unread) the basis
// parts pre-tiled by ops/mel_kernel.py::_tiled_basis (16 x 64 x 1024 bf16
// each); mel the banks^T split into three bf16 parts and tiled by
// _tiled_banks at MELS mels (16 chunks x MELS / 128 halves x 3 parts x 32 x
// 128 bf16, zero past n_mels); out the first n_mels rows of each clip's
// out_mels rows of a (B, out_mels, n_frames) f32 output. All contiguous on
// the device, 16-byte aligned rows (row_len a multiple of 4). Unstaged:
// lead and max_start multiples of 8 (16-byte aligned frames), and every
// window [s, s + 1024) inside the row. P2: rows holding every frame of the
// last 128-frame sub-tile (lead and max_start unread). MELS 256 is
// unstaged.
template <bool STAGED, int PASSES, int MELS = MAX_MELS>
cudaError_t launch(const float* x, int B, int row_len, int hop, int n_frames,
                   int frame_tile, int lead, int max_start, const void* b0, const void* b1,
                   const void* b2, const void* mel, int n_mels, int out_mels, float* out,
                   void* stream) {
  static_assert(MELS == MAX_MELS || (MELS == 2 * MAX_MELS && !STAGED), "128 or 256 mels");
  if (B < 1 || B > 65535 || n_frames < 1 || n_mels < 1 || n_mels > MELS ||
      out_mels < n_mels || hop < 64 || hop % 64 != 0 || frame_tile < TF ||
      frame_tile % TF != 0 || row_len % 4 != 0)
    return cudaErrorInvalidValue;
  if (STAGED) {
    // every frame of every 128-frame sub-tile that runs lies inside the row
    const long long sub_frames = (long long)(n_frames + 2 * TF - 1) / (2 * TF) * (2 * TF);
    if ((long long)hop * (sub_frames - 1) + N_FFT > row_len) return cudaErrorInvalidValue;
  } else if (lead < 0 || lead % 8 != 0 || max_start < 0 || max_start % 8 != 0 ||
             (long long)max_start + N_FFT > row_len ||
             (long long)hop * (n_frames + 2 * TF) > 0x7fffffff) {
    return cudaErrorInvalidValue;
  }
  const Plan p = plan(STAGED, hop, slot_parts(PASSES), MELS);
  if (p.bytes == 0) return cudaErrorInvalidValue;
  const int bf = TF * p.wg;
  const int tile = (frame_tile + bf - 1) / bf * bf;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (!STAGED) {
    return launch_kc<P1_PLAN[0], false, PASSES, P1_PLAN[1], MELS>(
        x, B, row_len, hop, n_frames, tile, lead, max_start, b0, b1, b2, mel, n_mels,
        out_mels, out, p, s);
  } else {
    if (p.wg == 2)
      return launch_kc<2, true, PASSES, 64, MELS>(x, B, row_len, hop, n_frames, tile, 0, 0, b0,
                                                  b1, b2, mel, n_mels, out_mels, out, p, s);
    if (p.kc == 64)
      return launch_kc<1, true, PASSES, 64, MELS>(x, B, row_len, hop, n_frames, tile, 0, 0, b0,
                                                  b1, b2, mel, n_mels, out_mels, out, p, s);
    return launch_kc<1, true, PASSES, 32, MELS>(x, B, row_len, hop, n_frames, tile, 0, 0, b0,
                                                b1, b2, mel, n_mels, out_mels, out, p, s);
  }
}

// the largest multiple of 8 at or below row_len - N_FFT: the last window
// start of rows that hold every frame (the probe's lead-0 rows)
inline int last_start(int row_len) { return (row_len - N_FFT) / 8 * 8; }

}  // namespace mel_wgmma
