// P1-P3 — the probe variants of the fused log-mel, CUDA C++ for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of scripts/probe_mel_kernel.py:
//   eat_probe_p1  variant_kernel (:80),  launched by variant_mel (:145)
//   eat_probe_p2  dma_kernel (:268),     launched by variant_mel_dma (:310)
//   eat_probe_p3  e_kernel (:419),       launched by variant_mel_e (:461)
// Each computes K1's function (csrc/mel_kernel.cu) with the DFT as bf16
// products summed in fp32, which is what Hopper's tensor cores do. For one
// clip and one tile of frames, in one kernel:
//   frame i is x[hop * i, hop * i + 1024) of the row the wrapper prepares
//   (ops/mel_probe.py: the raw wave behind a 512-sample zero pad for the
//   folded basis, or the pre-emphasised, reflect-padded wave for the plain
//   one), split here into bf16 hi + lo (fh = bf16(f), fl = bf16(f - fh));
//   times the basis, split into bf16 hi + lo by the wrapper (1024 x 1024:
//   512 cos columns, then 512 sin columns, no Nyquist bin), in PASSES:
//     3:  fh * bhi + (fh * blo + fl * bhi)
//     21: fh * bhi + fl * bhi    (frames exact, basis hi only)
//     22: fh * bhi + fh * blo    (basis exact, frames hi only)
//   -> power re^2 + im^2 -> times banks^T (512 x n_mels) in fp32
//   -> (log(x + 1e-5) + 4.5) / 5, written into the (B, n_mels, n_frames) output.
// The wrapper patches the few frames whose window reaches the reflect pad, as
// the JAX functions do.
//
// What bounds it, at B = 64 clips of 10 s and hop 320 (64,000 frames): the
// DFT product, 64,000 x 1024 x 1024 x 2 = 134.2 GFLOP a pass, 402.7 GFLOP for
// 3 passes, 0.41 ms at 989 TFLOP/s bf16; the mel product, 8.4 GFLOP, 0.13 ms
// at 67 TFLOP/s fp32; 0.53 ms together (0.40 ms at 2 passes). The bytes (82 MB
// of wave, 33 MB of output) take 34 us at 3.35 TB/s, so the arithmetic bounds
// every variant.
// What the design does about it: the DFT runs on the tensor cores
// (mma.sync.m16n8k16, bf16 in, fp32 accumulators). A block of 4 warps owns a
// sub-tile of 64 frames, 16 a warp, and walks the 512 bins in chunks of 32
// (32 cos + the 32 matching sin columns, 8 n-tiles of 8). Each warp reads 8
// consecutive samples of its frames and of its basis columns as 16-byte loads:
// the reduction runs over a permutation of the samples that is the same for
// both operands, so the fragments need no shuffle. The basis comes
// transposed (columns, samples) from device memory, where its 4 MB stay in
// L2. The power of a chunk goes through shared memory into the fp32 mel
// accumulators, which stay in registers for the whole sub-tile, as in K1: the
// frames, the projection and the power spectrum never reach device memory.
// This is the first, simple version: mma.sync rather than wgmma, no TMA, no
// pipelining of the basis through shared memory.
//
// The TPU variants differ in how a tile's frames are assembled, a problem of
// the TPU's (8, 128) layout. Here a frame is a plain offset:
//   P1 reads the frame rows straight from device memory into fragments;
//   P2 (DMA assembly on the TPU) copies the sub-tile's wave segment, one
//     contiguous run, into shared memory with cp.async and reads the
//     fragments from there; the TPU's sub64 only shaped its copies, so both
//     of its values launch this one kernel;
//   P3 is P1 at hop 320 and 128-frame tiles with PASSES 3, 21 or 22; its
//     even/odd assembly, a TPU lane-layout trick, has no counterpart.
// frame_tile is the number of frames a block covers: the block loops over its
// 64-frame sub-tiles, as the TPU's sequential grid axis did.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N_FFT = 1024;
constexpr int N_BINS = 512;        // rDFT bins kept (the Nyquist bin is dropped)
constexpr int TF = 64;             // frames a sub-tile
constexpr int THREADS = 128;       // 4 warps, 16 frames each
constexpr int NB = 32;             // bins a chunk: NB cos + NB sin columns
constexpr int NT = 2 * NB / 8;     // n-tiles of 8 columns a chunk
constexpr int KS = 32;             // samples a step: two k16 products
constexpr int MAX_MELS = 128;
constexpr int MJ = MAX_MELS / 8;   // mels a thread in the mel product
constexpr int PS = NB + 1;         // padded row stride of the power tile
constexpr int P3_TILE = 128;
constexpr size_t MAX_SMEM = 232448;  // 227 KB, a block's most on sm_90

__host__ __device__ constexpr int smem_floats(bool staged, int hop, int n_mels) {
  return (staged ? (TF - 1) * hop + N_FFT : 0)  // the sub-tile's wave segment
         + TF * PS                              // power tile
         + NB * n_mels;                         // banks^T rows of the chunk
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (a, b) -> bf16x2 hi = (bf16(a), bf16(b)) and lo = the bf16 of what is left
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
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

template <bool STAGED, int PASSES>
__global__ void __launch_bounds__(THREADS)
probe_kernel(const float* __restrict__ x, int row_len, int hop, int n_frames,
             int frame_tile,
             const __nv_bfloat16* __restrict__ bhi_t,  // (2 * N_BINS, N_FFT): columns x samples
             const __nv_bfloat16* __restrict__ blo_t,
             const float* __restrict__ banks_t,        // (N_BINS, n_mels)
             int n_mels, float* __restrict__ out) {    // (B, n_mels, n_frames)
  extern __shared__ __align__(16) float smem[];
  const int seg_len = STAGED ? (TF - 1) * hop + N_FFT : 0;
  float* seg = smem;               // [seg_len], P2 only
  float* ps = smem + seg_len;      // [TF][PS]
  float* bt = ps + TF * PS;        // [NB][n_mels]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group and column pair
  const int fg = tid / 8, ml = tid % 8;  // mel product: frames 4fg..4fg+3, mels ml + 8j
  const int b = blockIdx.y, tile = blockIdx.x;
  const float* xb = x + (size_t)b * row_len;
  float* o = out + (size_t)b * n_mels * n_frames;
  const int tile_end = min(n_frames, (tile + 1) * frame_tile);

  for (int f0 = tile * frame_tile; f0 < tile_end; f0 += TF) {
    // frame r of the sub-tile is src[hop * r, hop * r + N_FFT)
    const float* src = xb + (size_t)hop * f0;
    if (STAGED) {
      // the previous sub-tile's reads of seg ended before its last barrier
      for (int e = tid * 4; e < seg_len; e += THREADS * 4) cp_async16(seg + e, src + e);
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();
      src = seg;
    }
    // this thread's fragment rows: frames 16 * warp + g and 16 * warp + g + 8
    const float* row0 = src + (size_t)hop * (warp * 16 + g) + 8 * t;
    const float* row1 = row0 + (size_t)hop * 8;

    float acc[4][MJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < MJ; ++j) acc[i][j] = 0.f;

    for (int j0 = 0; j0 < N_BINS; j0 += NB) {
      // main (fh * bhi) and correction sums of the chunk's 8 n-tiles
      float cm[NT][4], cc[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) cm[n][e] = cc[n][e] = 0.f;

      for (int k0 = 0; k0 < N_FFT; k0 += KS) {
        // samples k0 + 8t .. k0 + 8t + 7 of both rows; product s takes the
        // four from 4s: its fragment registers 0/2 (k pairs 2t and 2t + 8 of
        // the mma) hold samples 4s + {0, 1} / {2, 3}, rows g (0, 2) and g + 8
        // (1, 3) — the same permutation as the basis loads below
        float v0[8], v1[8];
        load8<STAGED>(row0 + k0, v0);
        load8<STAGED>(row1 + k0, v1);
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          split2(v0[4 * s], v0[4 * s + 1], ah[s][0], al[s][0]);
          split2(v1[4 * s], v1[4 * s + 1], ah[s][1], al[s][1]);
          split2(v0[4 * s + 2], v0[4 * s + 3], ah[s][2], al[s][2]);
          split2(v1[4 * s + 2], v1[4 * s + 3], ah[s][3], al[s][3]);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          // column g of n-tile n: a cos column, or the matching sin column
          const int col = n < NT / 2 ? j0 + 8 * n + g : N_BINS + j0 + 8 * (n - NT / 2) + g;
          const size_t off = (size_t)col * N_FFT + k0 + 8 * t;
          const uint4 h = __ldg(reinterpret_cast<const uint4*>(bhi_t + off));
          mma_bf16(cm[n], ah[0], h.x, h.y);
          mma_bf16(cm[n], ah[1], h.z, h.w);
          if (PASSES != 21) {
            const uint4 l = __ldg(reinterpret_cast<const uint4*>(blo_t + off));
            mma_bf16(cc[n], ah[0], l.x, l.y);
            mma_bf16(cc[n], ah[1], l.z, l.w);
          }
          if (PASSES != 22) {
            mma_bf16(cc[n], al[0], h.x, h.y);
            mma_bf16(cc[n], al[1], h.z, h.w);
          }
        }
      }

      // power of the chunk (accumulator e: row g + 8 * (e / 2), column
      // 2t + e % 2 of its n-tile), and the banks^T rows it meets
#pragma unroll
      for (int n = 0; n < NT / 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float re = cm[n][e] + cc[n][e];
          const float im = cm[n + NT / 2][e] + cc[n + NT / 2][e];
          ps[(warp * 16 + g + 8 * (e / 2)) * PS + 8 * n + 2 * t + e % 2] = re * re + im * im;
        }
      for (int e = tid; e < NB * n_mels; e += THREADS)
        bt[e] = banks_t[(size_t)j0 * n_mels + e];
      __syncthreads();
      for (int kk = 0; kk < NB; ++kk) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = ps[(fg * 4 + i) * PS + kk];
#pragma unroll
        for (int j = 0; j < MJ; ++j) {
          const int m = ml + 8 * j;
          if (m < n_mels) {
            const float w = bt[kk * n_mels + m];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], w, acc[i][j]);
          }
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = f0 + fg * 4 + i;
      if (f >= n_frames) continue;
#pragma unroll
      for (int j = 0; j < MJ; ++j) {
        const int m = ml + 8 * j;
        if (m < n_mels) o[(size_t)m * n_frames + f] = (logf(acc[i][j] + 1e-5f) + 4.5f) / 5.0f;
      }
    }
  }
}

template <bool STAGED, int PASSES>
cudaError_t launch(const float* x, int B, int row_len, int hop, int n_frames,
                   int frame_tile, const void* bhi_t, const void* blo_t,
                   const float* banks_t, int n_mels, float* out, void* stream) {
  if (B < 1 || B > 65535 || n_frames < 1 || n_mels < 1 || n_mels > MAX_MELS ||
      hop < 64 || hop % 64 != 0 || frame_tile < TF || frame_tile % TF != 0 ||
      row_len % 4 != 0)
    return cudaErrorInvalidValue;
  // every frame of every sub-tile that runs lies inside the row
  const long long sub_frames = (long long)(n_frames + TF - 1) / TF * TF;
  if ((long long)hop * (sub_frames - 1) + N_FFT > row_len) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(STAGED, hop, n_mels);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      probe_kernel<STAGED, PASSES>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_frames + frame_tile - 1) / frame_tile, B);
  probe_kernel<STAGED, PASSES><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x, row_len, hop, n_frames, frame_tile, static_cast<const __nv_bfloat16*>(bhi_t),
      static_cast<const __nv_bfloat16*>(blo_t), banks_t, n_mels, out);
  return cudaGetLastError();
}

}  // namespace

// x (B, row_len) f32, frame i at x[:, hop * i]; bhi_t/blo_t (1024, 1024) bf16,
// the basis parts transposed to (columns, samples); banks_t (512, n_mels) f32;
// out (B, n_mels, n_frames) f32. All contiguous on the device; 16-byte aligned
// rows (row_len a multiple of 4) holding every frame of the last 64-frame
// sub-tile. Each returns the launch's cudaError_t (0 = success).
extern "C" int eat_probe_p1(const float* x, int B, int row_len, int hop, int n_frames,
                            int frame_tile, const void* bhi_t, const void* blo_t,
                            const float* banks_t, int n_mels, float* out, void* stream) {
  return (int)launch<false, 3>(x, B, row_len, hop, n_frames, frame_tile, bhi_t, blo_t,
                               banks_t, n_mels, out, stream);
}

extern "C" int eat_probe_p2(const float* x, int B, int row_len, int hop, int n_frames,
                            int frame_tile, const void* bhi_t, const void* blo_t,
                            const float* banks_t, int n_mels, float* out, void* stream) {
  return (int)launch<true, 3>(x, B, row_len, hop, n_frames, frame_tile, bhi_t, blo_t,
                              banks_t, n_mels, out, stream);
}

extern "C" int eat_probe_p3(const float* x, int B, int row_len, int hop, int n_frames,
                            int passes, const void* bhi_t, const void* blo_t,
                            const float* banks_t, int n_mels, float* out, void* stream) {
  if (hop != 320) return (int)cudaErrorInvalidValue;
  switch (passes) {
    case 3:
      return (int)launch<false, 3>(x, B, row_len, hop, n_frames, P3_TILE, bhi_t, blo_t,
                                   banks_t, n_mels, out, stream);
    case 21:
      return (int)launch<false, 21>(x, B, row_len, hop, n_frames, P3_TILE, bhi_t, blo_t,
                                    banks_t, n_mels, out, stream);
    case 22:
      return (int)launch<false, 22>(x, B, row_len, hop, n_frames, P3_TILE, bhi_t, blo_t,
                                    banks_t, n_mels, out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* eat_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
