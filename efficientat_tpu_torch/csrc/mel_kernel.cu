// K1 — fused log-mel front end, CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel efficientat_tpu/ops/mel_pallas.py::_mel_kernel.
// For one clip and one tile of frames, in one kernel:
//   frames of the RAW wave (frame i is samples [hop*i - 512, hop*i + 512),
//   zero outside [0, S)) times the pre-emphasis-folded, windowed rDFT basis
//   (1024 x 1024: 512 cos columns, then 512 sin columns, no Nyquist bin)
//   -> power re^2 + im^2 -> times banks^T (512 x n_mels)
//   -> (log(x + 1e-5) + 4.5) / 5, written into the (B, n_mels, n_frames) output.
// The frames, the projection and the power spectrum never reach device memory.
// The few frames whose window reaches the reflect pad are recomputed exactly
// by the Python wrapper (ops/mel_kernel.py), as the JAX package does.
//
// What bounds it: the DFT product, 2 * 1024 * 1024 FLOP a frame and a pass,
// about 2.1 GFLOP for a 10 s clip at hop 320 (1000 frames); the fp32 mel
// product adds 512 * n_mels * 2 FLOP a frame. The bytes (the wave, a 0.5 MB
// output a clip; the 4 MB basis is read from L2) are small beside that, so
// the kernel is bound by arithmetic.
//
// One kernel for each precision (the wrapper's dft_precision):
//
// bf16x3, mel_kernel_tc: the JAX package's 3-pass split (mel_pallas.py:185-189)
//   on the tensor cores. The basis comes split into bf16 hi + lo from the
//   host, transposed to (columns, samples); each frame sample is split the
//   same way here (fh = bf16(f), fl = bf16(f - fh)), and fh * bhi +
//   (fh * blo + fl * bhi) is summed in fp32 by mma.sync.m16n8k16, bf16 in,
//   fp32 accumulators (every bf16 x bf16 product is exact in fp32). The
//   frames come from rows the wrapper prepares: the raw wave behind a
//   512-sample zero pad, frame i at x[hop * i], 16-byte aligned.
//   A block of 8 warps owns a tile of TILE frames and walks the 512 bins in
//   chunks of 32 (32 cos + the 32 matching sin columns, 8 n-tiles of 8).
//   TILE is 128 for n_mels <= 128 (a warp: 16 frames x the chunk's 8
//   n-tiles) and 64 for n_mels <= 256 (a warp: 16 frames x 2 cos + 2 sin
//   n-tiles, two warps a chunk), so the fp32 mel accumulators, which stay in
//   registers for the whole tile, are 64 a thread either way.
//   The basis is streamed through a ring of RING stages in shared memory by
//   cp.async, one stage (32 KB) being the chunk's 64 columns x 128 samples,
//   hi and lo, so a block reads the 4 MB basis from L2 once a tile. The
//   warps read their B fragments from a stage as 16-byte reads of 8
//   consecutive samples of a column, and their A fragments as 16-byte loads
//   of 8 consecutive samples of their frame rows, straight from device
//   memory (L1): the reduction runs over a permutation of the samples that
//   is the same for both operands, so the fragments need no shuffle (the
//   layout of the probe kernel P1, csrc/mel_probe_kernel.cu). The power of
//   a chunk goes through a padded shared tile into the mel accumulators,
//   fp32 FMAs on the CUDA cores, a few rows at each stage of the next chunk,
//   so that they run beside the tensor cores' products rather than behind a
//   barrier; the power tile and the chunk's banks^T rows (copied with its
//   first stage) have two buffers each for that.
//
// fp32, mel_kernel_fp32: exact fp32 on the CUDA cores. A block owns a
//   64-frame tile and walks the 512 bins in chunks of 32. For a chunk it runs
//   an fp32 tiled GEMM over K = 1024 through shared memory, each thread
//   holding 4 frames x 2 bins of (re, im) in registers; the chunk's power
//   goes to shared memory and straight into the mel accumulators, which stay
//   in registers (4 frames x up to 16 mels a thread) for the whole tile.
//
// The mel product is fp32 in both modes (the JAX body uses HIGHEST).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N_FFT = 1024;
constexpr int N_BINS = 512;        // rDFT bins kept (the Nyquist bin is dropped)
constexpr int HALF = N_FFT / 2;    // frame i starts at sample hop * i - HALF
constexpr int NB = 32;             // bins a chunk: NB cos + NB sin columns
constexpr int THREADS = 256;
constexpr int MJ = 16;             // mels a thread: n_mels <= 16 * (mel lanes)
constexpr int MAX_MELS = 256;
constexpr int PS = NB + 1;         // padded row stride of the power tile

// ------------------------------------------------------------------ fp32

constexpr int TILE_FP32 = 64;      // frames a block
constexpr int KT = 32;             // K step of the DFT GEMM
constexpr int XS = KT + 1;         // padded row stride of the frame tile

constexpr int smem_floats_fp32(int n_mels) {
  return TILE_FP32 * XS            // frame tile
         + KT * 2 * NB             // basis tile
         + TILE_FP32 * PS          // power tile
         + NB * n_mels;            // banks^T rows of the chunk
}

__global__ void __launch_bounds__(THREADS)
mel_kernel_fp32(const float* __restrict__ wave, int S, int hop, int n_frames,
                const float* __restrict__ basis,    // (N_FFT, 2 * N_BINS)
                const float* __restrict__ banks_t,  // (N_BINS, n_mels)
                int n_mels, float* __restrict__ out) {  // (B, n_mels, n_frames)
  extern __shared__ float smem_fp32[];
  float* xs = smem_fp32;                   // [TILE_FP32][XS]
  float* bs = xs + TILE_FP32 * XS;         // [KT][2 * NB]
  float* ps = bs + KT * 2 * NB;            // [TILE_FP32][PS]
  float* bt = ps + TILE_FP32 * PS;         // [NB][n_mels]

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * TILE_FP32;
  const float* w = wave + (size_t)b * S;
  // thread tiles: frames fg*4 .. fg*4+3; DFT bins bg*2, bg*2+1 of the chunk;
  // mels lane + 16*j
  const int fg = tid / 16;
  const int lane = tid % 16;

  float acc[4][MJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MJ; ++j) acc[i][j] = 0.f;

  for (int j0 = 0; j0 < N_BINS; j0 += NB) {
    float re[4][2], im[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 2; ++q) re[i][q] = im[i][q] = 0.f;

    for (int k0 = 0; k0 < N_FFT; k0 += KT) {
      // frame tile: TILE_FP32 frames x KT samples, neighbouring threads on
      // neighbouring samples
#pragma unroll
      for (int r = 0; r < TILE_FP32 * KT / THREADS; ++r) {
        const int e = tid + r * THREADS;
        const int kk = e % KT, f = e / KT;
        const long s = (long)(f0 + f) * hop - HALF + k0 + kk;
        xs[f * XS + kk] = (s >= 0 && s < S) ? w[s] : 0.f;
      }
      // basis tile: KT rows x (NB cos columns | NB sin columns)
#pragma unroll
      for (int r = 0; r < KT * 2 * NB / THREADS; ++r) {
        const int e = tid + r * THREADS;
        const int c = e % (2 * NB), kk = e / (2 * NB);
        const int col = c < NB ? j0 + c : N_BINS + j0 + (c - NB);
        bs[kk * 2 * NB + c] = basis[(size_t)(k0 + kk) * (2 * N_BINS) + col];
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < KT; ++kk) {
        float xh[4], ch[2], sh[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) xh[i] = xs[(fg * 4 + i) * XS + kk];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          ch[q] = bs[kk * 2 * NB + lane * 2 + q];
          sh[q] = bs[kk * 2 * NB + NB + lane * 2 + q];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            re[i][q] = fmaf(xh[i], ch[q], re[i][q]);
            im[i][q] = fmaf(xh[i], sh[q], im[i][q]);
          }
      }
      __syncthreads();
    }

    // power of this chunk, and the banks^T rows it meets
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        ps[(fg * 4 + i) * PS + lane * 2 + q] = re[i][q] * re[i][q] + im[i][q] * im[i][q];
    for (int e = tid; e < NB * n_mels; e += THREADS)
      bt[e] = banks_t[(size_t)j0 * n_mels + e];
    __syncthreads();
    for (int kk = 0; kk < NB; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(fg * 4 + i) * PS + kk];
#pragma unroll
      for (int j = 0; j < MJ; ++j) {
        const int m = lane + 16 * j;
        if (m < n_mels) {
          const float v = bt[kk * n_mels + m];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], v, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  float* o = out + (size_t)b * n_mels * n_frames;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = f0 + fg * 4 + i;
    if (f >= n_frames) continue;
#pragma unroll
    for (int j = 0; j < MJ; ++j) {
      const int m = lane + 16 * j;
      if (m < n_mels) o[(size_t)m * n_frames + f] = (logf(acc[i][j] + 1e-5f) + 4.5f) / 5.0f;
    }
  }
}

// ---------------------------------------------------------------- bf16x3

constexpr int KC = 128;                  // samples a stage
constexpr int K_STAGES = N_FFT / KC;     // stages a chunk
constexpr int N_STAGES = N_BINS / NB * K_STAGES;  // stages a tile
constexpr int RING = 3;                  // stages in shared memory
constexpr int PIECES = KC / 8;           // 16-byte pieces of a stage column
constexpr int STAGE_PART = 2 * NB * KC;  // bf16 values of a stage's hi (or lo) part
constexpr int STAGE = 2 * STAGE_PART;    // bf16 values of a stage: 32 KB
constexpr int MEL_ROWS = NB / K_STAGES;  // power rows of a chunk that a stage folds in
static_assert(NB % K_STAGES == 0, "a chunk's power rows spread evenly over its stages");

constexpr size_t smem_bytes_tc(int tile, int n_mels) {
  return sizeof(__nv_bfloat16) * RING * STAGE          // the basis ring
         + sizeof(float) * 2 * (tile * PS              // power tiles, two chunks
                                + NB * n_mels);        // banks^T rows, two chunks
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's newest copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 8 consecutive floats of device memory, read-only
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Start the copy of stage q of a tile's walk (chunk q / K_STAGES, samples
// from (q % K_STAGES) * KC) into ring slot q % RING. Column c of the chunk
// (c < NB: cos bin j0 + c, else sin bin j0 + c - NB) holds its KC samples
// as 16-byte pieces, piece u at u ^ (4 * (c & 1)): a quarter warp's
// fragment reads, 4 pieces of two neighbouring columns, then fall on 32
// distinct banks.
__device__ __forceinline__ void load_stage(int q, int tid, __nv_bfloat16* ring,
                                           const __nv_bfloat16* __restrict__ bhi_t,
                                           const __nv_bfloat16* __restrict__ blo_t) {
  const int j0 = q / K_STAGES * NB, k0 = q % K_STAGES * KC;
  __nv_bfloat16* st = ring + q % RING * STAGE;
#pragma unroll
  for (int r = 0; r < STAGE / 8 / THREADS; ++r) {
    const int e = tid + r * THREADS;
    const int part = e / (STAGE_PART / 8), c = e / PIECES % (2 * NB), u = e % PIECES;
    const int col = c < NB ? j0 + c : N_BINS + j0 + c - NB;
    cp_async16(st + part * STAGE_PART + c * KC + 8 * (u ^ (4 * (c & 1))),
               (part ? blo_t : bhi_t) + (size_t)col * N_FFT + k0 + 8 * u);
  }
}

// acc[i][j] += the power of frame 4 fg + i at the chunk's bins kk0 ..
// kk0 + ROWS - 1 times their banks^T rows at mel ml + ML * j (fp32 FMAs)
template <int ML, int ROWS>
__device__ __forceinline__ void mel_rows(float (&acc)[4][MJ], const float* ps,
                                         const float* bt, int kk0, int fg, int ml,
                                         int n_mels) {
#pragma unroll
  for (int kk = kk0; kk < kk0 + ROWS; ++kk) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = ps[(fg * 4 + i) * PS + kk];
#pragma unroll
    for (int j = 0; j < MJ; ++j) {
      const int m = ml + ML * j;
      if (m < n_mels) {
        const float w = bt[kk * n_mels + m];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], w, acc[i][j]);
      }
    }
  }
}

template <int TILE>
__global__ void __launch_bounds__(THREADS, 1)
mel_kernel_tc(const float* __restrict__ x, int row_len, int hop, int n_frames,
              const __nv_bfloat16* __restrict__ bhi_t,  // (2 * N_BINS, N_FFT): columns x samples
              const __nv_bfloat16* __restrict__ blo_t,
              const float* __restrict__ banks_t,        // (N_BINS, n_mels)
              int n_mels, float* __restrict__ out) {    // (B, n_mels, n_frames)
  constexpr int FG = TILE / 16;          // 16-frame groups of the tile, one a warp
  constexpr int NT = FG;                 // n-tiles a warp: 8 of a chunk's 8, or 4
  constexpr int ML = 4 * THREADS / TILE; // mel lanes: a thread has 4 frames x MJ mels
  static_assert(THREADS / 32 * NT == FG * 8, "the warps cover a chunk once");
  extern __shared__ __align__(16) unsigned char smem_tc[];
  auto* ring = reinterpret_cast<__nv_bfloat16*>(smem_tc);     // [RING][STAGE]
  float* ps = reinterpret_cast<float*>(ring + RING * STAGE);  // [2][TILE][PS]
  float* bt = ps + 2 * TILE * PS;                             // [2][NB][n_mels]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group and column pair
  // the warp's frames 16 wf .. 16 wf + 15 of the tile, and its n-tiles of a
  // chunk: cos n-tiles n0 .. n0 + NT/2 - 1 and the matching sin n-tiles
  const int wf = warp % FG, n0 = warp / FG * (NT / 2);
  const int fg = tid / ML, ml = tid % ML;  // mel product: frames 4fg..4fg+3, mels ml + ML*j
  const int b = blockIdx.y, f0 = blockIdx.x * TILE;
  // this thread's fragment rows, frames 16 wf + g and 16 wf + g + 8 of the
  // tile; a frame past the clip reads the last one, and is never written
  const float* xb = x + (size_t)b * row_len + 8 * t;
  const float* row0 = xb + (size_t)hop * min(f0 + 16 * wf + g, n_frames - 1);
  const float* row1 = xb + (size_t)hop * min(f0 + 16 * wf + g + 8, n_frames - 1);
  // the 16-byte piece of a stage column this thread reads at sub-step kq is
  // (4 kq + t) ^ swz: its columns 8n + g have the parity of g
  const int swz = 4 * (g & 1);

  float acc[4][MJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MJ; ++j) acc[i][j] = 0.f;
  // main (fh * bhi) and correction sums of the warp's n-tiles of a chunk
  float cm[NT][4], cc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) cm[n][e] = cc[n][e] = 0.f;

  for (int q = 0; q < RING - 1; ++q) {
    load_stage(q, tid, ring, bhi_t, blo_t);
    cp_async_commit();
  }

  // Chunk c's power (ps buffer c % 2) and banks^T rows (bt buffer c % 2)
  // meet in the mel accumulators during chunk c + 1, MEL_ROWS rows a stage,
  // so the CUDA cores' FMAs run beside the tensor cores' products.
  for (int chunk = 0; chunk < N_BINS / NB; ++chunk) {
    const float* ps_prev = ps + (chunk + 1) % 2 * TILE * PS;
    const float* bt_prev = bt + (chunk + 1) % 2 * NB * n_mels;
    for (int ks = 0; ks < K_STAGES; ++ks) {
      const int q = chunk * K_STAGES + ks;
      // stage q has landed; every warp is done with stage q - 1, whose slot
      // the copy started next fills, and, at a chunk's first stage, with the
      // mel rows of chunk - 2, whose bt buffer this chunk's rows fill
      cp_async_wait<RING - 2>();
      __syncthreads();
      if (ks == 0) {
        float* dst = bt + chunk % 2 * NB * n_mels;
        const float* src = banks_t + (size_t)chunk * NB * n_mels;
        for (int e = 4 * tid; e < NB * n_mels; e += 4 * THREADS) cp_async16(dst + e, src + e);
      }
      if (q + RING - 1 < N_STAGES) load_stage(q + RING - 1, tid, ring, bhi_t, blo_t);
      cp_async_commit();  // an empty group at the end keeps the count
      const __nv_bfloat16* st = ring + q % RING * STAGE;
#pragma unroll
      for (int kq = 0; kq < KC / 32; ++kq) {
        // samples 8t .. 8t + 7 of the sub-step's 32, both rows; product s
        // takes the four from 4s: its fragment registers 0/2 (k pairs 2t and
        // 2t + 8 of the mma) hold samples 4s + {0, 1} / {2, 3}, rows g (0, 2)
        // and g + 8 (1, 3) — the same permutation as the basis reads below
        const int k = ks * KC + kq * 32;
        float v0[8], v1[8];
        load8(row0 + k, v0);
        load8(row1 + k, v1);
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          split2(v0[4 * s], v0[4 * s + 1], ah[s][0], al[s][0]);
          split2(v1[4 * s], v1[4 * s + 1], ah[s][1], al[s][1]);
          split2(v0[4 * s + 2], v0[4 * s + 3], ah[s][2], al[s][2]);
          split2(v1[4 * s + 2], v1[4 * s + 3], ah[s][3], al[s][3]);
        }
        const int piece = (4 * kq + t) ^ swz;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          // stage column g of the n-tile: a cos column, or the matching sin one
          const int c = 8 * (n < NT / 2 ? n0 + n : NB / 8 + n0 + n - NT / 2) + g;
          const int off = c * KC + 8 * piece;
          const uint4 h = *reinterpret_cast<const uint4*>(st + off);
          const uint4 l = *reinterpret_cast<const uint4*>(st + STAGE_PART + off);
          mma_bf16(cm[n], ah[0], h.x, h.y);
          mma_bf16(cm[n], ah[1], h.z, h.w);
          mma_bf16(cc[n], ah[0], l.x, l.y);
          mma_bf16(cc[n], ah[1], l.z, l.w);
          mma_bf16(cc[n], al[0], h.x, h.y);
          mma_bf16(cc[n], al[1], h.z, h.w);
        }
      }
      if (chunk > 0)
        mel_rows<ML, MEL_ROWS>(acc, ps_prev, bt_prev, ks * MEL_ROWS, fg, ml, n_mels);
    }

    // power of the chunk (accumulator e: row g + 8 * (e / 2), column
    // 2t + e % 2 of its n-tile), read after the next stage's barrier
    float* ps_cur = ps + chunk % 2 * TILE * PS;
#pragma unroll
    for (int n = 0; n < NT / 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float re = cm[n][e] + cc[n][e];
        const float im = cm[n + NT / 2][e] + cc[n + NT / 2][e];
        ps_cur[(16 * wf + g + 8 * (e / 2)) * PS + 8 * (n0 + n) + 2 * t + e % 2] =
            re * re + im * im;
      }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) cm[n][e] = cc[n][e] = 0.f;
  }
  // the last chunk's mel rows (its bt rows landed with an earlier stage)
  constexpr int LAST = N_BINS / NB - 1;
  __syncthreads();
  mel_rows<ML, NB>(acc, ps + LAST % 2 * TILE * PS, bt + LAST % 2 * NB * n_mels, 0, fg, ml,
                   n_mels);

  float* o = out + (size_t)b * n_mels * n_frames;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = f0 + fg * 4 + i;
    if (f >= n_frames) continue;
#pragma unroll
    for (int j = 0; j < MJ; ++j) {
      const int m = ml + ML * j;
      if (m < n_mels) o[(size_t)m * n_frames + f] = (logf(acc[i][j] + 1e-5f) + 4.5f) / 5.0f;
    }
  }
}

cudaError_t launch_fp32(const float* wave, int B, int S, int hop, int n_frames,
                        const void* basis, const float* banks_t, int n_mels, float* out,
                        cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats_fp32(n_mels);
  cudaError_t err = cudaFuncSetAttribute(
      mel_kernel_fp32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_frames + TILE_FP32 - 1) / TILE_FP32, B);
  mel_kernel_fp32<<<grid, THREADS, smem, stream>>>(
      wave, S, hop, n_frames, static_cast<const float*>(basis), banks_t, n_mels, out);
  return cudaGetLastError();
}

template <int TILE>
cudaError_t launch_tc(const float* x, int B, int row_len, int hop, int n_frames,
                      const void* bhi_t, const void* blo_t, const float* banks_t,
                      int n_mels, float* out, cudaStream_t stream) {
  const size_t smem = smem_bytes_tc(TILE, n_mels);
  cudaError_t err = cudaFuncSetAttribute(
      mel_kernel_tc<TILE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_frames + TILE - 1) / TILE, B);
  mel_kernel_tc<TILE><<<grid, THREADS, smem, stream>>>(
      x, row_len, hop, n_frames, static_cast<const __nv_bfloat16*>(bhi_t),
      static_cast<const __nv_bfloat16*>(blo_t), banks_t, n_mels, out);
  return cudaGetLastError();
}

}  // namespace

// bf16x3 == 0: wave is the raw wave (B, S) f32 and basis the (1024, 1024) f32
// basis. bf16x3 == 1: wave is the kernel's rows (B, S) f32, the raw wave
// behind a 512-sample zero pad, frame i at wave[:, hop * i], with S and hop
// multiples of 4 and hop * (n_frames - 1) + 1024 <= S; bhi/blo are the bf16
// basis parts transposed to (columns, samples), (1024, 1024). banks_t
// (512, n_mels) f32; out (B, n_mels, n_frames) f32. All contiguous on the
// device. Returns the launch's cudaError_t (0 = success).
extern "C" int eat_mel_log(const float* wave, int B, int S, int hop, int n_frames,
                           const void* basis, const void* bhi, const void* blo,
                           int bf16x3, const float* banks_t, int n_mels, float* out,
                           void* stream) {
  if (B < 1 || B > 65535 || n_frames < 1 || n_mels < 1 || n_mels > MAX_MELS || hop < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16x3)
    return (int)launch_fp32(wave, B, S, hop, n_frames, basis, banks_t, n_mels, out, s);
  if (S % 4 != 0 || hop % 4 != 0 || (long long)hop * (n_frames - 1) + N_FFT > S)
    return (int)cudaErrorInvalidValue;
  // frames a block: 128 x 128 or 64 x 256 mel accumulators, 64 a thread
  if (n_mels <= 128)
    return (int)launch_tc<128>(wave, B, S, hop, n_frames, bhi, blo, banks_t, n_mels, out, s);
  return (int)launch_tc<64>(wave, B, S, hop, n_frames, bhi, blo, banks_t, n_mels, out, s);
}

extern "C" const char* eat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
