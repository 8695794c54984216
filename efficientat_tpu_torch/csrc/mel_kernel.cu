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
// Two kernels, chosen by the wrapper from its arguments
// (ops/mel_kernel.py::k1_route):
//   at n_mels <= 128, bf16x3 (the serving and training default) and fp32:
//     eat_mel_log_wgmma, the Hopper design of csrc/mel_wgmma.cuh
//     (mel_kernel_wgmma<2, false, 3 | 6, 128>: wgmma DFT, the basis through a
//     bulk-copy ring, the mel product on the tensor cores at fp32's
//     precision); that header describes it;
//   at 129-256 mels: eat_mel_log, mel_kernel_tc<64, PARTS> below, whose mel
//     product is fp32 FMAs on the CUDA cores.
//
// mel_kernel_tc runs the DFT on the tensor cores as products of bf16 parts
// summed in fp32. The basis comes split into PARTS bf16 parts
// from the host (part 0 = bf16(b), part p = the bf16 of what parts 0 .. p-1
// leave), transposed to (columns, samples); each frame sample is split the
// same way here. The products of frame part i and basis part j with
// i + j < PARTS are summed by mma.sync.m16n8k16, bf16 in, fp32 accumulators
// (every bf16 x bf16 product is exact in fp32), the main product hi*hi in
// one set of accumulators and the corrections, 2^-8 of it and less, in
// another, so that they are not rounded at the main sum's scale:
//   bf16x3, PARTS 2: the JAX package's 3-pass split (mel_pallas.py:185-189),
//     hi*hi + (hi*lo + lo*hi);
//   fp32, PARTS 3: the 6-pass split the TPU's MXU runs for
//     Precision.HIGHEST (mel_pallas.py:190-192), hi*hi + (hi*mid + mid*hi +
//     hi*lo + mid*mid + lo*hi) (three bf16 parts carry fp32's 24
//     significand bits; the products dropped are of order 2^-24 of the main
//     one, or less).
// The mel product is fp32 FMAs on the CUDA cores (the JAX body uses
// HIGHEST for it, mel_pallas.py:197-198).
//
// What bounds mel_kernel_tc: the DFT products, 2 * 1024 * 1024 FLOP a frame and a pass,
// about 2.1 GFLOP for a 10 s clip at hop 320 (1000 frames), 3 or 6 passes at
// the tensor cores' bf16 rate; the fp32 mel product adds 512 * n_mels * 2
// FLOP a frame at the CUDA cores' rate. The bytes (the wave, a 0.5 MB output
// a clip; the 4 or 6 MB basis is read from L2) are small beside that, so the
// kernel is bound by arithmetic; in practice by the shared-memory traffic of
// the basis fragments, which the design keeps to one read a part, a column
// and a warp.
//
// The frames come from rows the wrapper prepares: the raw wave behind a
// 512-sample zero pad, frame i at x[hop * i], 16-byte aligned.
// A block of 8 warps owns a tile of TILE = 64 frames and walks the 512 bins
// in chunks of 32 (32 cos + the 32 matching sin columns, 8 n-tiles of 8): a
// warp takes 16 frames x 2 cos + 2 sin n-tiles, two warps a chunk, so that
// the fp32 mel accumulators of up to 256 mels, which stay in registers for
// the whole tile, are 64 a thread. A wider bank is
// computed in launches of at most 256 mels, each writing its rows of the
// output and redoing the DFT (the wrapper's mel groups).
// The basis is streamed through a ring of RING stages in shared memory by
// cp.async, one stage being the chunk's 64 columns x 128 samples of each
// part (16 KB a part: 32 KB in bf16x3, 48 KB in fp32), so a block reads the
// basis from L2 once a tile. The warps read their B fragments from a stage
// as 16-byte reads of 8 consecutive samples of a column (two 8-byte reads
// in fp32, which splits one group of A at a time), and
// their A fragments as 16-byte loads of 8 consecutive samples of their frame
// rows, straight from device memory (L1): the reduction runs over a
// permutation of the samples that is the same for both operands, so the
// fragments need no shuffle (the layout of csrc/mel_wgmma.cuh). The power of a chunk goes through a padded
// shared tile into the mel accumulators, fp32 FMAs on the CUDA cores, a few
// rows at each stage of the next chunk, so that they run beside the tensor
// cores' products rather than behind a barrier; the power tile and the
// chunk's banks^T rows (copied with its first stage) have two buffers each
// for that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mel_wgmma.cuh"

namespace {

constexpr int N_FFT = 1024;
constexpr int N_BINS = 512;        // rDFT bins kept (the Nyquist bin is dropped)
constexpr int NB = 32;             // bins a chunk: NB cos + NB sin columns
constexpr int THREADS = 256;
constexpr int MJ = 16;             // mels a thread: n_mels <= 16 * (mel lanes)
constexpr int MAX_MELS = 256;      // mels a launch
constexpr int MAX_PARTS = 3;
constexpr int PS = NB + 1;         // padded row stride of the power tile

constexpr int KC = 128;                  // samples a stage
constexpr int K_STAGES = N_FFT / KC;     // stages a chunk
constexpr int N_STAGES = N_BINS / NB * K_STAGES;  // stages a tile
constexpr int RING = 3;                  // stages in shared memory
constexpr int PIECES = KC / 8;           // 16-byte pieces of a stage column
constexpr int STAGE_PART = 2 * NB * KC;  // bf16 values of a stage's part: 16 KB
constexpr int MEL_ROWS = NB / K_STAGES;  // power rows of a chunk that a stage folds in
static_assert(NB % K_STAGES == 0, "a chunk's power rows spread evenly over its stages");

// the basis's bf16 parts, each (2 * N_BINS, N_FFT): columns x samples
struct Basis {
  const __nv_bfloat16* part[MAX_PARTS];
};

constexpr size_t smem_bytes(int tile, int parts, int n_mels) {
  return sizeof(__nv_bfloat16) * RING * parts * STAGE_PART  // the basis ring
         + sizeof(float) * 2 * (tile * PS                   // power tiles, two chunks
                                + NB * n_mels);             // banks^T rows, two chunks
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (a, b) -> register r of each part's fragment: part 0 is (bf16(a),
// bf16(b)) as bf16x2, part p the bf16 of what parts 0 .. p-1 leave
template <int PARTS>
__device__ __forceinline__ void split(float a, float b, uint32_t (&af)[PARTS][4], int r) {
#pragma unroll
  for (int p = 0; p < PARTS; ++p) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    af[p][r] = *reinterpret_cast<const uint32_t*>(&h);
    const float2 hf = __bfloat1622float2(h);
    a -= hf.x;
    b -= hf.y;
  }
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
// from (q % K_STAGES) * KC) into ring slot q % RING, each part in turn.
// Column c of the chunk (c < NB: cos bin j0 + c, else sin bin j0 + c - NB)
// holds its KC samples as 16-byte pieces, piece u at u ^ (4 * (c & 1)): a
// quarter warp's fragment reads, 4 pieces of two neighbouring columns, then
// fall on 32 distinct banks.
template <int PARTS>
__device__ __forceinline__ void load_stage(int q, int tid, __nv_bfloat16* ring, Basis basis) {
  const int j0 = q / K_STAGES * NB, k0 = q % K_STAGES * KC;
  __nv_bfloat16* st = ring + q % RING * PARTS * STAGE_PART;
#pragma unroll
  for (int p = 0; p < PARTS; ++p)
#pragma unroll
    for (int r = 0; r < STAGE_PART / 8 / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int c = e / PIECES, u = e % PIECES;
      const int col = c < NB ? j0 + c : N_BINS + j0 + c - NB;
      cp_async16(st + p * STAGE_PART + c * KC + 8 * (u ^ (4 * (c & 1))),
                 basis.part[p] + (size_t)col * N_FFT + k0 + 8 * u);
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

template <int TILE, int PARTS>
__global__ void __launch_bounds__(THREADS, 1)
mel_kernel_tc(const float* __restrict__ x, int row_len, int hop, int n_frames,
              Basis basis, const float* __restrict__ banks_t,  // (N_BINS, n_mels)
              int n_mels, float* __restrict__ out,              // (B, out_mels, n_frames)
              int out_mels) {
  constexpr int FG = TILE / 16;          // 16-frame groups of the tile, one a warp
  constexpr int NT = FG;                 // n-tiles a warp: 8 of a chunk's 8, or 4
  constexpr int ML = 4 * THREADS / TILE; // mel lanes: a thread has 4 frames x MJ mels
  constexpr int STAGE = PARTS * STAGE_PART;
  // 16-sample groups of A fragments split and live at a time: both, but one
  // in fp32, where that measured about 9 % faster at 256 mels on an H100
  // (tools/time_k1.py); it reads each B fragment as two 8-byte halves
  constexpr int GROUPS = PARTS == 3 ? 1 : 2;
  static_assert(THREADS / 32 * NT == FG * 8, "the warps cover a chunk once");
  static_assert(PARTS == 2 || PARTS == 3, "bf16x3 or fp32");
  extern __shared__ __align__(16) unsigned char smem_tc[];
  auto* ring = reinterpret_cast<__nv_bfloat16*>(smem_tc);     // [RING][PARTS][STAGE_PART]
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
  // main (hi * hi) and correction sums of the warp's n-tiles of a chunk
  float cm[NT][4], cc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) cm[n][e] = cc[n][e] = 0.f;

  for (int q = 0; q < RING - 1; ++q) {
    load_stage<PARTS>(q, tid, ring, basis);
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
      if (q + RING - 1 < N_STAGES) load_stage<PARTS>(q + RING - 1, tid, ring, basis);
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
        const int piece = (4 * kq + t) ^ swz;
#pragma unroll
        for (int s0 = 0; s0 < 2; s0 += GROUPS) {
          uint32_t af[GROUPS][PARTS][4];
#pragma unroll
          for (int s = 0; s < GROUPS; ++s) {
            const int v = 4 * (s0 + s);
            split<PARTS>(v0[v], v0[v + 1], af[s], 0);
            split<PARTS>(v1[v], v1[v + 1], af[s], 1);
            split<PARTS>(v0[v + 2], v0[v + 3], af[s], 2);
            split<PARTS>(v1[v + 2], v1[v + 3], af[s], 3);
          }
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            // stage column g of the n-tile: a cos column, or the matching sin one;
            // its 8 samples of the sub-step, 4 a group
            const int c = 8 * (n < NT / 2 ? n0 + n : NB / 8 + n0 + n - NT / 2) + g;
            const __nv_bfloat16* col = st + c * KC + 8 * piece + 4 * s0;
            uint32_t bf[PARTS][2 * GROUPS];
#pragma unroll
            for (int p = 0; p < PARTS; ++p) {
              if constexpr (GROUPS == 2) {
                const uint4 u = *reinterpret_cast<const uint4*>(col + p * STAGE_PART);
                bf[p][0] = u.x; bf[p][1] = u.y; bf[p][2] = u.z; bf[p][3] = u.w;
              } else {
                const uint2 u = *reinterpret_cast<const uint2*>(col + p * STAGE_PART);
                bf[p][0] = u.x; bf[p][1] = u.y;
              }
            }
            // frame part i times basis part j, i + j < PARTS
#pragma unroll
            for (int i = 0; i < PARTS; ++i)
#pragma unroll
              for (int j = 0; i + j < PARTS; ++j) {
                float(&sum)[4] = i + j == 0 ? cm[n] : cc[n];
#pragma unroll
                for (int s = 0; s < GROUPS; ++s)
                  mma_bf16(sum, af[s][i], bf[j][2 * s], bf[j][2 * s + 1]);
              }
          }
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

  float* o = out + (size_t)b * out_mels * n_frames;
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

template <int TILE, int PARTS>
cudaError_t launch(const float* x, int B, int row_len, int hop, int n_frames, Basis basis,
                   const float* banks_t, int n_mels, float* out, int out_mels,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(TILE, PARTS, n_mels);
  cudaError_t err = cudaFuncSetAttribute(
      mel_kernel_tc<TILE, PARTS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_frames + TILE - 1) / TILE, B);
  mel_kernel_tc<TILE, PARTS><<<grid, THREADS, smem, stream>>>(x, row_len, hop, n_frames, basis,
                                                              banks_t, n_mels, out, out_mels);
  return cudaGetLastError();
}

}  // namespace

// rows: the kernel's rows (B, S) f32, the raw wave behind a 512-sample zero
// pad, frame i at rows[:, hop * i], with S and hop multiples of 4 and
// hop * (n_frames - 1) + 1024 <= S. b0, b1, b2: the basis's bf16 parts
// transposed to (columns, samples), (1024, 1024) each; parts 2 (bf16x3,
// b2 unused) or 3 (fp32). banks_t (512, n_mels) f32, n_mels <= 256. out:
// the first n_mels rows of each clip's out_mels rows of a (B, out_mels,
// n_frames) f32 output, so that a wider bank is computed in launches of at
// most 256 mels. B <= 65535, the grid's y limit. All contiguous on the
// device. Returns the launch's cudaError_t (0 = success).
extern "C" int eat_mel_log(const float* rows, int B, int S, int hop, int n_frames,
                           const void* b0, const void* b1, const void* b2, int parts,
                           const float* banks_t, int n_mels, float* out, int out_mels,
                           void* stream) {
  if (B < 1 || B > 65535 || n_frames < 1 || n_mels < 1 || n_mels > MAX_MELS ||
      out_mels < n_mels || hop < 1 || S % 4 != 0 || hop % 4 != 0 ||
      (long long)hop * (n_frames - 1) + N_FFT > S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Basis basis = {{static_cast<const __nv_bfloat16*>(b0),
                        static_cast<const __nv_bfloat16*>(b1),
                        static_cast<const __nv_bfloat16*>(b2)}};
  if (parts == 2)
    return (int)launch<64, 2>(rows, B, S, hop, n_frames, basis, banks_t, n_mels, out, out_mels,
                              s);
  if (parts == 3)
    return (int)launch<64, 3>(rows, B, S, hop, n_frames, basis, banks_t, n_mels, out, out_mels,
                              s);
  return (int)cudaErrorInvalidValue;
}

// n_mels <= 128, one 128-frame sub-tile a block, on mel_kernel_wgmma<2,
// false, 3, 128> (parts 2: bf16x3) or <2, false, 6, 128> (parts 3: fp32):
// rows (B, S) f32 as ops/mel_kernel.py::_block_rows makes them (the raw wave
// behind a 512-sample zero pad, frame i at rows[:, hop * i], S a multiple of
// 4 holding every frame of the last 128-frame block, hop a multiple of 64);
// b0, b1, b2 the folded basis's bf16 parts tiled by _tiled_basis (b2 unread
// at parts 2); mel banks^T in three bf16 parts tiled by _tiled_banks; out
// (B, n_mels, n_frames) f32. B <= 65535. All contiguous on the device.
// Returns the launch's cudaError_t (0 = success).
extern "C" int eat_mel_log_wgmma(const float* rows, int B, int S, int hop, int n_frames,
                                 const void* b0, const void* b1, const void* b2, int parts,
                                 const void* mel, int n_mels, float* out, void* stream) {
  if (parts == 2)
    return (int)mel_wgmma::launch<false, 3>(rows, B, S, hop, n_frames, 128, b0, b1, nullptr,
                                            mel, n_mels, out, stream);
  if (parts == 3)
    return (int)mel_wgmma::launch<false, 6>(rows, B, S, hop, n_frames, 128, b0, b1, b2, mel,
                                            n_mels, out, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* eat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
