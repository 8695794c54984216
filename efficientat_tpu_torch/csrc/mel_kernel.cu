// K1 — fused log-mel front end, CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel efficientat_tpu/ops/mel_pallas.py::_mel_kernel.
// For one clip and one tile of TF frames, in one kernel:
//   frames of the RAW wave (frame i is samples [hop*i - 512, hop*i + 512),
//   zero outside [0, S)) times the pre-emphasis-folded, windowed rDFT basis
//   (1024 x 1024: 512 cos columns, then 512 sin columns, no Nyquist bin)
//   -> power re^2 + im^2 -> times banks^T (512 x n_mels)
//   -> (log(x + 1e-5) + 4.5) / 5, written into the (B, n_mels, n_frames) output.
// The frames, the projection and the power spectrum never reach device memory.
// The few frames whose window reaches the reflect pad are recomputed exactly
// by the Python wrapper (ops/mel_kernel.py), as the JAX package does.
//
// What bounds it: the DFT GEMM, 2 * 1024 * 1024 FLOP a frame, about 2.1 GFLOP
// for a 10 s clip at hop 320 (1000 frames); the mel GEMM adds about 6 %. The
// bytes (the wave, a 4 MB basis read from L2, a 0.5 MB output a clip) are
// small beside that, so the kernel is bound by arithmetic.
// What the design does about it: a block owns a 64-frame tile and walks the
// 512 bins in chunks of 32 (32 cos plus the matching 32 sin columns). For a
// chunk it runs an fp32 tiled GEMM over K = 1024 through shared memory, each
// thread holding 4 frames x 2 bins of (re, im) in registers; the chunk's power
// goes to shared memory and straight into the mel accumulators, which stay in
// registers (4 frames x up to 16 mels a thread) for the whole tile, so the
// power spectrum costs no device-memory traffic at all. Both GEMMs are plain
// FMAs on the CUDA cores: this is the first, simple version; tensor cores
// (wgmma, TMA) are later work.
//
// Precision (the template flag BF16X3):
//   false: fp32 frames x fp32 basis, fp32 FMA.
//   true:  the JAX package's 3-pass split (mel_pallas.py:185-189): the basis
//          comes split into bf16 hi + lo from the host, each frame sample is
//          split the same way here, and hi*hi + (hi*lo + lo*hi) is summed in
//          fp32 (every bf16 x bf16 product is exact in fp32).
//   The mel GEMM is fp32 in both modes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int N_FFT = 1024;
constexpr int N_BINS = 512;        // rDFT bins kept (the Nyquist bin is dropped)
constexpr int HALF = N_FFT / 2;    // frame i starts at sample hop * i - HALF
constexpr int TF = 64;             // frames a block
constexpr int NB = 32;             // bins a chunk: NB cos + NB sin columns
constexpr int KT = 32;             // K step of the DFT GEMM
constexpr int THREADS = 256;
constexpr int MAX_MJ = 16;         // mels a thread: n_mels <= 16 * MAX_MJ
constexpr int MAX_MELS = 16 * MAX_MJ;
constexpr int XS = KT + 1;         // padded row stride of the frame tile
constexpr int PS = NB + 1;         // padded row stride of the power tile

__host__ __device__ constexpr int smem_floats(bool bf16x3, int n_mels) {
  return (bf16x3 ? 2 : 1) * TF * XS      // frame tile (hi, lo)
         + (bf16x3 ? 2 : 1) * KT * 2 * NB  // basis tile (hi, lo)
         + TF * PS                         // power tile
         + NB * n_mels;                    // banks^T rows of the chunk
}

template <bool BF16X3>
__global__ void __launch_bounds__(THREADS)
mel_kernel(const float* __restrict__ wave, int S, int hop, int n_frames,
           const float* __restrict__ basis,          // fp32: (N_FFT, 2 * N_BINS)
           const __nv_bfloat16* __restrict__ bhi,    // bf16x3: hi part, same layout
           const __nv_bfloat16* __restrict__ blo,    // bf16x3: lo part
           const float* __restrict__ banks_t,        // (N_BINS, n_mels)
           int n_mels, float* __restrict__ out) {    // (B, n_mels, n_frames)
  extern __shared__ float smem[];
  float* xs_hi = smem;                                  // [TF][XS]
  float* xs_lo = xs_hi + TF * XS;                       // [TF][XS], bf16x3 only
  float* bs_hi = xs_lo + (BF16X3 ? TF * XS : 0);        // [KT][2 * NB]
  float* bs_lo = bs_hi + KT * 2 * NB;                   // [KT][2 * NB], bf16x3 only
  float* ps = bs_lo + (BF16X3 ? KT * 2 * NB : 0);       // [TF][PS]
  float* bt = ps + TF * PS;                             // [NB][n_mels]

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * TF;
  const float* w = wave + (size_t)b * S;
  // thread tiles: frames fg*4 .. fg*4+3; DFT bins bg*2, bg*2+1 of the chunk;
  // mels lane + 16*j
  const int fg = tid / 16;
  const int lane = tid % 16;

  float acc[4][MAX_MJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MAX_MJ; ++j) acc[i][j] = 0.f;

  for (int j0 = 0; j0 < N_BINS; j0 += NB) {
    float re[4][2], im[4][2], re_c[4][2], im_c[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 2; ++q) re[i][q] = im[i][q] = re_c[i][q] = im_c[i][q] = 0.f;

    for (int k0 = 0; k0 < N_FFT; k0 += KT) {
      // frame tile: TF frames x KT samples, neighbouring threads on
      // neighbouring samples
#pragma unroll
      for (int r = 0; r < TF * KT / THREADS; ++r) {
        const int e = tid + r * THREADS;
        const int kk = e % KT, f = e / KT;
        const long s = (long)(f0 + f) * hop - HALF + k0 + kk;
        const float x = (s >= 0 && s < S) ? w[s] : 0.f;
        if (BF16X3) {
          const float h = __bfloat162float(__float2bfloat16_rn(x));
          xs_hi[f * XS + kk] = h;
          xs_lo[f * XS + kk] = __bfloat162float(__float2bfloat16_rn(x - h));
        } else {
          xs_hi[f * XS + kk] = x;
        }
      }
      // basis tile: KT rows x (NB cos columns | NB sin columns)
#pragma unroll
      for (int r = 0; r < KT * 2 * NB / THREADS; ++r) {
        const int e = tid + r * THREADS;
        const int c = e % (2 * NB), kk = e / (2 * NB);
        const int col = c < NB ? j0 + c : N_BINS + j0 + (c - NB);
        const size_t g = (size_t)(k0 + kk) * (2 * N_BINS) + col;
        if (BF16X3) {
          bs_hi[kk * 2 * NB + c] = __bfloat162float(bhi[g]);
          bs_lo[kk * 2 * NB + c] = __bfloat162float(blo[g]);
        } else {
          bs_hi[kk * 2 * NB + c] = basis[g];
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < KT; ++kk) {
        float xh[4], ch[2], sh[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) xh[i] = xs_hi[(fg * 4 + i) * XS + kk];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          ch[q] = bs_hi[kk * 2 * NB + lane * 2 + q];
          sh[q] = bs_hi[kk * 2 * NB + NB + lane * 2 + q];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            re[i][q] = fmaf(xh[i], ch[q], re[i][q]);
            im[i][q] = fmaf(xh[i], sh[q], im[i][q]);
          }
        if (BF16X3) {
          float xl[4], cl[2], sl[2];
#pragma unroll
          for (int i = 0; i < 4; ++i) xl[i] = xs_lo[(fg * 4 + i) * XS + kk];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            cl[q] = bs_lo[kk * 2 * NB + lane * 2 + q];
            sl[q] = bs_lo[kk * 2 * NB + NB + lane * 2 + q];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              re_c[i][q] = fmaf(xh[i], cl[q], fmaf(xl[i], ch[q], re_c[i][q]));
              im_c[i][q] = fmaf(xh[i], sl[q], fmaf(xl[i], sh[q], im_c[i][q]));
            }
        }
      }
      __syncthreads();
    }

    // power of this chunk, and the banks^T rows it meets
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float r = re[i][q] + re_c[i][q];
        const float m = im[i][q] + im_c[i][q];
        ps[(fg * 4 + i) * PS + lane * 2 + q] = r * r + m * m;
      }
    for (int e = tid; e < NB * n_mels; e += THREADS)
      bt[e] = banks_t[(size_t)j0 * n_mels + e];
    __syncthreads();
    for (int kk = 0; kk < NB; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(fg * 4 + i) * PS + kk];
#pragma unroll
      for (int j = 0; j < MAX_MJ; ++j) {
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
    for (int j = 0; j < MAX_MJ; ++j) {
      const int m = lane + 16 * j;
      if (m < n_mels) o[(size_t)m * n_frames + f] = (logf(acc[i][j] + 1e-5f) + 4.5f) / 5.0f;
    }
  }
}

template <bool BF16X3>
cudaError_t launch(const float* wave, int B, int S, int hop, int n_frames,
                   const void* basis, const void* bhi, const void* blo,
                   const float* banks_t, int n_mels, float* out, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(BF16X3, n_mels);
  cudaError_t err = cudaFuncSetAttribute(
      mel_kernel<BF16X3>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_frames + TF - 1) / TF, B);
  mel_kernel<BF16X3><<<grid, THREADS, smem, stream>>>(
      wave, S, hop, n_frames, static_cast<const float*>(basis),
      static_cast<const __nv_bfloat16*>(bhi), static_cast<const __nv_bfloat16*>(blo),
      banks_t, n_mels, out);
  return cudaGetLastError();
}

}  // namespace

// wave (B, S) f32; basis (1024, 1024) f32 when bf16x3 == 0, else bhi/blo
// (1024, 1024) bf16; banks_t (512, n_mels) f32; out (B, n_mels, n_frames) f32.
// All contiguous on the device. Returns the launch's cudaError_t (0 = success).
extern "C" int eat_mel_log(const float* wave, int B, int S, int hop, int n_frames,
                           const void* basis, const void* bhi, const void* blo,
                           int bf16x3, const float* banks_t, int n_mels, float* out,
                           void* stream) {
  if (B < 1 || B > 65535 || n_frames < 1 || n_mels < 1 || n_mels > MAX_MELS || hop < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16x3)
    return (int)launch<true>(wave, B, S, hop, n_frames, basis, bhi, blo, banks_t,
                             n_mels, out, s);
  return (int)launch<false>(wave, B, S, hop, n_frames, basis, bhi, blo, banks_t,
                            n_mels, out, s);
}

extern "C" const char* eat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
