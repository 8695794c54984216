// BatchNorm2d, CUDA C++ for Hopper (sm_90a): training mode, forward and
// backward, and eval mode with the elementwise chain behind it (below).
// ops/batch_norm.py binds it (ctypes) and wraps training mode in a
// torch.autograd.Function; models/layers.py::BatchNorm2d calls it for a
// CUDA input, in training mode and in eval mode (where autograd records,
// the eval kernel without a chain, whose backward is the eval kernel on dy
// and the training backward's sums: ops/batch_norm.py::BatchNormEval).
//
// It replaces no TPU kernel: on the TPU, XLA fused the JAX package's
// BatchNorm into the surrounding ops. It was added because cuDNN's NCHW
// training kernels (bn_fw_tr_1C11, bn_bw_1C11) took 48.45 ms of the
// mn10_as KD train step's 126.4 at B = 120 on an H100, 38 % of the step,
// at 46 % (forward) and at most 21 % (backward) of the HBM bandwidth.
// They reduce a channel in one block of 512 threads (a train step's trace:
// grid = C blocks in every layer), so with 16 or 64 channels of 3.84 M
// values each (the four 64 x 500 layers, 59 % of cuDNN's BN time) most of
// the 132 SMs idle.
//
// What bounds it: the bytes. A forward reads x twice (statistics, then the
// normalisation) and writes y; a backward reads x and dy twice (the two
// sums, then dx) and writes dx: 3 and 5 passes over the layer's input at
// 3.35 TB/s.
//
// The design: the grid is (chunk, channel). A channel's N x H x W values
// are cut into `chunks` contiguous runs of (n, h, w) so that the grid
// holds a few blocks an SM (ops/batch_norm.py::plan). A
// thread reads 16 bytes at a time along a contiguous (n, c) plane (4 fp32
// or 8 bf16 values; one value at a time where H x W or the base pointer
// does not allow it), UNROLL loads in flight. Each block writes its run's
// partial result, the forward's Welford (count, mean, M2) or the
// backward's sums of dy and dy (x - mean), to scratch; the channel's block
// that finishes last (an atomic ticket a channel, set back to 0 for the
// next call) merges the channel's partials in a fixed order, in fp64
// (Chan's formula in the forward), and writes the channel's results:
// forward the batch mean and 1 / sqrt(var + eps), the running statistics
// (unbiased variance, n / (n - 1)); backward dgamma, dbeta and the two
// coefficients of dx. No float atomics, so a call gives the same bits
// every time. A second kernel on the same grid then streams x (and dy)
// once more and writes y (dx). The wrapper picks the chunks from the shape
// alone.
//
// Measured (tools/time_bn.py's timing as chip_smoke.py's phase 24 runs it,
// one H100 80GB HBM3 at 700 W, mn10_as's 46 layers at B = 120, fp32):
// forward 6.24 ms and backward 10.02 ms a step against cuDNN's 13.71 and
// 37.23 and the bound of 4.84 and 8.07; the 64 x 500 layers at 77-86 % of
// that bound.
//
// Statistics, gamma, beta and the running buffers are fp32; x, y, dy and
// dx are fp32 or bf16 (a bf16 x under autocast gives a bf16 y, as
// F.batch_norm does). Per thread, the forward keeps a running Welford
// triple in fp32, merging each pack's own mean and M2 into it; the
// backward sums each batch of loads in fp32 and the batches in fp64. The
// merges across threads and blocks are fp64.
//
// Eval mode (bn_eval, eat_bn_eval): BatchNorm with the running statistics
// is an affine map a channel, and what follows it up to the next conv in
// MN and DyMN is elementwise: ReLU or Hardswish; the block's input added
// back; DyMN's DyReLU-B (max over m of y a_m[n,c] + b_m[n,c]) and its
// coordinate attention (y sigmoid(g_f[n,c,f]) sigmoid(g_t[n,c,t])). One
// kernel reads x once, applies the map and the chain (a compile-time
// epilogue, EPI_*), and writes the result once; the residual is the only
// other full-size read. Eager PyTorch ran each step as a pass of its own
// through device memory (cuDNN's bn_fw_inf, then up to seven ATen passes
// in a DyMN block). Bound: the bytes, 2 passes over x (3 with the
// residual) at 3.35 TB/s. Design: a block takes a run of whole NCHW
// (n, c) planes (`planes` of them, several where a plane is small, so
// that the grid holds a few blocks an SM; ops/batch_norm.py::eval_plan);
// its first threads build each plane's coefficients in shared memory:
// scale and shift from gamma, beta, the running statistics and eps (in
// fp64, as the module's parameters may change between calls, nothing is
// cached), DyReLU's a_m and b_m from coef_net's raw output (2 sigmoid - 1,
// its lambdas and init), and the sigmoid of each gate of the plane's F
// rows and T columns. Then each thread streams 16-byte packs of the run
// (one value at a time where H x W or a base pointer does not allow it),
// UNROLL in flight. The chain keeps the order of operations the models ran
// op by op, (y sigmoid(g_f)) sigmoid(g_t), in fp32, and rounds once to T.
// (Loading a thread's first packs before the coefficient build was slower:
// 9.12 against 8.90 ms over dymn10_as's 61 calls at B = 256, fp32, on one
// H100 80GB HBM3 at 700 W.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // a block
constexpr int UNROLL = 4;     // 16-byte loads a thread has in flight
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC values of one plane, loaded and stored as one access of
// VEC * sizeof(T) bytes (16, or one value)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// group g (VEC values) of channel c: plane n = g / hwv of the (N, C, HW)
// input, values (g % hwv) * VEC ..
template <int VEC>
__device__ __forceinline__ size_t offset(int c, int g, int C, int HW, int hwv) {
  const int n = g / hwv;
  return ((size_t)n * C + c) * HW + (size_t)(g - n * hwv) * VEC;
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const void* base, size_t off) {
  return *reinterpret_cast<const Pack<T, VEC>*>(static_cast<const T*>(base) + off);
}

template <typename T, int VEC>
__device__ __forceinline__ void store(void* base, size_t off, const Pack<T, VEC>& p) {
  *reinterpret_cast<Pack<T, VEC>*>(static_cast<T*>(base) + off) = p;
}

// ------------------------------------------------------------ reductions

// Welford's partial result of a set of values
struct Stat {
  double n, mean, m2;
};

// Chan's formula: the partial result of the union of two sets
__device__ __forceinline__ Stat merge(Stat a, Stat b) {
  if (b.n == 0.0) return a;
  if (a.n == 0.0) return b;
  const double n = a.n + b.n, d = b.mean - a.mean, r = b.n / n;
  return Stat{n, a.mean + d * r, a.m2 + b.m2 + d * d * a.n * r};
}

// a thread's pack of VEC values into its running fp32 (n, mean, m2): the
// pack's own mean and M2 first, then Chan's formula, one division a pack
template <int VEC>
__device__ __forceinline__ void welford(const float (&v)[VEC], float& n, float& mean, float& m2) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) s += v[i];
  const float pm = s * (1.f / VEC);
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) q = fmaf(v[i] - pm, v[i] - pm, q);
  const float nn = n + VEC, d = pm - mean, r = __fdividef((float)VEC, nn);
  mean = fmaf(d, r, mean);
  m2 += q + d * d * n * r;
  n = nn;
}

// lane 0 ends with the merge of the warp's 32 in a fixed order
__device__ __forceinline__ Stat warp_merge(Stat s) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    s = merge(s, Stat{__shfl_down_sync(FULL, s.n, off), __shfl_down_sync(FULL, s.mean, off),
                      __shfl_down_sync(FULL, s.m2, off)});
  return s;
}

__device__ __forceinline__ double2 warp_sum(double2 s) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    s.x += __shfl_down_sync(FULL, s.x, off);
    s.y += __shfl_down_sync(FULL, s.y, off);
  }
  return s;
}

// thread 0 ends with the block's merge; every thread must call it
template <int NT>
__device__ __forceinline__ Stat block_merge(Stat s, Stat* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();  // red may still be read by a reduction before this one
  s = warp_merge(s);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (warp == 0) s = warp_merge(lane < NT / 32 ? red[lane] : Stat{0.0, 0.0, 0.0});
  return s;
}

template <int NT>
__device__ __forceinline__ double2 block_sum(double2 s, double2* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();
  s = warp_sum(s);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (warp == 0) s = warp_sum(lane < NT / 32 ? red[lane] : make_double2(0.0, 0.0));
  return s;
}

// the channel's block that finishes last takes the channel's partials:
// called by every thread after thread 0 wrote this block's; returns true in
// the last block, whose first warp then reads the partials with __ldcg
__device__ __forceinline__ bool last_of_channel(unsigned* done, int c, int chunks) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done + c, 1u) == (unsigned)chunks - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// ------------------------------------------------------------ arguments

struct Shape {
  int C, HW, groups;  // groups: a channel's N * HW / VEC
  int chunk;          // groups a block
};

struct Forward {
  const void* x;
  void* y;
  const float *weight, *bias;
  float *running_mean, *running_var;
  double factor, eps;
  float *mean, *invstd;  // saved for the backward, (C)
  double* partial;       // (C, chunks, 3)
  unsigned* done;        // (C), 0 between calls
};

struct Backward {
  const void *x, *dy;
  void* dx;  // null: no dx
  const float *weight, *mean, *invstd;
  float *dweight, *dbias;
  float* coef;      // (C, 2): mean(dy), and the factor of x - mean in dx
  double* partial;  // (C, chunks, 2)
  unsigned* done;
};

// the channel's statistics from the merge of all its values
__device__ void finish_forward(const Forward& a, int c, Stat s) {
  const double var = fmax(s.m2 / s.n, 0.0), f = a.factor;
  a.mean[c] = (float)s.mean;
  a.invstd[c] = (float)(1.0 / sqrt(var + a.eps));
  a.running_mean[c] = (float)((1.0 - f) * a.running_mean[c] + f * s.mean);
  a.running_var[c] = (float)((1.0 - f) * a.running_var[c] + f * var * s.n / (s.n - 1.0));
}

// dgamma = sum(dy xhat), dbeta = sum(dy) and dx = k1 (dy - mean(dy)) -
// k3 (x - mean), k1 = gamma invstd, k3 = gamma invstd^3 sum(dy (x - mean)) / n
// (t.x = sum(dy), t.y = sum(dy (x - mean)))
__device__ void finish_backward(const Backward& a, int c, double2 t, double n) {
  const double invstd = a.invstd[c], gamma = a.weight[c];
  a.dweight[c] = (float)(t.y * invstd);
  a.dbias[c] = (float)t.x;
  a.coef[2 * c] = (float)(t.x / n);
  a.coef[2 * c + 1] = (float)(gamma * invstd * invstd * invstd * t.y / n);
}

// ------------------------------------------------------------ kernels

// the (n, mean, M2) of chunk blockIdx.x of channel blockIdx.y
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS) bn_forward_stats(Shape sh, Forward a) {
  __shared__ Stat red[THREADS / 32];
  const int k = blockIdx.x, c = blockIdx.y, chunks = gridDim.x, hwv = sh.HW / VEC;
  const int g0 = k * sh.chunk, g1 = min(sh.groups, g0 + sh.chunk);
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int g = g0 + threadIdx.x; g < g1; g += THREADS * UNROLL) {
    Pack<T, VEC> p[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (g + u * THREADS < g1) p[u] = load<T, VEC>(a.x, offset<VEC>(c, g + u * THREADS, sh.C, sh.HW, hwv));
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (g + u * THREADS < g1) {
        float v[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[i] = to_f(p[u].v[i]);
        welford<VEC>(v, n, mean, m2);
      }
  }
  Stat s = block_merge<THREADS>(Stat{n, mean, m2}, red);
  if (chunks > 1) {
    if (threadIdx.x == 0) {
      double* pp = a.partial + 3 * ((size_t)c * chunks + k);
      pp[0] = s.n;
      pp[1] = s.mean;
      pp[2] = s.m2;
    }
    if (!last_of_channel(a.done, c, chunks) || threadIdx.x >= 32) return;
    s = Stat{0.0, 0.0, 0.0};
    for (int j = threadIdx.x; j < chunks; j += 32) {
      const double* pp = a.partial + 3 * ((size_t)c * chunks + j);
      s = merge(s, Stat{__ldcg(pp), __ldcg(pp + 1), __ldcg(pp + 2)});
    }
    s = warp_merge(s);
    if (threadIdx.x == 0) a.done[c] = 0;
  }
  if (threadIdx.x == 0) finish_forward(a, c, s);
}

// y = (x - mean) gamma invstd + beta over chunk blockIdx.x of channel blockIdx.y
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS) bn_forward_apply(Shape sh, Forward a) {
  const int k = blockIdx.x, c = blockIdx.y, hwv = sh.HW / VEC;
  const int g0 = k * sh.chunk, g1 = min(sh.groups, g0 + sh.chunk);
  const float mean = a.mean[c], scale = a.weight[c] * a.invstd[c], shift = a.bias[c];
  for (int g = g0 + threadIdx.x; g < g1; g += THREADS * UNROLL) {
    Pack<T, VEC> p[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (g + u * THREADS < g1) p[u] = load<T, VEC>(a.x, offset<VEC>(c, g + u * THREADS, sh.C, sh.HW, hwv));
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (g + u * THREADS < g1) {
        Pack<T, VEC> q;
#pragma unroll
        for (int i = 0; i < VEC; ++i) q.v[i] = from_f<T>(fmaf(to_f(p[u].v[i]) - mean, scale, shift));
        store<T, VEC>(a.y, offset<VEC>(c, g + u * THREADS, sh.C, sh.HW, hwv), q);
      }
  }
}

// sum(dy) and sum(dy (x - mean)) of chunk blockIdx.x of channel blockIdx.y
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS) bn_backward_reduce(Shape sh, Backward a) {
  __shared__ double2 red[THREADS / 32];
  const int k = blockIdx.x, c = blockIdx.y, chunks = gridDim.x, hwv = sh.HW / VEC;
  const int g0 = k * sh.chunk, g1 = min(sh.groups, g0 + sh.chunk);
  const float mean = a.mean[c];
  double sdy = 0.0, sdx = 0.0;
  for (int g = g0 + threadIdx.x; g < g1; g += THREADS * UNROLL) {
    Pack<T, VEC> px[UNROLL], pd[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (g + u * THREADS < g1) {
        const size_t off = offset<VEC>(c, g + u * THREADS, sh.C, sh.HW, hwv);
        px[u] = load<T, VEC>(a.x, off);
        pd[u] = load<T, VEC>(a.dy, off);
      }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (g + u * THREADS < g1) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float d = to_f(pd[u].v[i]);
          s1 += d;
          s2 = fmaf(d, to_f(px[u].v[i]) - mean, s2);
        }
      }
    sdy += s1;
    sdx += s2;
  }
  double2 t = block_sum<THREADS>(make_double2(sdy, sdx), red);
  if (chunks > 1) {
    if (threadIdx.x == 0) {
      double* pp = a.partial + 2 * ((size_t)c * chunks + k);
      pp[0] = t.x;
      pp[1] = t.y;
    }
    if (!last_of_channel(a.done, c, chunks) || threadIdx.x >= 32) return;
    t = make_double2(0.0, 0.0);
    for (int j = threadIdx.x; j < chunks; j += 32) {
      const double* pp = a.partial + 2 * ((size_t)c * chunks + j);
      t.x += __ldcg(pp);
      t.y += __ldcg(pp + 1);
    }
    t = warp_sum(t);
    if (threadIdx.x == 0) a.done[c] = 0;
  }
  if (threadIdx.x == 0) finish_backward(a, c, t, (double)sh.groups * VEC);
}

// dx over chunk blockIdx.x of channel blockIdx.y
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS) bn_backward_apply(Shape sh, Backward a) {
  const int k = blockIdx.x, c = blockIdx.y, hwv = sh.HW / VEC;
  const int g0 = k * sh.chunk, g1 = min(sh.groups, g0 + sh.chunk);
  const float mean = a.mean[c], k1 = a.weight[c] * a.invstd[c], mdy = a.coef[2 * c],
              k3 = a.coef[2 * c + 1];
  for (int g = g0 + threadIdx.x; g < g1; g += THREADS * UNROLL) {
    Pack<T, VEC> px[UNROLL], pd[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (g + u * THREADS < g1) {
        const size_t off = offset<VEC>(c, g + u * THREADS, sh.C, sh.HW, hwv);
        px[u] = load<T, VEC>(a.x, off);
        pd[u] = load<T, VEC>(a.dy, off);
      }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (g + u * THREADS < g1) {
        Pack<T, VEC> q;
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          q.v[i] = from_f<T>(
              fmaf(k1, to_f(pd[u].v[i]) - mdy, -k3 * (to_f(px[u].v[i]) - mean)));
        store<T, VEC>(a.dx, offset<VEC>(c, g + u * THREADS, sh.C, sh.HW, hwv), q);
      }
  }
}

// ------------------------------------------------------------ launches

template <typename T, int VEC>
cudaError_t forward(const Shape& sh, const Forward& a, int chunks, cudaStream_t stream) {
  const dim3 grid(chunks, sh.C);
  bn_forward_stats<T, VEC><<<grid, THREADS, 0, stream>>>(sh, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_forward_apply<T, VEC><<<grid, THREADS, 0, stream>>>(sh, a);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t backward(const Shape& sh, const Backward& a, int chunks, cudaStream_t stream) {
  const dim3 grid(chunks, sh.C);
  bn_backward_reduce<T, VEC><<<grid, THREADS, 0, stream>>>(sh, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.dx == nullptr) return err;
  bn_backward_apply<T, VEC><<<grid, THREADS, 0, stream>>>(sh, a);
  return cudaGetLastError();
}

// the plan's numbers against the shape: vec 1 or 16 bytes of T; a chunk a
// whole number of groups covering the channel in `chunks` blocks
bool valid(int N, int C, int HW, int vec, int bytes, int chunk, int chunks, Shape* sh) {
  if (N < 1 || C < 1 || C > 65535 || HW < 1 || (long long)N * HW < 2 ||
      (long long)N * HW > 0x7fffffffLL || (vec != 1 && vec * bytes != 16) || HW % vec != 0)
    return false;
  sh->C = C;
  sh->HW = HW;
  sh->groups = (int)((long long)N * HW / vec);
  sh->chunk = chunk;
  return chunk >= 1 && chunks >= 1 &&
         (long long)chunk * (chunks - 1) < sh->groups && (long long)chunk * chunks >= sh->groups;
}

// ------------------------------------------------------------ eval mode

// the epilogue after y = x scale[c] + shift[c] (ops/batch_norm.py::EPILOGUES)
enum : int {
  EPI_NONE,
  EPI_RELU,
  EPI_HARDSWISH,
  EPI_RESIDUAL,
  EPI_DYRELU,
  EPI_DYRELU_CA,
  EPI_RELU_CA,
  EPI_HARDSWISH_CA,
  EPI_COUNT
};
constexpr int MAX_M = 4;        // DyReLU's pieces
constexpr int MAX_PLANES = 64;  // planes a block
constexpr int COEFS = 2 + 2 * MAX_M;

template <int E>
struct Epi {
  static constexpr int act = (E == EPI_RELU || E == EPI_RELU_CA)           ? 1
                             : (E == EPI_HARDSWISH || E == EPI_HARDSWISH_CA) ? 2
                                                                             : 0;
  static constexpr bool dyrelu = E == EPI_DYRELU || E == EPI_DYRELU_CA;
  static constexpr bool ca = E == EPI_DYRELU_CA || E == EPI_RELU_CA || E == EPI_HARDSWISH_CA;
  static constexpr bool residual = E == EPI_RESIDUAL;
};

struct Eval {
  const void* x;
  void* y;
  const void* residual;  // (N, C, H, W) as x, or null
  const float *weight, *bias, *mean, *var;
  double eps;
  const void* coef;            // (N, C, 2M) coef_net's output, or null
  const void *gate_f, *gate_t;  // (N, C, H) and (N, C, W) before the sigmoid, or null
  int C, H, W, HW, planes_total, M, planes;
};

// torch's float sigmoid and hardswish, in the same order of operations
__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }
__device__ __forceinline__ float hardswish(float v) {
  return v * fminf(fmaxf(v + 3.f, 0.f), 6.f) / 6.f;
}

// planes blockIdx.x * planes .. of the (N * C) planes of x
template <typename T, int VEC, int E>
__global__ void __launch_bounds__(THREADS) bn_eval(Eval a) {
  using P = Epi<E>;
  extern __shared__ float sig[];  // (planes, H + W): sigmoid of each plane's gates
  __shared__ float coef[MAX_PLANES][COEFS];  // scale, shift, a_0.., b_0..
  const int p0 = blockIdx.x * a.planes, np = min(a.planes, a.planes_total - p0);
  for (int lp = threadIdx.x; lp < np; lp += THREADS) {
    const int p = p0 + lp, c = p % a.C;
    const double s = (double)a.weight[c] / sqrt((double)a.var[c] + a.eps);
    coef[lp][0] = (float)s;
    coef[lp][1] = (float)((double)a.bias[c] - (double)a.mean[c] * s);
    if (P::dyrelu) {
      // theta = 2 sigmoid - 1; a = theta + (1, 0, ..), b = theta / 2
      const T* k = static_cast<const T*>(a.coef) + (size_t)p * 2 * a.M;
      for (int m = 0; m < a.M; ++m) {
        const float ta = 2.f * sigmoid(to_f(k[m])) - 1.f;
        coef[lp][2 + m] = m == 0 ? ta + 1.f : ta;
        coef[lp][2 + MAX_M + m] = 0.5f * (2.f * sigmoid(to_f(k[a.M + m])) - 1.f);
      }
    }
  }
  const int rc = a.H + a.W;
  if (P::ca)
    for (int i = threadIdx.x; i < np * rc; i += THREADS) {
      const int lp = i / rc, j = i - lp * rc;
      const size_t p = p0 + lp;
      sig[i] = sigmoid(j < a.H ? to_f(static_cast<const T*>(a.gate_f)[p * a.H + j])
                               : to_f(static_cast<const T*>(a.gate_t)[p * a.W + (j - a.H)]));
    }
  __syncthreads();
  const size_t base = (size_t)p0 * a.HW;
  const int groups = np * a.HW / VEC;
  for (int g = threadIdx.x; g < groups; g += THREADS * UNROLL) {
    Pack<T, VEC> px[UNROLL], pr[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (g + u * THREADS < groups) {
        const size_t off = base + (size_t)(g + u * THREADS) * VEC;
        px[u] = load<T, VEC>(a.x, off);
        if (P::residual) pr[u] = load<T, VEC>(a.residual, off);
      }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (g + u * THREADS < groups) {
        const int e = (g + u * THREADS) * VEC, lp = e / a.HW, j0 = e - lp * a.HW;
        const float* k = coef[lp];
        Pack<T, VEC> q;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          float v = fmaf(to_f(px[u].v[i]), k[0], k[1]);
          if (P::act == 1) v = v < 0.f ? 0.f : v;
          if (P::act == 2) v = hardswish(v);
          if (P::dyrelu) {
            float o = fmaf(v, k[2], k[2 + MAX_M]);
#pragma unroll
            for (int m = 1; m < MAX_M; ++m)
              if (m < a.M) o = fmaxf(o, fmaf(v, k[2 + m], k[2 + MAX_M + m]));
            v = o;
          }
          if (P::ca) {
            const int j = j0 + i, f = j / a.W;
            const float* s = sig + lp * rc;
            v = v * s[f] * s[a.H + (j - f * a.W)];
          }
          if (P::residual) v += to_f(pr[u].v[i]);
          q.v[i] = from_f<T>(v);
        }
        store<T, VEC>(a.y, base + (size_t)(g + u * THREADS) * VEC, q);
      }
  }
}

template <typename T, int VEC, int E>
cudaError_t eval_launch(const Eval& a, cudaStream_t stream) {
  const int blocks = (a.planes_total + a.planes - 1) / a.planes;
  const size_t smem = Epi<E>::ca ? sizeof(float) * a.planes * (a.H + a.W) : 0;
  bn_eval<T, VEC, E><<<blocks, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t eval_epilogue(int epilogue, const Eval& a, cudaStream_t s) {
  switch (epilogue) {
    case EPI_NONE: return eval_launch<T, VEC, EPI_NONE>(a, s);
    case EPI_RELU: return eval_launch<T, VEC, EPI_RELU>(a, s);
    case EPI_HARDSWISH: return eval_launch<T, VEC, EPI_HARDSWISH>(a, s);
    case EPI_RESIDUAL: return eval_launch<T, VEC, EPI_RESIDUAL>(a, s);
    case EPI_DYRELU: return eval_launch<T, VEC, EPI_DYRELU>(a, s);
    case EPI_DYRELU_CA: return eval_launch<T, VEC, EPI_DYRELU_CA>(a, s);
    case EPI_RELU_CA: return eval_launch<T, VEC, EPI_RELU_CA>(a, s);
    default: return eval_launch<T, VEC, EPI_HARDSWISH_CA>(a, s);
  }
}

}  // namespace

// Training-mode forward of x (N, C, H, W), contiguous, dtype 0 (fp32) or 1
// (bf16), HW = H * W: y (same shape and dtype), save_mean and save_invstd
// (C) fp32, running_mean and running_var (C) fp32 updated in place with
// factor (momentum). vec: values a load (1, or 16 bytes' worth where HW is
// a multiple and x and y 16-byte aligned); chunk: groups of vec values a
// block, chunks: blocks a channel. partial: (C, chunks, 3) fp64 scratch,
// unread where chunks is 1; done: (C) u32, zero, and zero again when
// the launch ends (launches on one stream may share it). Returns the
// launches' cudaError_t (0 = success; cudaErrorInvalidValue for a plan
// that does not fit the shape).
extern "C" int eat_bn_forward(const void* x, int dtype, int N, int C, int HW, int vec, int chunk,
                              int chunks, const float* weight, const float* bias,
                              float* running_mean, float* running_var, double factor, double eps,
                              void* y, float* save_mean, float* save_invstd, double* partial,
                              unsigned* done, void* stream) {
  Shape sh;
  if ((dtype != 0 && dtype != 1) ||
      !valid(N, C, HW, vec, dtype == 0 ? 4 : 2, chunk, chunks, &sh))
    return (int)cudaErrorInvalidValue;
  const Forward a{x,     y,   weight,    bias,        running_mean, running_var,
                  factor, eps, save_mean, save_invstd, partial,      done};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(vec == 1 ? forward<float, 1>(sh, a, chunks, s)
                          : forward<float, 4>(sh, a, chunks, s));
  return (int)(vec == 1 ? forward<__nv_bfloat16, 1>(sh, a, chunks, s)
                        : forward<__nv_bfloat16, 8>(sh, a, chunks, s));
}

// The backward of eat_bn_forward: from x, dy (the same shape, dtype and
// layout), weight, and the forward's save_mean and save_invstd, dweight and
// dbias (C) fp32 and, where dx is not null, dx (x's shape and dtype).
// coef: (C, 2) fp32 scratch; partial: (C, chunks, 2) fp64 scratch; done as
// the forward's.
extern "C" int eat_bn_backward(const void* x, const void* dy, int dtype, int N, int C, int HW,
                               int vec, int chunk, int chunks, const float* weight,
                               const float* save_mean, const float* save_invstd, void* dx,
                               float* dweight, float* dbias, float* coef, double* partial,
                               unsigned* done, void* stream) {
  Shape sh;
  if ((dtype != 0 && dtype != 1) ||
      !valid(N, C, HW, vec, dtype == 0 ? 4 : 2, chunk, chunks, &sh))
    return (int)cudaErrorInvalidValue;
  const Backward a{x, dy, dx, weight, save_mean, save_invstd, dweight, dbias, coef, partial, done};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(vec == 1 ? backward<float, 1>(sh, a, chunks, s)
                          : backward<float, 4>(sh, a, chunks, s));
  return (int)(vec == 1 ? backward<__nv_bfloat16, 1>(sh, a, chunks, s)
                        : backward<__nv_bfloat16, 8>(sh, a, chunks, s));
}

// Eval-mode BatchNorm of x (N, C, H, W), contiguous, dtype 0 (fp32) or 1
// (bf16), with the running statistics, then `epilogue` (EPI_*): y (x's
// shape and dtype) = chain(x scale[c] + shift[c]), scale = weight /
// sqrt(var + eps), shift = bias - mean scale. residual (EPI_RESIDUAL), coef
// (EPI_DYRELU*: (N, C, 2 m) raw, 1 <= m <= 4) and gate_f, gate_t (the *_CA
// epilogues: (N, C, H) and (N, C, W) before the sigmoid) are contiguous
// and of x's dtype; the others may be null. vec: values a load (1, or 16
// bytes' worth where H * W is a multiple and x, y and residual are 16-byte
// aligned); planes: (n, c) planes a block, 1..64, with planes * H * W
// under 2**31 and, for the *_CA epilogues, planes * (H + W) floats of
// shared memory within 48 KB. Returns the launch's cudaError_t
// (cudaErrorInvalidValue for arguments it does not take).
extern "C" int eat_bn_eval(const void* x, int dtype, int N, int C, int H, int W, int vec,
                           int planes, int epilogue, const float* weight, const float* bias,
                           const float* mean, const float* var, double eps, const void* residual,
                           const void* coef, int m, const void* gate_f, const void* gate_t,
                           void* y, void* stream) {
  const long long hw = (long long)H * W, total = (long long)N * C;
  const int bytes = dtype == 0 ? 4 : 2;
  const bool ca = epilogue == EPI_DYRELU_CA || epilogue == EPI_RELU_CA ||
                  epilogue == EPI_HARDSWISH_CA;
  const bool dyrelu = epilogue == EPI_DYRELU || epilogue == EPI_DYRELU_CA;
  if ((dtype != 0 && dtype != 1) || epilogue < 0 || epilogue >= EPI_COUNT || N < 1 || C < 1 ||
      H < 1 || W < 1 || total > 0x7fffffffLL || planes < 1 || planes > MAX_PLANES ||
      planes * hw > 0x7fffffffLL || (vec != 1 && vec * bytes != 16) || hw % vec != 0 ||
      (epilogue == EPI_RESIDUAL && residual == nullptr) ||
      (dyrelu && (coef == nullptr || m < 1 || m > MAX_M)) ||
      (ca && (gate_f == nullptr || gate_t == nullptr ||
              (long long)planes * (H + W) * sizeof(float) > 48 * 1024)))
    return (int)cudaErrorInvalidValue;
  const Eval a{x,   y,     residual, weight, bias, mean, var,       eps,         coef,
               gate_f, gate_t, C,    H,      W,    (int)hw, (int)total, dyrelu ? m : 0, planes};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(vec == 1 ? eval_epilogue<float, 1>(epilogue, a, s)
                          : eval_epilogue<float, 4>(epilogue, a, s));
  return (int)(vec == 1 ? eval_epilogue<__nv_bfloat16, 1>(epilogue, a, s)
                        : eval_epilogue<__nv_bfloat16, 8>(epilogue, a, s));
}

extern "C" const char* eat_bn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
