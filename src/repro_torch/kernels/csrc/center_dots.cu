// Batch x truncated-center kernel contractions for Algorithm 2, f32 on the
// CUDA cores of an sm_90a card.  Plain C entry points, loaded with ctypes
// (repro_torch/kernels/_build.py).
//
// Replaces two TPU kernels of the JAX package:
//   K1  src/repro/kernels/fused_step.py   streaming_assign_pallas
//       (body _stream_body): per batch row, the running min and argmin
//       over centers j of  diag_b - 2 * sum_w coef[j,w] K(x, sup[j,w]) +
//       sqnorm[j]   ->  rk_streaming_assign
//   K2  src/repro/kernels/fused_assign.py fused_batch_center_dots_pallas
//       (body _fused_body): P[i,j] = sum_w coef[j,w] K(x_i, sup[j,w])
//       ->  rk_batch_center_dots
// Both run one device routine, center_dot(): K1 folds its result into a
// running best/argmin, K2 writes it out.
//
// What bounds it.  At the main-path shape (b=4096, k=10, W=4296, d=784)
// one pass is 2*b*k*W*d = 2.76e11 f32 operations against about 147 MB of
// operands (x 13 MB, sup 135 MB): about 1900 operations per byte, far
// above the card's f32 balance point (67 TFLOP/s over 3.35 TB/s = 20), so
// the kernel is bound by f32 FMA throughput, not by memory.
//
// What the design does about that.  The Pallas grid (b/bt, k, W/st) ran in
// order on one TPU core and carried the argmin in a resident output block;
// blocks on Hopper run in parallel and in no order, so the loop over
// centers and window tiles moves INSIDE the block and nothing crosses
// blocks (no atomics: deterministic).  Each block owns BT=32 batch rows;
// 256 threads each hold a 4x4 register tile of the (BT, ST=128) cross
// products, fed from shared memory by one float4 of x and one float4 of
// the support tile per coordinate, with a warp laid out as 4 row groups x
// 8 column groups so that a warp's shared-memory reads are two 128-byte
// wavefronts per 16 FMAs — the inner loop is FMA-bound, not bound by
// shared memory.  d streams through shared memory in chunks of DK=32: at
// d=784 a whole (ST, d) support tile alone would take 401 KB, beyond the
// 227 KB a block can have.  The kernel function and the coefficient contraction run in
// registers on the finished tile, each thread keeping a per-row partial
// sum over its columns; one shuffle + shared-memory reduction per center
// gives the row's <phi(x), C_j>.  The (b, k*W) strip and, for K1, the
// (b, k) distances never reach device memory.  Ragged edges of b, W and d
// are masked in the kernel instead of padded.  No TF32, no tensor cores:
// wgmma, TMA, bf16 and in-kernel support gathers are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BT = 32;       // batch rows per block
constexpr int ST = 128;      // support rows per window tile
constexpr int DK = 32;       // coordinates per shared-memory chunk
constexpr int NT = 256;      // threads per block
constexpr int XS = BT + 4;   // padded row stride of the x chunk (16B aligned)
constexpr int SS = ST + 4;   // padded row stride of the support chunk

constexpr int KIND_GAUSSIAN = 0;
constexpr int KIND_LINEAR = 1;
constexpr int KIND_POLYNOMIAL = 2;

struct Params {
  int kind;
  float p0;   // gaussian: kappa; polynomial: bias
  float p1;   // polynomial: scale
  int p2;     // polynomial: integer degree (>= 0)
};

// x**y for an integer y >= 0 in the square-and-multiply order of JAX's
// integer power.
__device__ __forceinline__ float int_pow(float x, int y) {
  if (y == 0) return 1.0f;
  float acc = 0.0f;
  bool have = false;
  while (y > 0) {
    if (y & 1) {
      acc = have ? acc * x : x;
      have = true;
    }
    y >>= 1;
    if (y > 0) x = x * x;
  }
  return acc;
}

// fused_assign._apply_kernel: the kernel value from a cross product and
// the two squared norms.
__device__ __forceinline__ float apply_kernel(float xy, float xsq, float ysq,
                                              const Params& p) {
  if (p.kind == KIND_GAUSSIAN) {
    float d2 = fmaxf(xsq + ysq - 2.0f * xy, 0.0f);
    return expf(-d2 / p.p0);
  }
  if (p.kind == KIND_LINEAR) return xy;
  return int_pow(xy / p.p1 + p.p0, p.p2);
}

struct Smem {
  float xs[DK * XS];       // x chunk, transposed: [coordinate][row]
  float ss[DK * SS];       // support chunk, transposed: [coordinate][slot]
  float red[4 * BT];       // per-warp-column partial row sums
};

// For the block's rows [r0, r0+BT) and center j: returns
// sum_w coef[j,w] K(x[r0+t], sup[j,w]) in thread t < BT (0 elsewhere).
// Every thread of the block must call it.
__device__ float center_dot(const float* __restrict__ x,
                            const float* __restrict__ xsq,
                            const float* __restrict__ sup,
                            const float* __restrict__ supsq,
                            const float* __restrict__ coef, int b, int W,
                            int d, int r0, int j, const Params& prm,
                            Smem& sm) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  // warp = 4 row groups x 8 column groups; block = 8 x 32 groups
  const int ty = (wid >> 2) * 4 + (lane >> 3);   // rows 4*ty .. 4*ty+3
  const int tx = (wid & 3) * 8 + (lane & 7);     // cols 4*tx .. 4*tx+3
  const float* supj = sup + (size_t)j * W * d;
  const float* coefj = coef + (size_t)j * W;
  const float* supsqj = supsq + (size_t)j * W;

  float xq[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + 4 * ty + r;
    xq[r] = row < b ? xsq[row] : 0.0f;
  }
  float racc[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int w0 = 0; w0 < W; w0 += ST) {
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

    for (int k0 = 0; k0 < d; k0 += DK) {
      __syncthreads();   // the previous chunk has been read by all
      for (int i = tid; i < BT * DK; i += NT) {
        const int r = i / DK, c = i % DK;
        const int row = r0 + r, col = k0 + c;
        sm.xs[c * XS + r] =
            (row < b && col < d) ? x[(size_t)row * d + col] : 0.0f;
      }
      for (int i = tid; i < ST * DK; i += NT) {
        const int r = i / DK, c = i % DK;
        const int w = w0 + r, col = k0 + c;
        sm.ss[c * SS + r] =
            (w < W && col < d) ? supj[(size_t)w * d + col] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < DK; ++c) {
        const float4 a = *reinterpret_cast<const float4*>(&sm.xs[c * XS + 4 * ty]);
        const float4 s = *reinterpret_cast<const float4*>(&sm.ss[c * SS + 4 * tx]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            acc[r][cc] = fmaf(av[r], sv[cc], acc[r][cc]);
      }
    }
    // kernel function + coefficient contraction on the finished tile
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int w = w0 + 4 * tx + cc;
      if (w < W) {
        const float cf = coefj[w];
        const float ysq = supsqj[w];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          racc[r] = fmaf(cf, apply_kernel(acc[r][cc], xq[r], ysq, prm),
                         racc[r]);
      }
    }
  }

  // reduce the 32 column groups of each row: 8 lanes, then 4 warps
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      racc[r] += __shfl_xor_sync(0xffffffffu, racc[r], o);
  if ((lane & 7) == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) sm.red[(wid & 3) * BT + 4 * ty + r] = racc[r];
  }
  __syncthreads();
  float p = 0.0f;
  if (tid < BT)
    p = sm.red[tid] + sm.red[BT + tid] + sm.red[2 * BT + tid] +
        sm.red[3 * BT + tid];
  // sm.red is next written after the next call's first __syncthreads
  return p;
}

__global__ void __launch_bounds__(NT)
streaming_assign_kernel(const float* __restrict__ x,
                        const float* __restrict__ xsq,
                        const float* __restrict__ diag,
                        const float* __restrict__ sup,
                        const float* __restrict__ supsq,
                        const float* __restrict__ coef,
                        const float* __restrict__ sqnorm, int b, int k, int W,
                        int d, Params prm, float* __restrict__ best,
                        int* __restrict__ assign) {
  __shared__ __align__(16) Smem sm;
  const int r0 = blockIdx.x * BT;
  const int row = r0 + threadIdx.x;
  float bst = INFINITY;
  int arg = 0;
  for (int j = 0; j < k; ++j) {
    const float p = center_dot(x, xsq, sup, supsq, coef, b, W, d, r0, j, prm,
                               sm);
    if (threadIdx.x < BT && row < b) {
      const float dist = diag[row] - 2.0f * p + sqnorm[j];
      if (dist < bst) {   // strict: ties keep the first center
        bst = dist;
        arg = j;
      }
    }
  }
  if (threadIdx.x < BT && row < b) {
    best[row] = bst;
    assign[row] = arg;
  }
}

__global__ void __launch_bounds__(NT)
batch_center_dots_kernel(const float* __restrict__ x,
                         const float* __restrict__ xsq,
                         const float* __restrict__ sup,
                         const float* __restrict__ supsq,
                         const float* __restrict__ coef, int b, int k, int W,
                         int d, Params prm, float* __restrict__ out) {
  __shared__ __align__(16) Smem sm;
  const int r0 = blockIdx.x * BT;
  const int j = blockIdx.y;
  const float p = center_dot(x, xsq, sup, supsq, coef, b, W, d, r0, j, prm,
                             sm);
  const int row = r0 + threadIdx.x;
  if (threadIdx.x < BT && row < b) out[(size_t)row * k + j] = p;
}

}  // namespace

extern "C" {

// K1.  x (b,d), xsq (b,), diag (b,), sup (k,W,d), supsq (k,W), coef (k,W),
// sqnorm (k,) -> best (b,) f32, assign (b,) i32.  Returns cudaGetLastError().
int rk_streaming_assign(const float* x, const float* xsq, const float* diag,
                        const float* sup, const float* supsq,
                        const float* coef, const float* sqnorm, int b, int k,
                        int W, int d, int kind, float p0, float p1, int p2,
                        float* best, int* assign, void* stream) {
  const Params prm{kind, p0, p1, p2};
  const dim3 grid((b + BT - 1) / BT);
  streaming_assign_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      x, xsq, diag, sup, supsq, coef, sqnorm, b, k, W, d, prm, best, assign);
  return (int)cudaGetLastError();
}

// K2.  x (b,d), xsq (b,), sup (k,W,d), supsq (k,W), coef (k,W)
// -> out (b,k) f32.  Returns cudaGetLastError().
int rk_batch_center_dots(const float* x, const float* xsq, const float* sup,
                         const float* supsq, const float* coef, int b, int k,
                         int W, int d, int kind, float p0, float p1, int p2,
                         float* out, void* stream) {
  const Params prm{kind, p0, p1, p2};
  const dim3 grid((b + BT - 1) / BT, k);
  batch_center_dots_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      x, xsq, sup, supsq, coef, b, k, W, d, prm, out);
  return (int)cudaGetLastError();
}

const char* rk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
