// 1-D shear resamples for Hopper (sm_90a), the passes of the 3-shear
// rotation.
//
// Replaces the TPU kernel `shear_last_axis_pallas` of
// gisnav_tpu/raster/pallas_shear.py:
//   last axis:  out[c, r, x] = lerp(img[c, r, .], x + shift * (r - center)),
//   first axis: out[c, y, x] = lerp(img[c, ., x], y + shift * (x - center)),
// zero outside the image. The first axis is the last-axis shear of the
// transposed stack, transposed back (the y-shear of the rotation), in one
// pass: the JAX package runs it between two transposes. The TPU kernel's
// 384-column window and three-vreg select exist because its gather works
// within one vector register; here a thread reads its two taps from shared
// memory.
//
// Bound on an H100: bytes (one read and one write of the stack; two
// multiplies and three adds a pixel). Design: a block stages the source
// span its outputs need by 16-byte `cp.async` (zero-filled outside the
// image, so no tap is tested), then resamples from shared memory. Blocks
// are small (16-21 KB) so eight are resident an SM, which keeps over 100 KB
// of loads in flight an SM while other blocks compute.
// - Last axis: a block is 4 rows x 1024 columns. The shift is constant
//   along a row, so a row's taps lie in one contiguous span of 1032
//   columns; W % 4 == 0 and the span starts on a multiple of 4, so each
//   16-byte vector is wholly inside or wholly outside [0, W). Lanes take
//   neighbouring outputs: the tap reads have no bank conflict and each warp
//   store is one 128-byte line.
// - First axis: a block is 32 columns (a lane each) x 128 rows. The shift
//   grows monotonically along the row, so the block's first and last
//   columns bound its taps: the strip plus at most 32 |shift| + 3 source rows
//   of 128 bytes each. A lane reads its own column of the staged rows (bank
//   = lane) and each warp store is one 128-byte line.
//
// The source coordinate, its floor and the fraction are evaluated in f32 in
// the reference's order with explicit round-to-nearest intrinsics: a fused
// multiply-add would change the last bit of the interpolation weights.
//
// The shift is a kernel argument, or, where `shift_ptr` is not null, read
// from device memory at launch: a captured graph then shears by the shift
// its replay computed (the 3-shear rotation's residual shears, |a| <=
// tan 22.5 deg, |b| <= sin 45 deg). Nothing of the launch depends on the
// shift's value; the first axis stages at most 32 |shift| + 3 extra rows,
// sized for |shift| < 1. A shift outside (-1, 1), which the host checks
// when it passes one, makes the whole output NaN instead of a read past
// the staged rows.
#include <cuda_runtime.h>

#include "ptx.cuh"

namespace {

constexpr int THREADS = 256;

// the shift of the line `r` (a row of the last-axis shear, a column of the
// first-axis one), as the reference computes it
__device__ __forceinline__ float line_shift(int r, float shift,
                                            float center) {
  return __fmul_rn(shift, __fsub_rn((float)r, center));
}

// The output at index `x` of a line whose shift is `lshift`; `at(i)` reads
// the source at index i from shared memory (zeros outside the image).
template <typename At>
__device__ __forceinline__ float sample(int x, float lshift, At at) {
  const float xf = __fadd_rn((float)x, lshift);
  const float f0 = floorf(xf);
  const float frac = __fsub_rn(xf, f0);
  const int i0 = (int)f0;
  return __fadd_rn(__fmul_rn(at(i0), __fsub_rn(1.0f, frac)),
                   __fmul_rn(at(i0 + 1), frac));
}

// Outputs x of a line with shift s tap the source at floor(fl(x + s)) and
// one after; fl(x + s) is within half a unit of x + s, so the taps of
// outputs [x0, x0 + n) lie in [x0 + floor(s) - 1, x0 + n + floor(s) + 1].
__device__ __forceinline__ int first_tap(int x0, float lshift) {
  return x0 + (int)floorf(lshift) - 1;
}

// the launch's shift: `shift_ptr`'s value where given
__device__ __forceinline__ float shift_of(float shift,
                                          const float* shift_ptr) {
  return shift_ptr ? __ldg(shift_ptr) : shift;
}

__device__ __forceinline__ bool shift_ok(float s) {
  return s > -1.0f && s < 1.0f;
}

constexpr int ROWS = 4;       // last axis: rows a block
constexpr int TW = 1024;      // last axis: output columns a block
constexpr int SPAN = TW + 8;  // staged columns a row: TW + 3, from a
                              // multiple of 4

__global__ void __launch_bounds__(THREADS)
shear_rows(const float* __restrict__ img, float* __restrict__ out, int H,
           int W, float shift_arg, const float* __restrict__ shift_ptr,
           float center_row) {
  __shared__ __align__(16) float src[ROWS][SPAN];
  const int x0 = blockIdx.y * TW;
  const size_t row0 = (size_t)blockIdx.x * ROWS;  // of the (C * H, W) stack
  const float shift = shift_of(shift_arg, shift_ptr);
  if (!shift_ok(shift)) {
    for (int j = 0; j < ROWS; ++j)
      for (int x = x0 + threadIdx.x; x < x0 + TW && x < W; x += THREADS)
        out[(row0 + j) * W + x] = __int_as_float(0x7fc00000);
    return;
  }
  for (int i = threadIdx.x; i < ROWS * (SPAN / 4); i += THREADS) {
    const int j = i / (SPAN / 4), v = i - j * (SPAN / 4);
    const int r = (int)((row0 + j) % H);
    const int gx = (first_tap(x0, line_shift(r, shift, center_row)) & ~3) +
                   4 * v;
    const bool in = gx >= 0 && gx < W;
    ptx::cp_async16(ptx::smem_u32(&src[j][4 * v]),
                    in ? img + (row0 + j) * W + gx : img, in ? 16 : 0);
  }
  ptx::cp_async_commit();
  ptx::cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const float lshift = line_shift((int)((row0 + j) % H), shift, center_row);
    const int s0 = first_tap(x0, lshift) & ~3;
    const float* line = src[j];
    float* o = out + (row0 + j) * W;
#pragma unroll
    for (int m = 0; m < TW / THREADS; ++m) {
      const int x = x0 + threadIdx.x + m * THREADS;
      if (x < W) o[x] = sample(x, lshift, [&](int i) { return line[i - s0]; });
    }
  }
}

constexpr int COLS = 32;            // first axis: columns a block, a lane each
constexpr int STRIP = 128;          // first axis: output rows a block
constexpr int SROWS = STRIP + 36;   // staged rows: STRIP + 32 |shift| + 3

__global__ void __launch_bounds__(THREADS)
shear_cols(const float* __restrict__ img, float* __restrict__ out, int H,
           int W, float shift_arg, const float* __restrict__ shift_ptr,
           float center_col) {
  __shared__ __align__(16) float src[SROWS][COLS];
  const int x0 = blockIdx.x * COLS, y0 = blockIdx.y * STRIP;
  const size_t plane = (size_t)blockIdx.z * H * W;
  const float shift = shift_of(shift_arg, shift_ptr);
  if (!shift_ok(shift)) {
    for (int y = y0 + threadIdx.x / 32; y < y0 + STRIP; y += THREADS / 32)
      out[plane + (size_t)y * W + x0 + threadIdx.x % 32] =
          __int_as_float(0x7fc00000);
    return;
  }
  const int fa = first_tap(y0, line_shift(x0, shift, center_col));
  const int fb = first_tap(y0, line_shift(x0 + COLS - 1, shift, center_col));
  const int s0 = fa < fb ? fa : fb;
  const int rows = STRIP + (fa < fb ? fb - fa : fa - fb) + 3;
  for (int i = threadIdx.x; i < rows * (COLS / 4); i += THREADS) {
    const int r = i / (COLS / 4), v = i % (COLS / 4);
    const int gy = s0 + r;
    const bool in = gy >= 0 && gy < H;
    ptx::cp_async16(ptx::smem_u32(&src[r][4 * v]),
                    in ? img + plane + (size_t)gy * W + x0 + 4 * v : img,
                    in ? 16 : 0);
  }
  ptx::cp_async_commit();
  ptx::cp_async_wait<0>();
  __syncthreads();
  const int lane = threadIdx.x % 32, x = x0 + lane;
  const float lshift = line_shift(x, shift, center_col);
  float* o = out + plane + x;
#pragma unroll 4
  for (int y = y0 + threadIdx.x / 32; y < y0 + STRIP; y += THREADS / 32)
    o[(size_t)y * W] =
        sample(y, lshift, [&](int i) { return src[i - s0][lane]; });
}

}  // namespace

// img, out (C, H, W) f32, 16-byte aligned; H % 4 == 0, W % 4 == 0; the
// shift is `shift`, or the f32 at `shift_ptr` (device memory) if not null
extern "C" int gisnav_shear_last_axis(const float* img, float* out, int C,
                                      int H, int W, float shift,
                                      const float* shift_ptr,
                                      float center_row, void* stream) {
  if (C < 1 || H < ROWS || H % ROWS || W < 4 || W % 4 ||
      (size_t)C * H / ROWS > 0x7fffffffu)
    return -1;
  dim3 grid((unsigned)((size_t)C * H / ROWS), (W + TW - 1) / TW);
  shear_rows<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      img, out, H, W, shift, shift_ptr, center_row);
  return (int)cudaGetLastError();
}

// img, out (C, H, W) f32, 16-byte aligned; H % 128 == 0, W % 32 == 0,
// |shift| < 1 (the staged rows' bound); the shift is `shift`, or the f32 at
// `shift_ptr` (device memory) if not null
extern "C" int gisnav_shear_first_axis(const float* img, float* out, int C,
                                       int H, int W, float shift,
                                       const float* shift_ptr,
                                       float center_col, void* stream) {
  if (C < 1 || C > 65535 || H < STRIP || H % STRIP || W < COLS ||
      W % COLS || (!shift_ptr && !(shift > -1.0f && shift < 1.0f)))
    return -1;
  dim3 grid(W / COLS, H / STRIP, C);
  shear_cols<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      img, out, H, W, shift, shift_ptr, center_col);
  return (int)cudaGetLastError();
}
