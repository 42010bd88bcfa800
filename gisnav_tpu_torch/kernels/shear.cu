// 1-D shear resample along the last axis for Hopper (sm_90a).
//
// Replaces the TPU kernel `shear_last_axis_pallas` of
// gisnav_tpu/raster/pallas_shear.py, one pass of the 3-shear rotation:
//   out[c, r, x] = lerp(img[c, r, .], x + shift * (r - center_row)),
// zero outside [0, W). The TPU kernel's 384-column window and three-vreg
// select exist because its gather works within one vector register; here a
// thread reads its two taps directly. The shift is constant along a row, so
// neighbouring threads read neighbouring addresses and both taps coalesce.
//
// Bound on an H100: bytes (one read and one write of the stack; two
// multiplies and three adds per pixel). One thread per output pixel.
//
// The source coordinate, its floor and the fraction are evaluated in f32 in
// the reference's order with explicit round-to-nearest intrinsics: a fused
// multiply-add would change the last bit of the interpolation weights.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
shear_kernel(const float* __restrict__ img, float* __restrict__ out, int H,
             int W, float shift, float center_row) {
  const int x = blockIdx.x * THREADS + threadIdx.x;
  const int r = blockIdx.y;
  if (x >= W) return;
  const size_t base = ((size_t)blockIdx.z * H + r) * W;
  const float rshift = __fmul_rn(shift, __fsub_rn((float)r, center_row));
  const float xf = __fadd_rn((float)x, rshift);
  const float f0 = floorf(xf);
  const float frac = __fsub_rn(xf, f0);
  const int i0 = (int)f0;
  const float a = (i0 >= 0 && i0 < W) ? img[base + i0] : 0.0f;
  const float b = (i0 + 1 >= 0 && i0 + 1 < W) ? img[base + i0 + 1] : 0.0f;
  out[base + x] = __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, frac)),
                            __fmul_rn(b, frac));
}

}  // namespace

// img, out (C, H, W) f32
extern "C" int gisnav_shear_last_axis(const float* img, float* out, int C,
                                      int H, int W, float shift,
                                      float center_row, void* stream) {
  if (C < 1 || C > 65535 || H < 1 || H > 65535 || W < 1) return -1;
  dim3 grid((W + THREADS - 1) / THREADS, H, C);
  shear_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      img, out, H, W, shift, center_row);
  return (int)cudaGetLastError();
}
