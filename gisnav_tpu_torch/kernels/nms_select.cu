// Keypoint NMS + per-cell select for Hopper (sm_90a).
//
// Replaces the TPU kernel `nms_select_pallas` of
// gisnav_tpu/features/pallas_nms.py. In one pass over the (H, W) f32 detector
// heatmap it computes the 9x9 non-maximum suppression (`core >= pooled`),
// border suppression, the 4x4 cell maximum, and each cell's sub-pixel
// keypoint position: a 3x3 soft-argmax (temperature T) on the raw heatmap,
// clipped to +-0.5 px, averaged over the cell's tied survivors.
// Rows and columns outside the image read as zero. The Pallas kernel's
// column roll wraps at row ends instead, but only into columns that border
// suppression zeroes, so the kept values are the same.
//
// The same kernel without the position half (`SELECT` false) replaces
// `nms_cellmax_pallas` of the same file: NMS, border suppression and the cell
// maximum only. Both instances select input values with the same
// comparisons, so their cell maxima are bit-identical.
//
// Bound on an H100: bytes (one read of the heatmap, 3 small writes, ~10
// max operations a pixel and 9 exps a survivor). Design:
// - a persistent grid of 128-thread blocks walks 32x128 tiles; each tile
//   and its 4-pixel halo (40x136 floats) is staged by 16-byte `cp.async`
//   into one of two shared buffers while the previous tile is computed.
//   W % 4 == 0 and the halo is 4 wide, so a 16-byte vector lies wholly
//   inside or wholly outside the image, and the copy's zero fill (source
//   size 0) is the "outside reads as zero" rule, with no test per element;
// - a thread owns two vertically stacked 4x4 cells, the 32 lanes of a warp
//   a row of 32 such pairs. It streams its 16x12 window one row at a time
//   as three float4 (the lanes read 16-byte words side by side: no bank
//   conflict), takes each row's 9-wide maxima for its 4 columns once, in
//   registers, and pools the rows by suffix and prefix maxima, so no
//   intermediate map is stored and a thread reads each staged row of its
//   window once (one cell a thread read every row three times: 1.5x the
//   shared-memory reads and 1.6x the max operations of this layout);
// - the soft-argmax runs for survivors only, compacted over the block (see
//   `cells`), on the staged window, with the arithmetic (and so the bits)
//   of the reference's order: `dy` outer, `dx` inner, `expf`, each cell's
//   survivors summed in its pixel order.
#include <cuda_runtime.h>

#include "ptx.cuh"

namespace {

constexpr int R = 4;                             // NMS radius
constexpr int TRW = 32;                          // tile rows
constexpr int TCL = 128;                         // tile columns
constexpr int SR = TRW + 2 * R;                  // staged rows
constexpr int SC = TCL + 2 * R;                  // staged columns
constexpr int SV = SC / 4;                       // float4 a staged row
constexpr int CELLS = 2;                         // cells a thread, stacked
static_assert(CELLS == 2, "the pooling and sums below are written for two");
constexpr int THREADS = (TRW / 4 / CELLS) * (TCL / 4);
constexpr int TILE = SR * SC;                    // floats a buffer
constexpr int SMEM_BYTES = 2 * TILE * 4;         // two buffers: 43,520 B

// Copy tile `t` (row-major over `tiles_x` columns of tiles) and its halo
// into `slab`, zero-filled outside the image.
__device__ __forceinline__ void stage(float* slab, const float* heat, int t,
                                      int tiles_x, int H, int W) {
  const int y0 = (t / tiles_x) * TRW - R, x0 = (t % tiles_x) * TCL - R;
  const uint32_t base = ptx::smem_u32(slab);
  for (int i = threadIdx.x; i < SR * SV; i += THREADS) {
    const int r = i / SV, v = i - r * SV;
    const int gy = y0 + r, gx = x0 + 4 * v;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    ptx::cp_async16(base + (uint32_t)(r * SC + 4 * v) * 4u,
                    in ? heat + (size_t)gy * W + gx : heat, in ? 16 : 0);
  }
}

__device__ __forceinline__ float max3(float a, float b, float c) {
  return fmaxf(a, fmaxf(b, c));
}

// 9-wide maxima of the 12 values (a, b, c) at offsets 0..3
__device__ __forceinline__ void row_max9(const float4* row, float (&m)[4]) {
  const float4 a = row[0], b = row[1], c = row[2];
  const float mid = fmaxf(fmaxf(fmaxf(a.w, b.x), fmaxf(b.y, b.z)),
                          fmaxf(b.w, c.x));  // offsets 3..8, in every window
  const float p = fmaxf(a.y, a.z), q = fmaxf(c.y, c.z);
  m[0] = max3(mid, p, a.x);
  m[1] = max3(mid, p, c.y);
  m[2] = max3(mid, a.z, q);
  m[3] = max3(mid, q, c.w);
}

// The 3x3 soft-argmax position of the staged pixel (ly, lx) at image pixel
// (gx, gy): its own coordinate plus the offset, summed in the Pallas order.
__device__ __forceinline__ float2 soft_argmax(const float* slab, int ly,
                                              int lx, int gx, int gy,
                                              float inv_t) {
  float m3 = slab[ly * SC + lx];
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx)
      m3 = fmaxf(m3, slab[(ly + dy) * SC + lx + dx]);
  float s = 0.0f, sx = 0.0f, sy = 0.0f;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      float e = expf((slab[(ly + dy) * SC + lx + dx] - m3) * inv_t);
      s += e;
      sx += e * (float)dx;
      sy += e * (float)dy;
    }
  const float ddx = fminf(fmaxf(sx / s, -0.5f), 0.5f);
  const float ddy = fminf(fmaxf(sy / s, -0.5f), 0.5f);
  return make_float2((float)gx + ddx, (float)gy + ddy);
}

// The CELLS cells of this thread in tile `t`, staged in `slab`: output rows
// 0..7 of a 4-column strip, which pool window rows i..i+8 of 16. Every
// window contains rows 7 and 8, so output row i is max(suffix maximum of
// rows i..8, prefix maximum of rows 9..i+8): each row's maxima are taken
// once and the rows are read once.
//
// Positions: survivors are rare (one pixel in 81 of a random heatmap, the
// maximum of its 9x9 window), so a thread that ran its own survivors'
// soft-argmax would leave most lanes of its warp idle. Instead the block
// lists its survivors (each thread's in its cells' pixel order, threads in
// order), computes the list a survivor a thread, THREADS at a time, and
// each thread sums its own entries in list order: the reference's order of
// a cell's sum.
template <bool SELECT>
__device__ __forceinline__ void cells(const float* slab, int t, int tiles_x,
                                      float* __restrict__ cell_max,
                                      float* __restrict__ cell_x,
                                      float* __restrict__ cell_y, int H,
                                      int W, int border, float inv_t) {
  const int cr = threadIdx.x / (TCL / 4) * CELLS, cc = threadIdx.x % (TCL / 4);
  const int ty = t / tiles_x, tx = t - ty * tiles_x;
  const int oy = ty * (TRW / 4) + cr, ox = tx * (TCL / 4) + cc;
  const int hb = H / 4, wb = W / 4;
  const bool active = oy < hb && ox < wb;
  if (!SELECT && !active) return;  // no barrier below without SELECT

  // window rows 0..15 = staged rows 4cr..4cr+15; output row i's own pixels
  // are window row i + 4
  const float4* win = reinterpret_cast<const float4*>(slab + 4 * cr * SC) + cc;
  float suf[9][4];
#pragma unroll
  for (int r = 0; r <= 8; ++r) row_max9(win + r * SV, suf[r]);
#pragma unroll
  for (int r = 7; r >= 0; --r)
#pragma unroll
    for (int j = 0; j < 4; ++j) suf[r][j] = fmaxf(suf[r][j], suf[r + 1][j]);

  const int gy0 = ty * TRW + 4 * cr, gx0 = tx * TCL + 4 * cc;
  float best[CELLS] = {};
  unsigned survivors = 0;  // bit 16 c + p: pixel p of cell c
  float pre[4];
#pragma unroll
  for (int i = 0; i < 4 * CELLS; ++i) {
    float pooled[4];
    if (i > 0) {
      float m[4];
      row_max9(win + (i + 8) * SV, m);
#pragma unroll
      for (int j = 0; j < 4; ++j) pre[j] = i == 1 ? m[j] : fmaxf(pre[j], m[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pooled[j] = i == 0 ? suf[0][j] : fmaxf(suf[i][j], pre[j]);
    const float4 cv = win[(i + R) * SV + 1];
    const float core[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gy = gy0 + i, gx = gx0 + j;
      const bool keep = core[j] >= pooled[j] && gx >= border &&
                        gx < W - border && gy >= border && gy < H - border;
      best[i / 4] = fmaxf(best[i / 4], keep ? core[j] : 0.0f);
      if (SELECT && keep && core[j] > 0.0f) survivors |= 1u << (4 * i + j);
    }
  }
  const int ncells = !active ? 0 : oy + CELLS <= hb ? CELLS : hb - oy;
#pragma unroll
  for (int c = 0; c < CELLS; ++c)
    if (c < ncells) cell_max[(size_t)(oy + c) * wb + ox] = best[c];
  if (!SELECT) return;

  __shared__ int s_warp[THREADS / 32], s_off[THREADS];
  __shared__ unsigned s_mask[THREADS];
  __shared__ float2 s_pos[THREADS];
  survivors &= ncells == CELLS ? ~0u : (1u << (16 * ncells)) - 1u;
  const int n = __popc(survivors), n0 = __popc(survivors & 0xffffu);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int incl = n;  // inclusive scan of the counts over the warp
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int v = __shfl_up_sync(~0u, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int off = incl - n, total = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    off += w < warp ? s_warp[w] : 0;
    total += s_warp[w];
  }
  s_off[threadIdx.x] = off;
  s_mask[threadIdx.x] = survivors;
  __syncthreads();

  float sx[CELLS] = {}, sy[CELLS] = {}, cnt[CELLS] = {};
  for (int k0 = 0; k0 < total; k0 += THREADS) {
    const int e = k0 + threadIdx.x;
    if (e < total) {
      int lo = 0, hi = THREADS - 1;  // owner: last thread whose list starts
                                     // at or before e
      while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (s_off[mid] <= e) lo = mid; else hi = mid - 1;
      }
      unsigned m = s_mask[lo];
      for (int k = e - s_off[lo]; k > 0; --k) m &= m - 1;
      const int bit = __ffs(m) - 1, c = bit / 16, p = bit % 16;
      const int ocr = lo / (TCL / 4) * CELLS, occ = lo % (TCL / 4);
      const int dyc = 4 * c + p / 4, dxc = p % 4;
      s_pos[threadIdx.x] = soft_argmax(
          slab, 4 * ocr + dyc + R, 4 * occ + dxc + R,
          tx * TCL + 4 * occ + dxc, ty * TRW + 4 * ocr + dyc, inv_t);
    }
    __syncthreads();
    const int e1 = off + n < k0 + THREADS ? off + n : k0 + THREADS;
    for (int e = off > k0 ? off : k0; e < e1; ++e) {  // own entries, in order
      const float2 q = s_pos[e - k0];
      if (e - off < n0) {  // the upper cell's entries come first
        sx[0] += q.x;
        sy[0] += q.y;
        cnt[0] += 1.0f;
      } else {
        sx[1] += q.x;
        sy[1] += q.y;
        cnt[1] += 1.0f;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int c = 0; c < CELLS; ++c) {
    if (c >= ncells) break;
    const size_t o = (size_t)(oy + c) * wb + ox;
    const float denom = fmaxf(cnt[c], 1.0f);
    cell_x[o] = sx[c] / denom;
    cell_y[o] = sy[c] / denom;
  }
}

template <bool SELECT>
__global__ void __launch_bounds__(THREADS, 4)
nms_kernel(const float* __restrict__ heat, float* __restrict__ cell_max,
           float* __restrict__ cell_x, float* __restrict__ cell_y, int H,
           int W, int border, float inv_t) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tiles_x = (W + TCL - 1) / TCL;
  const int tiles = tiles_x * ((H + TRW - 1) / TRW);
  int t = blockIdx.x;  // the grid never exceeds the tiles
  stage(smem, heat, t, tiles_x, H, W);
  ptx::cp_async_commit();
  for (int k = 0; t < tiles; t += gridDim.x, ++k) {
    const int next = t + gridDim.x;
    if (next < tiles)
      stage(smem + ((k + 1) & 1) * TILE, heat, next, tiles_x, H, W);
    ptx::cp_async_commit();
    ptx::cp_async_wait<1>();  // tile t has landed, tile `next` may not
    __syncthreads();
    cells<SELECT>(smem + (k & 1) * TILE, t, tiles_x, cell_max, cell_x,
                  cell_y, H, W, border, inv_t);
    __syncthreads();  // buffer k & 1 is restaged at step k + 1
  }
}

// Blocks of the kernel to launch on this card (queried once).
template <bool SELECT>
int grid_blocks() {
  static int slots = 0;
  if (slots == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, nms_kernel<SELECT>, THREADS, SMEM_BYTES) != cudaSuccess)
      return 0;
    // The cell maximum alone runs best with two blocks an SM (each walks
    // about two tiles of a frame, the second one's loads landing while the
    // first is pooled: 6.3 against 6.5-6.9 us at 1088x1920 on an H100);
    // with positions, whose barriers leave an SM idle unless other blocks
    // are resident, with all that fit (8.3 against 9.1-9.3 us).
    if (per_sm < 1) per_sm = 1;
    slots = sms * (SELECT || per_sm < 2 ? per_sm : 2);
  }
  return slots;
}

template <bool SELECT>
int launch(const float* heat, float* cell_max, float* cell_x, float* cell_y,
           int H, int W, int border, float inv_t, void* stream) {
  if (H < 4 || W < 4 || H % 4 || W % 4) return -1;
  const int slots = grid_blocks<SELECT>();
  if (slots == 0) return (int)cudaGetLastError();
  const int tiles = ((W + TCL - 1) / TCL) * ((H + TRW - 1) / TRW);
  nms_kernel<SELECT><<<tiles < slots ? tiles : slots, THREADS, SMEM_BYTES,
                       (cudaStream_t)stream>>>(heat, cell_max, cell_x, cell_y,
                                               H, W, border, inv_t);
  return (int)cudaGetLastError();
}

}  // namespace

// heat (H, W) f32, 16-byte aligned; outputs (H/4, W/4) f32
extern "C" int gisnav_nms_select(const float* heat, float* cell_max,
                                 float* cell_x, float* cell_y, int H, int W,
                                 int border, float inv_t, void* stream) {
  return launch<true>(heat, cell_max, cell_x, cell_y, H, W, border, inv_t,
                      stream);
}

extern "C" int gisnav_nms_cellmax(const float* heat, float* cell_max, int H,
                                  int W, int border, void* stream) {
  return launch<false>(heat, cell_max, nullptr, nullptr, H, W, border, 0.0f,
                       stream);
}
