// Centre-vote accumulator of a uint8 direction-label pool (kernel A).
//
// Replaces no Pallas kernel. In the JAX package the accumulator is a device
// loop over the label pool: vote_accumulator_pool_labels
// (img2sgf_tpu/hough/circles.py:278-296), a lax.map over
// vote_accumulator_packed4, whose shift chain XLA fuses into one pass over
// each bin's plane; and, for radius spans not divisible by 5, the
// per-offset chain of vote_accumulator (:299-347), fused the same way. Plain
// PyTorch runs either as hundreds of launches over whole padded int32
// planes, so on the card both are this one kernel.
//
// Both accumulators are one function of the labels: an edge pixel q of bin
// d (label d < nb; the sentinel nb and anything above never votes) adds
// weight w at q + (dy, dx) for every entry of bin d's offset table (built on
// the host, hough/accumulator_cuda.py vote_table); votes outside the plane
// are dropped. Counts are integers below 2^24, summed exactly in int32 and
// written as float32, so the kernel equals the plain versions bit for bit.
//
// Bound: bytes, one read of the labels and one write of the float32
// accumulator (5 bytes a pixel); the votes (2 * n_r per edge pixel, one
// int32 add each) take a fraction of that at the int32 rate on the sparse
// edge planes of a diagram. This design is the simple one that reaches
// that shape; making it fast (TMA, cp.async, warp-level aggregation) is
// later work:
//   * One block per (plane, 64 x 128 output tile), its int32 counts in
//     shared memory (row stride 129, so a column of targets spreads over
//     the banks), zeroed at the start and written once, coalesced, as
//     float32 at the end: no intermediate plane in device memory.
//   * The block scans its window, the tile grown by the halo (the table's
//     largest |offset|) and clipped to the plane, kThreads pixels a step,
//     and stages the edge pixels it meets in a shared list (a ballot and
//     one shared atomic a warp). When the list could overflow at the next
//     step, or the window ends, the block walks it: one warp per edge
//     pixel, its lanes over the entries of the pixel's bin (a coalesced
//     read of the table), one shared atomic add per vote that lands in the
//     tile. Any window size, any halo and any table run, in strips of the
//     list's size.
//   * The table stays in device memory and is read through the read-only
//     cache: at the defaults (64 bins, r in [1, 30]) its 3,616 entries are
//     43 KB and stay cached; 254 bins at a span of 60 still run, from L2.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTileH = 64;
constexpr int kTileW = 128;
constexpr int kStride = kTileW + 1;
constexpr int kList = 1024;  // staged edge pixels; >= 2 * kThreads

__global__ void __launch_bounds__(kThreads)
accumulator_kernel(const unsigned char* __restrict__ labels,
                   const int* __restrict__ start,
                   const int* __restrict__ entries, int E,
                   float* __restrict__ out, int H, int W, int nb, int halo,
                   int tiles_x, int tiles_per_plane) {
  __shared__ int cnt[kTileH * kStride];
  __shared__ int ly[kList];  // tile-relative row, column and bin of each
  __shared__ int lx[kList];  // staged edge pixel
  __shared__ int lb[kList];
  __shared__ int s_n;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int p = blockIdx.x / tiles_per_plane;
  const int tile = blockIdx.x - p * tiles_per_plane;
  const int ty0 = (tile / tiles_x) * kTileH;
  const int tx0 = (tile % tiles_x) * kTileW;
  const int th = min(kTileH, H - ty0);
  const int tw = min(kTileW, W - tx0);
  const unsigned char* lab = labels + (size_t)p * H * W;
  const int* tdy = entries;
  const int* tdx = entries + E;
  const int* twt = entries + 2 * (size_t)E;

  for (int i = t; i < kTileH * kStride; i += kThreads) cnt[i] = 0;
  if (t == 0) s_n = 0;
  const int wy0 = max(ty0 - halo, 0);
  const int wy1 = min(ty0 + th + halo, H);
  const int wx0 = max(tx0 - halo, 0);
  const int ww = min(tx0 + tw + halo, W) - wx0;
  const int wn = (wy1 - wy0) * ww;
  __syncthreads();

  int n = 0;  // staged edge pixels, the same in every thread
  for (int base = 0; base < wn; base += kThreads) {
    const int i = base + t;
    int b = nb, y = 0, x = 0;
    if (i < wn) {
      const int r = i / ww;
      y = wy0 + r;
      x = wx0 + (i - r * ww);
      b = __ldg(lab + (size_t)y * W + x);
    }
    const bool edge = b < nb;
    const unsigned m = __ballot_sync(0xffffffffu, edge);
    int slot = 0;
    if (lane == 0 && m) slot = atomicAdd(&s_n, __popc(m));
    slot = __shfl_sync(0xffffffffu, slot, 0);
    if (edge) {
      const int k = slot + __popc(m & ((1u << lane) - 1));
      ly[k] = y - ty0;
      lx[k] = x - tx0;
      lb[k] = b;
    }
    n += __syncthreads_count(edge);  // a barrier: the list is complete
    if (n > kList - kThreads || base + kThreads >= wn) {
      for (int k = warp; k < n; k += kWarps) {
        const int ry = ly[k];
        const int rx = lx[k];
        const int bin = lb[k];
        const int e1 = __ldg(start + bin + 1);
        for (int e = __ldg(start + bin) + lane; e < e1; e += 32) {
          const int yy = ry + __ldg(tdy + e);
          const int xx = rx + __ldg(tdx + e);
          if ((unsigned)yy < (unsigned)th && (unsigned)xx < (unsigned)tw) {
            atomicAdd(&cnt[yy * kStride + xx], __ldg(twt + e));
          }
        }
      }
      n = 0;
      __syncthreads();  // the list is walked
      if (t == 0) s_n = 0;
      __syncthreads();
    }
  }

  float* o = out + ((size_t)p * H + ty0) * W + tx0;
  for (int i = t; i < th * kTileW; i += kThreads) {
    const int yy = i / kTileW;
    const int xx = i - yy * kTileW;
    if (xx < tw) o[(size_t)yy * W + xx] = static_cast<float>(cnt[yy * kStride + xx]);
  }
}

}  // namespace

// labels: [P, H, W] uint8 direction labels (label >= nb: no vote); start:
// [nb + 1] int32 offsets into the table; entries: [3, E] int32 rows dy, dx,
// weight; out: [P, H, W] float32, every element written; halo: the table's
// largest |dy| or |dx|. Returns a cudaError_t.
extern "C" int img2sgf_accumulator(const unsigned char* labels,
                                   const int* start, const int* entries,
                                   int E, float* out, int P, int H, int W,
                                   int nb, int halo, void* stream) {
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles_y = (H + kTileH - 1) / kTileH;
  const long long blocks = (long long)P * tiles_x * tiles_y;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  accumulator_kernel<<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      labels, start, entries, E, out, H, W, nb, halo, tiles_x,
      tiles_x * tiles_y);
  return cudaGetLastError();
}
