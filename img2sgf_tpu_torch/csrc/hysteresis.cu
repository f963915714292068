// K1: Canny hysteresis sweeps on bit-packed int32 planes.
//
// Replaces the Pallas kernel img2sgf_tpu/ops/hysteresis_pallas.py
// (hysteresis_pallas / hysteresis_pallas_packed, body _kernel). Words are
// [G, H, W] int32, one bit per image plane; all operations are bitwise.
// One sweep = segmented OR-fill along rows (forward and backward), the same
// along columns, then the 3x3 dilation gated by `gate`. Sweeps run until one
// changes nothing or `iters` sweeps have run, which is the sweep semantics
// of ops/canny.py (the cap binds on photo-textured scans, so a tile-local
// fixed point would not do).
//
// Bound: a call must read `edge0` and `gate` and write `edge` once, 12
// bytes a word (7.1 MB at [1, 768, 768]); each sweep also needs 8 LOP3
// instructions a word (4 one-sided fills, the dilation's two 3-way ORs,
// the gate-or, the change test), so from the eighth sweep on operations
// bind.
//
// Design: one persistent cooperative launch runs every sweep. Phases are
// separated by grid-wide barriers, and the working set (edge, gate, one
// scratch plane, carries) stays in the 50 MB L2 across sweeps.
//   * The segmented fill is the associative scan
//     (a1,g1)o(a2,g2) = (a2 | g2 & a1, g1 & g2), i.e. f[i] = a[i] | g[i] &
//     f[i-1]. Forward then backward equals the two-sided fill because
//     bwd(fwd(a)) = fwd(a) | bwd(a), so one array does both.
//   * Rows: a warp stages a segment of up to kSegWords words in shared
//     memory with coalesced loads; each lane scans its own 32 contiguous
//     words sequentially, one warp scan of the lane summaries gives every
//     lane its carry, and a second pass writes the fill. Rows longer than
//     one segment first store per-segment summaries (forward end value,
//     backward start value, AND of the gate); after a barrier each segment
//     composes its carries from the others.
//   * Columns: a warp takes 32 adjacent columns (coalesced loads) and each
//     lane walks a band of kBand rows sequentially in registers; band
//     summaries are composed the same way. The gated dilation is fused
//     into the column fill: a unit writes 30 columns, its outer two lanes
//     fill the neighbouring columns as a halo, and the rows just above and
//     below the band follow from the band's carries. So `t` holds only the
//     row fill and a sweep has three barriers.
//   * Words only grow within a sweep, so each phase notes the bits it adds
//     and the change test needs no second read of the sweep's input: it is
//     __syncthreads_or per block and one atomicOr on a device flag. Two flags alternate by sweep parity, so clearing the
//     next one never races with reading this one; every block reads the
//     flag after the sweep's last barrier and all leave the loop together.
// The sweep count is written to a device int of the caller's; the call
// reads nothing back and does not synchronise, so a CUDA graph can capture
// it (CUDA 12 captures a cooperative launch as a kernel node). Every launch
// clears its own flags, so a replay needs no zeroed scratch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSegWords = 32 * 32;  // row segment: 32 words for each lane
constexpr int kPitch = 33;          // shared words per lane slice (no bank conflicts)
constexpr int kWarpSmem = 2 * 32 * kPitch;  // a and gate of one segment
constexpr int kBand = 32;           // rows per column band
constexpr int kCols = 30;           // columns a column unit writes

struct Args {
  const int* edge0;  // [G, H, W] sweep-0 input
  int* edge;         // [G, H, W] output
  int* t;            // [G, H, W] scratch: the row fill
  const int* gate;   // [G, H, W]
  int* rsum;         // [3, G*H, nseg] row segment summaries
  int* csum;         // [3, G, nband, W] column band summaries
  int* ctl;          // [0], [1] changed flags by sweep parity
  int* sweeps;       // [1] device int: the sweeps run
  int G, H, W, iters;
};

// Inclusive warp scan of (a, g) toward higher lanes: afterwards a is the
// forward fill from lane 0 with a zero carry, g the AND of g over 0..lane.
__device__ __forceinline__ void scan_up(int& a, int& g, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int au = __shfl_up_sync(kFull, a, d);
    const int gu = __shfl_up_sync(kFull, g, d);
    if (lane >= d) {
      a |= g & au;
      g &= gu;
    }
  }
}

// The same toward lower lanes: the backward fill from lane 31.
__device__ __forceinline__ void scan_down(int& a, int& g, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int ad = __shfl_down_sync(kFull, a, d);
    const int gd = __shfl_down_sync(kFull, g, d);
    if (lane + d < 32) {
      a |= g & ad;
      g &= gd;
    }
  }
}

// Stages n <= kSegWords words of a row segment: word 32*l + k of the
// segment goes to A[l*kPitch + k], so lane l owns words 32l .. 32l+31.
__device__ __forceinline__ void stage_segment(const int* in, const int* gate,
                                              int n, int lane, int* A,
                                              int* Gs) {
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const int i = c * 32 + lane;
    A[c * kPitch + lane] = i < n ? __ldcg(in + i) : 0;
    Gs[c * kPitch + lane] = i < n ? __ldg(gate + i) : 0;
  }
  __syncwarp();
}

// Forward fill of the staged segment in place, entering with carry cf.
// Returns the value after the segment's last word. Words past n are zero,
// and only a row's last segment has them, whose outgoing value no one
// reads. ga receives the AND of the lane's gate words; bits that the fill
// adds are or'ed into grew.
__device__ __forceinline__ int fill_fwd(int* A, const int* Gs, int lane,
                                        int cf, int& ga, int& grew) {
  int* a = A + lane * kPitch;
  const int* g = Gs + lane * kPitch;
  int f = 0;
  ga = ~0;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    f = a[k] | (g[k] & f);
    ga &= g[k];
  }
  int x = f, y = ga;
  scan_up(x, y, lane);
  const int xp = __shfl_up_sync(kFull, x, 1);
  const int yp = __shfl_up_sync(kFull, y, 1);
  f = lane == 0 ? cf : xp | (yp & cf);
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    f = a[k] | (g[k] & f);
    grew |= f ^ a[k];
    a[k] = f;
  }
  return __shfl_sync(kFull, x | (y & cf), 31);
}

// Backward fill in place, entering with carry cb after the segment's end;
// returns the value at its first word. ga is fill_fwd's.
__device__ __forceinline__ int fill_bwd(int* A, const int* Gs, int lane,
                                        int cb, int ga, int& grew) {
  int* a = A + lane * kPitch;
  const int* g = Gs + lane * kPitch;
  int b = 0;
#pragma unroll
  for (int k = 31; k >= 0; --k) b = a[k] | (g[k] & b);
  int x = b, y = ga;
  scan_down(x, y, lane);
  const int xn = __shfl_down_sync(kFull, x, 1);
  const int yn = __shfl_down_sync(kFull, y, 1);
  b = lane == 31 ? cb : xn | (yn & cb);
#pragma unroll
  for (int k = 31; k >= 0; --k) {
    b = a[k] | (g[k] & b);
    grew |= b ^ a[k];
    a[k] = b;
  }
  return __shfl_sync(kFull, x | (y & cb), 0);
}

// Folds the summaries (v, ga) of units first, first + step, ... (count of
// them) into a carry. Loads go out kFold at a time, so a long line costs a
// few L2 round trips and not one per unit.
constexpr int kFold = 8;
__device__ __forceinline__ int fold(const int* v, const int* ga, int stride,
                                    int first, int step, int count) {
  int c = 0;
  for (int i0 = 0; i0 < count; i0 += kFold) {
    int vv[kFold], gg[kFold];
#pragma unroll
    for (int k = 0; k < kFold; ++k) {
      const size_t o = (size_t)(first + (i0 + k) * step) * stride;
      vv[k] = i0 + k < count ? __ldcg(v + o) : 0;
      gg[k] = i0 + k < count ? __ldcg(ga + o) : ~0;
    }
#pragma unroll
    for (int k = 0; k < kFold; ++k) c = vv[k] | (gg[k] & c);
  }
  return c;
}

// Carries into unit j of a line of n units whose summaries (forward end
// value, backward start value, gate AND) sit `stride` words apart.
__device__ __forceinline__ void compose(const int* ff, const int* bb,
                                        const int* ga, int stride, int j,
                                        int n, int& cf, int& cb) {
  cf = fold(ff, ga, stride, 0, 1, j);
  cb = fold(bb, ga, stride, n - 1, -1, n - 1 - j);
}

__global__ void __launch_bounds__(kThreads, 2)
hysteresis_kernel(Args p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* A = smem + warp * kWarpSmem;
  int* Gs = A + 32 * kPitch;
  const int gwarp = blockIdx.x * kWarps + warp;
  const int nwarps = gridDim.x * kWarps;
  const int G = p.G, H = p.H, W = p.W;
  const size_t HW = (size_t)H * W;
  const int nseg = (W + kSegWords - 1) / kSegWords;
  const int nrow_units = G * H * nseg;
  const int nband = (H + kBand - 1) / kBand;
  const int nsum_units = G * nband * ((W + 31) / 32);
  const int ncc = (W + kCols - 1) / kCols;
  const int ncol_units = G * nband * ncc;
  const size_t rs = (size_t)G * H * nseg;   // rsum plane stride
  const size_t cs = (size_t)G * nband * W;  // csum plane stride

  if (blockIdx.x == 0 && threadIdx.x == 0) p.ctl[0] = 0;
  int sweeps = 0;
  for (int s = 0; s < p.iters; ++s) {
    const int* src = s == 0 ? p.edge0 : p.edge;

    // 1. row segment summaries (only rows longer than one segment)
    if (nseg > 1) {
      for (int u = gwarp; u < nrow_units; u += nwarps) {
        const int row = u / nseg, j = u - row * nseg;
        const size_t off = (size_t)row * W + (size_t)j * kSegWords;
        const int n = min(kSegWords, W - j * kSegWords);
        stage_segment(src + off, p.gate + off, n, lane, A, Gs);
        int ga, unused = 0;
        const int ff = fill_fwd(A, Gs, lane, 0, ga, unused);
        // bwd(fwd(a)) = fwd(a) | bwd(a), and fwd(a) = a at the first word
        const int bb = fill_bwd(A, Gs, lane, 0, ga, unused);
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) ga &= __shfl_xor_sync(kFull, ga, d);
        if (lane == 0) {
          p.rsum[u] = ff;
          p.rsum[rs + u] = bb;
          p.rsum[2 * rs + u] = ga;
        }
        __syncwarp();
      }
      grid.sync();
    }

    // 2. row fill: src -> t. The sweep's words only grow (src <= row fill
    // <= column fill <= new), so it changed something iff some phase grew.
    int grew = 0;
    for (int u = gwarp; u < nrow_units; u += nwarps) {
      const int row = u / nseg, j = u - row * nseg;
      const size_t off = (size_t)row * W + (size_t)j * kSegWords;
      const int n = min(kSegWords, W - j * kSegWords);
      int cf = 0, cb = 0;
      if (nseg > 1) {
        const int* base = p.rsum + (size_t)row * nseg;
        compose(base, base + rs, base + 2 * rs, 1, j, nseg, cf, cb);
      }
      stage_segment(src + off, p.gate + off, n, lane, A, Gs);
      int ga;
      fill_fwd(A, Gs, lane, cf, ga, grew);
      fill_bwd(A, Gs, lane, cb, ga, grew);
      __syncwarp();
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int i = c * 32 + lane;
        if (i < n) p.t[off + i] = A[c * kPitch + lane];
      }
      __syncwarp();
    }
    grid.sync();

    // 3. column band summaries (only when there is more than one band)
    if (nband > 1) {
      const int nc32 = (W + 31) / 32;
      for (int u = gwarp; u < nsum_units; u += nwarps) {
        const int cc = u % nc32, gb = u / nc32;  // gb = g * nband + band
        const int band = gb % nband, g0 = gb / nband;
        const int x = cc * 32 + lane;
        const int y0 = band * kBand;
        const int rows = min(kBand, H - y0);
        const bool live = x < W;
        const size_t off = (size_t)g0 * HW + (size_t)y0 * W + x;
        int a[kBand], g[kBand];
#pragma unroll
        for (int r = 0; r < kBand; ++r) {
          const bool ok = live && r < rows;
          a[r] = ok ? __ldcg(p.t + off + (size_t)r * W) : 0;
          g[r] = ok ? __ldg(p.gate + off + (size_t)r * W) : 0;
        }
        int ff = 0, bb = 0, ga = ~0;
#pragma unroll
        for (int r = 0; r < kBand; ++r) {
          ff = a[r] | (g[r] & ff);
          ga &= g[r];
        }
#pragma unroll
        for (int r = kBand - 1; r >= 0; --r) bb = a[r] | (g[r] & bb);
        if (live) {
          const size_t o = (size_t)gb * W + x;
          p.csum[o] = ff;
          p.csum[cs + o] = bb;
          p.csum[2 * cs + o] = ga;
        }
      }
      grid.sync();
    }

    // 4. column fill of t and edge = (dilate8(fill) & gate) | fill.
    // Lane l of unit cc fills column cc*kCols - 1 + l; lanes 1..kCols write.
    if (blockIdx.x == 0 && threadIdx.x == 0) p.ctl[(s + 1) & 1] = 0;
    for (int u = gwarp; u < ncol_units; u += nwarps) {
      const int cc = u % ncc, gb = u / ncc;
      const int band = gb % nband, g0 = gb / nband;
      const int x = cc * kCols - 1 + lane;
      const int y0 = band * kBand;
      const int rows = min(kBand, H - y0);
      const bool live = x >= 0 && x < W;
      const size_t off = (size_t)g0 * HW + (size_t)y0 * W + x;
      int cf = 0, cb = 0;
      if (nband > 1 && live) {
        const int* base = p.csum + (size_t)g0 * nband * W + x;
        compose(base, base + cs, base + 2 * cs, W, band, nband, cf, cb);
      }
      int a[kBand], g[kBand];
#pragma unroll
      for (int r = 0; r < kBand; ++r) {
        const bool ok = live && r < rows;
        a[r] = ok ? __ldcg(p.t + off + (size_t)r * W) : 0;
        g[r] = ok ? __ldg(p.gate + off + (size_t)r * W) : 0;
      }
      // The fill is fwd | bwd(original) on the whole column, so the row
      // above the band holds its forward carry cf, and bits that are in
      // the band's first row already; the row below holds the backward
      // carry cb and bits of the band's last row. For the dilation those
      // extra bits add nothing, so the carries stand in for the two rows.
      const int t_up = cf, t_dn = cb;
#pragma unroll
      for (int r = 0; r < kBand; ++r) {
        cf = a[r] | (g[r] & cf);
        grew |= cf ^ a[r];
        a[r] = cf;
      }
      // padding rows of the last band are zero and its incoming cb is 0
#pragma unroll
      for (int r = kBand - 1; r >= 0; --r) {
        cb = a[r] | (g[r] & cb);
        grew |= cb ^ a[r];
        a[r] = cb;
      }

      auto hor = [&](int v) {
        return v | __shfl_up_sync(kFull, v, 1) | __shfl_down_sync(kFull, v, 1);
      };
      const bool writer = live && lane >= 1 && lane <= kCols;
      int h_prev = hor(t_up), h_cur = hor(a[0]);
#pragma unroll
      for (int r = 0; r < kBand; ++r) {
        const int h_next = hor(r + 1 < kBand ? a[r + 1] : t_dn);
        if (writer && r < rows) {
          const size_t idx = off + (size_t)r * W;
          const int nv = ((h_prev | h_cur | h_next) & g[r]) | a[r];
          grew |= nv ^ a[r];
          p.edge[idx] = nv;
        }
        h_prev = h_cur;
        h_cur = h_next;
      }
    }
    if (__syncthreads_or(grew) && threadIdx.x == 0) {
      atomicOr(p.ctl + (s & 1), 1);
    }
    grid.sync();
    ++sweeps;
    if (!*(volatile int*)(p.ctl + (s & 1))) break;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *p.sweeps = sweeps;
}

constexpr size_t kSmemBytes = (size_t)kWarps * kWarpSmem * sizeof(int);

}  // namespace

extern "C" const char* img2sgf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Int32 words of the `scratch` buffer img2sgf_hysteresis needs.
extern "C" int img2sgf_hysteresis_scratch(int G, int H, int W) {
  const int nseg = (W + kSegWords - 1) / kSegWords;
  const int nband = (H + kBand - 1) / kBand;
  return 3 * G * H * nseg + 3 * G * nband * W + 2;
}

// Runs up to `iters` sweeps on edge0 ([G, H, W] int32, a subset of `gate`)
// into `edge` in one cooperative launch. t: scratch words [G, H, W];
// scratch: img2sgf_hysteresis_scratch(G, H, W) words. sweeps_out: a device
// int that receives the number of sweeps run. Launches on `stream` and
// returns without waiting for the kernel.
extern "C" int img2sgf_hysteresis(const int* edge0, int* edge, int* t,
                                  const int* gate, int* scratch, int G, int H,
                                  int W, int iters, int* sweeps_out,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(hysteresis_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kSmemBytes);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hysteresis_kernel,
                                                    kThreads, kSmemBytes);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;

  const int nseg = (W + kSegWords - 1) / kSegWords;
  const int nband = (H + kBand - 1) / kBand;
  Args a;
  a.edge0 = edge0;
  a.edge = edge;
  a.t = t;
  a.gate = gate;
  a.rsum = scratch;
  a.csum = scratch + 3 * (size_t)G * H * nseg;
  a.ctl = a.csum + 3 * (size_t)G * nband * W;
  a.sweeps = sweeps_out;
  a.G = G;
  a.H = H;
  a.W = W;
  a.iters = iters;
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel((const void*)hysteresis_kernel,
                                     dim3(per_sm * sms), dim3(kThreads), args,
                                     kSmemBytes, s);
}
