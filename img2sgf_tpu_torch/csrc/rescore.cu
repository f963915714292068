// K2: exact-vote rescore (OpenCV HOUGH_GRADIENT fixed-point votes on a
// cells x cells patch around each candidate centre).
//
// Replaces the Pallas kernel img2sgf_tpu/hough/rescore_pallas.py
// (exact_rescore_pallas, body _build_kernel.kern). For each candidate the
// edge pixels of the (2*(max_r+reach+2)+1)^2 window walk the sign toward
// the candidate over radii |r - rhat| <= kmax, and the central
// (4*reach+1)^2 block also walks the opposite sign
// (img2sgf_tpu/hough/circles.py exact_rescore). Landings are integer
// counts, exact in any order.
//
// Bound: the integer walk (about 10 int32 operations for each of 2*kmax+1
// radius steps of each edge pixel in a valid candidate's window, plus the
// central block's second walk) against the bytes of emask, and of sx and
// sy at the edge pixels inside valid windows.
//
// Design:
//   * A persistent grid walks only the (plane, candidate) pairs below each
//     plane's nvalid, one warp per pair, found from a prefix over nvalid
//     that every block builds in shared memory; the same blocks zero the
//     rows past each prefix. No warp works on a dead slot and the host
//     never reads nvalid.
//   * The warp reads the window's edge mask (0 outside the plane) in
//     coalesced 32-pixel chunks, one column of chunks at a time with kStage
//     rows in flight; each lane ors its kStage edge bits into a mask, and
//     one warp prefix over the masks' counts gives every lane its slots in
//     the warp's shared-memory list of edge-pixel positions. When the list
//     could not take another batch it is walked and emptied, so shared
//     memory is bounded by the list and any radius runs. A walk first
//     reads the steps of its listed pixels, every lane a pixel with all
//     loads in flight, then walks them, so every lane walks an edge pixel.
//   * rhat = round(|offset|) comes from a per-offset int32 table built on
//     the host (hough/rescore_cuda.py _geometry), not from per-pixel
//     double math.
//   * Landings go to the warp's own 32 shared counters; no block-wide
//     barrier is needed after the prefix.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 16;         // rows a warp reads before listing them
constexpr int kList = 768;         // list entries of a warp
static_assert(kList >= 32 * kStage, "a batch must fit an empty list");

template <int CELLS>
__device__ __forceinline__ void walk(int tx, int ty, int rhat, int box,
                                     int boy, int kmax, int min_r, int max_r,
                                     int* cnt) {
  constexpr int REACH = CELLS / 2;
  for (int k = -kmax; k <= kmax; ++k) {
    const int r = rhat + k;
    if (r < min_r || r > max_r) continue;
    const int ddx = ((r * tx) >> 10) - box;  // arithmetic shift = floor
    const int ddy = ((r * ty) >> 10) - boy;
    if (ddx < -REACH || ddx > REACH || ddy < -REACH || ddy > REACH) continue;
    atomicAdd(&cnt[(ddy + REACH) * CELLS + (ddx + REACH)], 1);
  }
}

// Shared memory: list[kWarps][kList] of (sx+1024 | sy+1024 << 16,
// u << 16 | v), then cnt[kWarps][32], then prefix[P + 1].
constexpr size_t kWarpBytes = kList * sizeof(int2) + 32 * sizeof(int);

// Reads the steps of the n listed pixels (all lanes' loads in flight
// together), then walks them into cnt.
template <int CELLS>
__device__ __forceinline__ void walk_list(int2* list, int n, int lane,
                                          const int* sx, const int* sy,
                                          size_t corner, int W,
                                          const int* rhat_tab, int ext,
                                          int win, int kmax, int min_r,
                                          int max_r, int* cnt) {
  constexpr int IH = 2 * (CELLS / 2);
#pragma unroll 4
  for (int i = lane; i < n; i += 32) {
    const int uv = list[i].y;
    const size_t at = corner + (size_t)(uv >> 16) * W + (uv & 0xFFFF);
    list[i].x = (sx[at] + 1024) | ((sy[at] + 1024) << 16);
  }
  __syncwarp();
  for (int i = lane; i < n; i += 32) {
    const int2 en = list[i];
    const int u = en.y >> 16, v = en.y & 0xFFFF;
    const int boy = ext - u;  // centre - pixel
    const int box = ext - v;
    const int wx = (en.x & 0xFFFF) - 1024;
    const int wy = (en.x >> 16) - 1024;
    const int rhat = __ldg(rhat_tab + u * win + v);
    const int sg = (wy * boy + wx * box >= 0) ? 1 : -1;
    walk<CELLS>(sg * wx, sg * wy, rhat, box, boy, kmax, min_r, max_r, cnt);
    if (boy >= -IH && boy <= IH && box >= -IH && box <= IH) {
      walk<CELLS>(-sg * wx, -sg * wy, rhat, box, boy, kmax, min_r, max_r,
                  cnt);
    }
  }
  __syncwarp();
}

template <int CELLS>
__global__ void __launch_bounds__(kThreads)
rescore_kernel(const unsigned char* __restrict__ emask,
               const int* __restrict__ sx, const int* __restrict__ sy,
               const int* __restrict__ ys, const int* __restrict__ xs,
               const int* __restrict__ nvalid,
               const int* __restrict__ rhat_tab, float* __restrict__ out,
               int P, int H, int W, int K, int min_r, int max_r, int kmax) {
  constexpr int NC = CELLS * CELLS;
  extern __shared__ int2 smem2[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int2* list = smem2 + warp * kList;
  int* cnt = reinterpret_cast<int*>(smem2 + kWarps * kList) + warp * 32;
  int* prefix = reinterpret_cast<int*>(smem2 + kWarps * kList) + kWarps * 32;

  if (warp == 0) {
    int carry = 0;
    for (int p0 = 0; p0 < P; p0 += 32) {
      int v = p0 + lane < P ? nvalid[p0 + lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(kFull, v, d);
        if (lane >= d) v += t;
      }
      if (p0 + lane < P) prefix[p0 + lane + 1] = carry + v;
      carry += __shfl_sync(kFull, v, 31);
    }
    if (lane == 0) prefix[0] = 0;
  }
  __syncthreads();

  // rows past each plane's valid prefix are zero
  const size_t gtid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t gstride = (size_t)gridDim.x * kThreads;
  for (int p = 0; p < P; ++p) {
    const size_t hi = ((size_t)p + 1) * K * NC;
    const size_t lo = ((size_t)p * K + (prefix[p + 1] - prefix[p])) * NC;
    for (size_t i = lo + gtid; i < hi; i += gstride) out[i] = 0.f;
  }

  const int total = prefix[P];
  const int ext = max_r + CELLS / 2 + 2;
  const int win = 2 * ext + 1;
  const int nchunk = (win + 31) / 32;
  for (int w = blockIdx.x * kWarps + warp; w < total;
       w += gridDim.x * kWarps) {
    int lo = 0, hi = P;  // prefix[lo] <= w < prefix[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (prefix[mid] <= w) lo = mid; else hi = mid;
    }
    const int p = lo;
    const size_t slot = (size_t)p * K + (w - prefix[p]);
    const int cy = ys[slot];
    const int cx = xs[slot];
    cnt[lane] = 0;
    __syncwarp();

    // plane offset of window pixel (0, 0); only in-plane pixels are listed
    const size_t corner = ((size_t)p * H + (cy - ext)) * W + (cx - ext);
    int n = 0;  // entries in the list, the same in every lane
    // column-major over 32-pixel chunks: a lane's column test and address
    // hold for the whole chunk column
    for (int ci = 0; ci < nchunk; ++ci) {
      const int v = ci * 32 + lane;
      const int xx = cx - ext + v;
      const bool col_ok = v < win && xx >= 0 && xx < W;
      const unsigned char* col = emask + (size_t)p * H * W + (col_ok ? xx : 0);
      for (int u0 = 0; u0 < win; u0 += kStage) {
        if (n > kList - 32 * kStage) {
          walk_list<CELLS>(list, n, lane, sx, sy, corner, W, rhat_tab, ext,
                           win, kmax, min_r, max_r, cnt);
          n = 0;
        }
        unsigned bits = 0;  // this lane's edge pixels among the kStage rows
#pragma unroll
        for (int c = 0; c < kStage; ++c) {
          const int yy = cy - ext + u0 + c;
          const bool e = col_ok && u0 + c < win &&
                         (unsigned)yy < (unsigned)H && col[(size_t)yy * W];
          bits |= (unsigned)e << c;
        }
        // slots by an exclusive warp prefix over the lanes' counts
        const int mine = __popc(bits);
        int upto = mine;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int t = __shfl_up_sync(kFull, upto, d);
          if (lane >= d) upto += t;
        }
        int slot = n + upto - mine;
        while (bits) {
          const int c = __ffs(bits) - 1;
          bits &= bits - 1;
          list[slot++].y = ((u0 + c) << 16) | v;
        }
        n += __shfl_sync(kFull, upto, 31);
        __syncwarp();
      }
    }
    walk_list<CELLS>(list, n, lane, sx, sy, corner, W, rhat_tab, ext, win,
                     kmax, min_r, max_r, cnt);
    if (lane < NC) out[slot * NC + lane] = (float)cnt[lane];
    __syncwarp();
  }
}

template <int CELLS>
int launch(const unsigned char* emask, const int* sx, const int* sy,
           const int* ys, const int* xs, const int* nvalid, const int* rhat,
           float* out, int P, int H, int W, int K, int min_r, int max_r,
           int kmax, cudaStream_t s) {
  const size_t smem = kWarps * kWarpBytes + (size_t)(P + 1) * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      rescore_kernel<CELLS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rescore_kernel<CELLS>, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  rescore_kernel<CELLS><<<per_sm * sms, kThreads, smem, s>>>(
      emask, sx, sy, ys, xs, nvalid, rhat, out, P, H, W, K, min_r, max_r,
      kmax);
  return cudaGetLastError();
}

}  // namespace

// emask: [P, H, W] bool; sx, sy: [P, H, W] int32 walk steps in
// [-1024, 1024]; ys, xs: [P, K] int32; nvalid: [P] int32; rhat:
// [win * win] int32 per-offset table; out: [P, K, cells*cells] f32.
extern "C" int img2sgf_rescore(const unsigned char* emask, const int* sx,
                               const int* sy, const int* ys, const int* xs,
                               const int* nvalid, const int* rhat, float* out,
                               int P, int H, int W, int K, int cells,
                               int min_r, int max_r, int kmax, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cells == 5) {
    return launch<5>(emask, sx, sy, ys, xs, nvalid, rhat, out, P, H, W, K,
                     min_r, max_r, kmax, s);
  }
  if (cells == 3) {
    return launch<3>(emask, sx, sy, ys, xs, nvalid, rhat, out, P, H, W, K,
                     min_r, max_r, kmax, s);
  }
  return cudaErrorInvalidValue;
}
