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
// are dropped. Counts are integers below 2^24, summed exactly in int32
// shared atomics (their order does not matter) and written once as
// float32, so the kernel equals the plain versions bit for bit.
//
// Bound: bytes, one read of the labels and one write of the float32
// accumulator (5 bytes a pixel); the votes (2 * n_r per edge pixel, one
// int32 add each) take a fraction of that at the int32 rate on the sparse
// edge planes of a diagram. A first design (a block per 64 x 128 tile
// scanning a window 2.84x the tile one byte a thread a step, a barrier
// every 512 pixels, a warp per staged pixel through the dependent loads
// lb -> start -> entries) ran at 3.5-6.1 % of that bound on an H100.
// Measured there (per-block clock stamps and variants of this kernel;
// PERF.md, Findings), the time of a tile went to short phases between
// barriers and to branchy per-pixel code, not to loads or to the shared
// atomics: removing the atomics saved 7 %. So this design:
//   * One block of kThreads per (plane, 128 x 128 output tile), the int32
//     counts in shared memory (row stride 129: a column of targets spreads
//     over the banks), zeroed with 16-byte stores and written once,
//     coalesced, as float32: no zero pass, no global atomics. 64-row tiles
//     walk ~2.0x the tile's pixels against ~1.7x and were slower in every
//     case measured.
//   * Blocks take the planes fastest and, within a plane, the interior
//     tiles before the border ring: at 768^2 the 288 blocks outnumber the
//     264 that fit at once, and the blocks of the second wave are then
//     border tiles, where a diagram has fewest edges, rather than the last
//     plane's centre (0.072 -> 0.055 ms there, together with the passes'
//     division-free stepping).
//   * The window is the tile grown by the table's own extents (the largest
//     and smallest dy and dx over all bins), clipped to the plane, read as
//     16-byte chunks aligned on the label buffer's addresses, one uint4
//     load a thread, the next chunk's load issued before the current one is
//     used. Chunks are masked by coordinates (the window's columns), never
//     by their contents; a chunk that would cross either end of the buffer
//     is read byte by byte. Any plane width and any halo below 8000.
//   * Only pixels that can reach the tile are staged: bin d's entries span
//     [dymin_d, dymax_d] x [dxmin_d, dxmax_d] (about r_max |sin phi| by
//     r_max |cos phi|, uploaded beside the table), and an edge pixel of bin
//     d outside the tile grown by that span casts no vote into it. A
//     chunk's edge pixels are taken a label at a time (edges cluster: a row
//     along a line is one label), a run's columns tested at once.
//   * Two barrier-free passes over the window group the staged pixels by
//     bin: a counting pass (a histogram, each round's count, a bit for each
//     chunk that holds a staged pixel), one warp's scan, and a scatter pass
//     over the marked chunks alone that writes each pixel's tile-relative
//     (y, x) as two biased 15-bit halves of a word into its bin's run. The
//     window is one piece unless its edges are dense (more than kList
//     staged pixels): then runs of rounds are counted, sorted and walked in
//     turn.
//   * The walk: each bin's run is cut into chunks of kChunk pixels, and a
//     warp takes a chunk with kPerLane of the bin's entries a lane in
//     registers (read once a chunk). Four pixels a step are loaded first;
//     a vote is one add to the packed word, one test of its bits against
//     the tile, and one unconditional shared reduction, to the target or,
//     outside the tile, to the lane's own word of the padding column: no
//     branch (a predicated atomic became one). A bin with more than 32 *
//     kPerLane entries is walked in groups of that many.

#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

namespace {

constexpr int kTileH = 128;
constexpr int kTileW = 128;
constexpr int kStride = kTileW + 1;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kList = 16 * kThreads;  // the pixels of one round
constexpr int kChunk = 32;    // pixels of one bin a warp walks at once
constexpr int kPerLane = 2;   // table entries a lane holds in registers
constexpr int kMaxBins = 256; // the prefix arrays hold nb + 1 <= 255 entries
constexpr int kFar = -(1 << 15);  // dy of an empty register slot: no tile
constexpr int kRounds = 32;   // rounds of kThreads chunks a segment
// A staged pixel is one word, (ry + kBias) << 16 | (rx + kBias), its row
// and column relative to the tile; adding an entry's (dy << 16) + dx moves
// both halves without a carry between them (every |coordinate| and
// |offset| is below kBias), and the target lies in the kTileH x kTileW
// tile iff (word ^ kBias2) & ~((kTileH - 1) << 16 | (kTileW - 1)) is zero.
constexpr int kBias = 1 << 14;
constexpr unsigned kBias2 = (unsigned)kBias << 16 | kBias;

// The 16-bit mask of the bytes of v whose per-byte comparison q (0xff or
// 0 in each byte, from a __vcmp*4) holds: the multiply moves bits 7, 15,
// 23 and 31 of a word to 28-31 without carries (the other partial products
// land apart).
__device__ __forceinline__ unsigned byte_mask(unsigned q0, unsigned q1,
                                              unsigned q2, unsigned q3) {
  const unsigned q[4] = {q0, q1, q2, q3};
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    m |= (((q[j] & 0x80808080u) * 0x00204081u) >> 28) << (4 * j);
  }
  return m;
}

// The bytes of v below nb (a label that votes; nb4: nb in each byte). For
// nb <= 128, (x | 0x80) - nb keeps each byte apart (no borrow) and clears
// its top bit iff x & 0x7f < nb, so ~(that | x) has it iff x < nb.
__device__ __forceinline__ unsigned vote_bytes(uint4 v, unsigned nb4) {
  if (nb4 <= 0x80808080u) {
    const unsigned q[4] = {v.x, v.y, v.z, v.w};
    unsigned r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = ~(((q[j] | 0x80808080u) - nb4) | q[j]);
    return byte_mask(r[0], r[1], r[2], r[3]);
  }
  return byte_mask(__vcmpltu4(v.x, nb4), __vcmpltu4(v.y, nb4),
                   __vcmpltu4(v.z, nb4), __vcmpltu4(v.w, nb4));
}

// The bytes of v equal to label b: a byte x ^ b is zero iff adding 0x7f to
// its low seven bits leaves the top bit clear and x ^ b has none either.
__device__ __forceinline__ unsigned label_bytes(uint4 v, int b) {
  const unsigned b4 = 0x01010101u * (unsigned)b;
  const unsigned q[4] = {v.x ^ b4, v.y ^ b4, v.z ^ b4, v.w ^ b4};
  unsigned r[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    r[j] = ~(((q[j] & 0x7f7f7f7fu) + 0x7f7f7f7fu) | q[j]);
  }
  return byte_mask(r[0], r[1], r[2], r[3]);
}

// Add w to the shared int at byte address addr: a reduction with no
// result and no branch. The counts are read only after a __syncthreads, so
// the compiler need not order other accesses around it.
__device__ __forceinline__ void vote(unsigned addr, int w) {
  asm volatile("red.shared.add.u32 [%0], %1;" ::"r"(addr), "r"(w));
}

__device__ __forceinline__ int byte_of(uint4 v, int k) {
  const unsigned w = k < 8 ? (k < 4 ? v.x : v.y) : (k < 12 ? v.z : v.w);
  return (w >> (8 * (k & 3))) & 0xff;
}

// The window of one tile: the tile grown by the table's bounds, clipped to
// the plane, read as 16-byte chunks aligned on the label buffer's
// addresses, cpr chunk slots a row (enough for the row's span from the
// boundary at or below its first byte), row-major.
struct Window {
  const unsigned char* labels;
  long long n_bytes;  // P * H * W
  long long row0;     // the buffer index of the window's first row, column 0
  int W, wx0, wx1, wy0, cpr, n_chunks;
  int ty0, tx0, th, tw;
  unsigned nb4;       // nb in each byte
};

// Chunk (r, cc) of the window (row r, cc-th 16-byte slot of the row): its
// 16 labels, its row and the column of its first byte (relative to the
// row's column 0; the bytes before wx0 or from wx1 on are masked by column,
// never by content). A chunk that would cross either end of the buffer is
// read byte by byte.
__device__ __forceinline__ uint4 load_chunk(const Window& w, int r, int cc,
                                            int& y, int& col0) {
  y = w.wy0 + r;
  const long long row = w.row0 + (long long)r * w.W;
  const uintptr_t a = reinterpret_cast<uintptr_t>(w.labels + row + w.wx0);
  const long long at = row + w.wx0 - (long long)(a & 15) + 16 * cc;
  col0 = (int)(at - row);
  if (at >= 0 && at + 16 <= w.n_bytes) {
    return __ldg(reinterpret_cast<const uint4*>(w.labels + at));
  }
  unsigned b[4] = {~0u, ~0u, ~0u, ~0u};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const long long i = at + k;
    if (i >= 0 && i < w.n_bytes) {
      b[k >> 2] &= ~(0xffu << (8 * (k & 3))) |
                   ((unsigned)w.labels[i] << (8 * (k & 3)));
    }
  }
  return make_uint4(b[0], b[1], b[2], b[3]);
}

// The tile (row, column) of a plane taken r-th: the interior tiles
// row-major, then the border ring (top row, bottom row, left and right
// columns). Blocks run the planes fastest, so the last blocks of a grid
// that outnumbers the SMs' slots are border tiles, where a diagram has
// fewest edges, and the heavy interior starts in the first wave.
__device__ __forceinline__ void tile_of_rank(int r, int tiles_x, int tiles_y,
                                             int& ty, int& tx) {
  const int ix = tiles_x - 2, iy = tiles_y - 2;
  if (ix < 1 || iy < 1) {  // every tile on the border
    ty = r / tiles_x;
    tx = r - ty * tiles_x;
    return;
  }
  if (r < ix * iy) {
    ty = 1 + r / ix;
    tx = 1 + r % ix;
    return;
  }
  r -= ix * iy;
  if (r < 2 * tiles_x) {
    ty = r < tiles_x ? 0 : tiles_y - 1;
    tx = r < tiles_x ? r : r - tiles_x;
    return;
  }
  r -= 2 * tiles_x;
  ty = 1 + (r < iy ? r : r - iy);
  tx = r < iy ? 0 : tiles_x - 1;
}

enum Pass { kCount, kHist, kScatter };

// One pass over chunks [g_lo, g_hi) of the window, kThreads apart: each
// thread takes its chunks in turn, the next one's load issued before the
// current one is used, and no barrier. A chunk's edge pixels are taken a
// label at a time (edges cluster: a row along a line is one label), each
// run of one label tested against the tile grown by its bin's span (ext)
// at once. kCount adds the reaching pixels to hist and to their round's
// count (a round: kThreads chunks from g_lo); kHist to hist alone;
// kScatter writes each into its bin's run as its packed word (kBias).
template <Pass kMode>
__device__ __forceinline__ void pass(const Window& w, const short4* ext,
                                     int g_lo, int g_hi, int g_seg, int* hist,
                                     int* pos, int* list, int* rcount,
                                     unsigned* busy) {
  const int t = threadIdx.x;
  // kCount marks the chunks that hold a reaching pixel in busy (a bit a
  // chunk of the segment from g_seg); the other passes load only those
  auto wanted = [&](int g) {
    return g < g_hi &&
           (kMode == kCount || (busy[(g - g_seg) >> 5] >> (t & 31) & 1u));
  };
  // chunk g is (row, slot) (g / cpr, g % cpr); a thread's chunks are
  // kThreads apart, so it steps by (kThreads / cpr, kThreads % cpr)
  int g = g_lo + t;
  int r = g / w.cpr, cc = g - r * w.cpr;
  const int dr = kThreads / w.cpr, dcc = kThreads - dr * w.cpr;
  int y = -1, col0 = 0;
  uint4 v = make_uint4(~0u, ~0u, ~0u, ~0u);
  if (wanted(g)) v = load_chunk(w, r, cc, y, col0);
  for (int round = 0; g_lo + round * kThreads < g_hi; ++round) {
    r += dr;
    cc += dcc;
    if (cc >= w.cpr) {
      cc -= w.cpr;
      ++r;
    }
    int ny = -1, ncol0 = 0;
    uint4 nv = v;
    if (wanted(g + kThreads)) nv = load_chunk(w, r, cc, ny, ncol0);
    const int k_lo = max(w.wx0 - col0, 0);
    const int k_hi = min(w.wx1 - col0, 16);
    unsigned m = 0;
    if (y >= 0 && k_hi > k_lo) {
      m = vote_bytes(v, w.nb4) & (((1u << (k_hi - k_lo)) - 1) << k_lo);
    }
    const int ry = y - w.ty0;
    int found = 0;
    while (m) {
      const int b = byte_of(v, __ffs(m) - 1);
      const unsigned same = label_bytes(v, b) & m;
      m &= ~same;
      const short4 e = ext[b];
      // the columns whose pixels of bin b reach the tile, if the row does
      const int lo = max(w.tx0 - e.w - col0, 0);
      const int hi = min(w.tx0 + w.tw - e.z - col0, 16);
      if (ry + e.y < 0 || ry + e.x >= w.th || hi <= lo) continue;
      unsigned run = same & (((1u << (hi - lo)) - 1) << lo);
      if (!run) continue;
      const int n = __popc(run);
      if (kMode == kScatter) {
        int i = atomicAdd(&pos[b], n);
        do {
          const int k = __ffs(run) - 1;
          run &= run - 1;
          list[i++] = (int)((unsigned)(ry + kBias) << 16 |
                            (unsigned)(col0 + k - w.tx0 + kBias));
        } while (run);
      } else {
        atomicAdd(&hist[b], n);
        found += n;
      }
    }
    if (kMode == kCount) {
      const unsigned any = __ballot_sync(0xffffffffu, found > 0);
      const int n = __reduce_add_sync(0xffffffffu, found);
      if ((t & 31) == 0) {
        busy[(g - (t & 31) - g_seg) >> 5] = any;
        if (n) atomicAdd(&rcount[round], n);
      }
    }
    g += kThreads;
    v = nv;
    y = ny;
    col0 = ncol0;
  }
}

// The block's shared memory, in ints: counts, list, table offsets, hist,
// pos, prefixes, round counts, piece bounds (kRounds + 1), two scalars
// (rounded up to an even count) and a bit a chunk of the segment; then the
// bins' spans.
constexpr int kInts = kTileH * kStride + kList + 4 * kMaxBins + 2 * kRounds +
                      4 + kRounds * kWarps;
constexpr size_t kSmemBytes = sizeof(int) * (size_t)kInts +
                              sizeof(short4) * kMaxBins;

__global__ void __launch_bounds__(kThreads, 2)
accumulator_kernel(const unsigned char* __restrict__ labels,
                   const int* __restrict__ start,
                   const int* __restrict__ entries, int E,
                   const short4* __restrict__ ext, float* __restrict__ out,
                   int P, int H, int W, int nb, int ymin, int ymax, int xmin,
                   int xmax, int tiles_x, int tiles_y) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* cnt = reinterpret_cast<int*>(smem);  // [kTileH][kStride] counts
  int* list = cnt + kTileH * kStride;       // [kList] pixels, by bin
  int* s_start = list + kList;              // [nb + 1] table offsets
  int* hist = s_start + kMaxBins;           // [nb] pixels of a piece
  int* pos = hist + kMaxBins;               // [nb] scatter cursors
  int* pre = pos + kMaxBins;                // [nb + 1] (chunks << 16) | pixels
  int* rcount = pre + kMaxBins;             // [kRounds] pixels of a round
  int* first = rcount + kRounds;            // [kRounds + 1] a piece's rounds
  int* s_n = first + kRounds + 1;           // pieces; chunks of a piece
  unsigned* busy = reinterpret_cast<unsigned*>(s_n + 3);   // [kRounds * kWarps]
  short4* s_ext = reinterpret_cast<short4*>(cnt + kInts);  // [nb] spans

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int p = blockIdx.x % P;
  int trow, tcol;
  tile_of_rank(blockIdx.x / P, tiles_x, tiles_y, trow, tcol);
  Window w;
  w.labels = labels;
  w.n_bytes = (long long)P * H * W;
  w.W = W;
  w.nb4 = 0x01010101u * (unsigned)nb;
  w.ty0 = trow * kTileH;
  w.tx0 = tcol * kTileW;
  w.th = min(kTileH, H - w.ty0);
  w.tw = min(kTileW, W - w.tx0);
  // rows y with y + ymax >= ty0 and y + ymin < ty0 + th, in the plane;
  // likewise the columns
  w.wy0 = max(w.ty0 - ymax, 0);
  const int wy1 = min(w.ty0 + w.th - ymin, H);
  w.wx0 = max(w.tx0 - xmax, 0);
  w.wx1 = min(w.tx0 + w.tw - xmin, W);
  w.cpr = (w.wx1 - w.wx0 + 30) >> 4;
  w.n_chunks = (wy1 > w.wy0 && w.wx1 > w.wx0) ? (wy1 - w.wy0) * w.cpr : 0;
  w.row0 = ((long long)p * H + w.wy0) * W;
  const int* tdy = entries;
  const int* tdx = entries + E;
  const int* twt = entries + 2 * (size_t)E;
  // the shared byte address of the counts as the biased coordinates index
  // them, and the bits that are set in a target outside the tile
  const unsigned cnt0 = (unsigned)__cvta_generic_to_shared(cnt) -
                        4u * (kBias * kStride + kBias);
  const unsigned pad = (unsigned)__cvta_generic_to_shared(
      cnt + (t & 31) * kStride + kTileW);
  constexpr unsigned kOutside = ~((unsigned)(kTileH - 1) << 16 | (kTileW - 1));

  // the table offsets and spans, loaded while the counts are zeroed
  // (nb + 1 <= kThreads)
  const int t_start = t <= nb ? __ldg(start + t) : 0;
  const short4 t_ext = t < nb ? ext[t] : short4{};
  for (int i = t; i < kTileH * kStride / 4; i += kThreads) {
    reinterpret_cast<int4*>(cnt)[i] = make_int4(0, 0, 0, 0);
  }
  if (t <= nb) s_start[t] = t_start;
  if (t < nb) {
    s_ext[t] = t_ext;
    hist[t] = 0;
  }
  for (int r = t; r < kRounds; r += kThreads) rcount[r] = 0;
  __syncthreads();  // the counts, spans, table offsets and hist are in place

  // the window in segments of up to kRounds rounds of kThreads chunks; a
  // segment's rounds are walked in pieces of at most kList pixels (one
  // piece unless its edges are dense)
  for (int g0 = 0; g0 < w.n_chunks; g0 += kRounds * kThreads) {
    const int g_end = min(g0 + kRounds * kThreads, w.n_chunks);
    pass<kCount>(w, s_ext, g0, g_end, g0, hist, pos, list, rcount, busy);
    __syncthreads();
    if (t == 0) {  // pieces: runs of rounds of at most kList pixels
      const int n_rounds = (g_end - g0 + kThreads - 1) / kThreads;
      int n = 0, sum = 0;
      first[0] = 0;
      for (int r = 0; r < n_rounds; ++r) {
        if (sum + rcount[r] > kList) {
          first[++n] = r;
          sum = 0;
        }
        sum += rcount[r];
        rcount[r] = 0;
      }
      first[++n] = n_rounds;
      s_n[0] = n;
    }
    __syncthreads();
    const int n_pieces = s_n[0];
    for (int pc = 0; pc < n_pieces; ++pc) {
      const int g_lo = g0 + first[pc] * kThreads;
      const int g_hi = min(g0 + first[pc + 1] * kThreads, g_end);
      if (n_pieces > 1) {  // the counting pass's hist spans every piece
        for (int d = t; d < nb; d += kThreads) hist[d] = 0;
        __syncthreads();
        pass<kHist>(w, s_ext, g_lo, g_hi, g0, hist, pos, list, rcount, busy);
        __syncthreads();
      }

      // one warp: each bin's first pixel and chunk in the sorted piece
      if (warp == 0) {
        int own[8];
        int run = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int d = lane * 8 + j;
          const int n = d < nb ? hist[d] : 0;
          own[j] = (((n + kChunk - 1) / kChunk) << 16) | n;
          run += own[j];
        }
        int incl = run;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int u = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += u;
        }
        int excl = incl - run;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int d = lane * 8 + j;
          if (d < nb) {
            pre[d] = excl;
            pos[d] = excl & 0xffff;
            hist[d] = 0;
          }
          excl += own[j];
        }
        if (lane == 31) {
          pre[nb] = incl;
          s_n[1] = incl >> 16;
        }
      }
      __syncthreads();  // the prefixes are in place
      pass<kScatter>(w, s_ext, g_lo, g_hi, g0, hist, pos, list, rcount,
                     busy);
      __syncthreads();  // the piece is sorted

      // the walk: a warp a chunk of one bin's run, the bin's entries in
      // registers
      const int n_chunk = s_n[1];
      for (int c = warp; c < n_chunk; c += kWarps) {
        // the last bin whose chunks start at or before c
        int lo = 0, hi = nb - 1;
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if ((pre[mid] >> 16) <= c) lo = mid; else hi = mid - 1;
        }
        const int k0 = (pre[lo] & 0xffff) + (c - (pre[lo] >> 16)) * kChunk;
        const int k1 = min(k0 + kChunk, pre[lo + 1] & 0xffff);
        const int e1 = s_start[lo + 1];
        for (int eb = s_start[lo]; eb < e1; eb += 32 * kPerLane) {
          int step[kPerLane], off[kPerLane], wt[kPerLane];
#pragma unroll
          for (int j = 0; j < kPerLane; ++j) {
            const int e = eb + 32 * j + lane;
            const int dy = e < e1 ? __ldg(tdy + e) : kFar;
            const int dx = e < e1 ? __ldg(tdx + e) : 0;
            wt[j] = e < e1 ? __ldg(twt + e) : 0;
            step[j] = dy * 65536 + dx;
            off[j] = 4 * (dy * kStride + dx);
          }
          // four pixels a step, loaded first (a word of 0 lies far outside
          // the tile); a vote outside the kTileH x kTileW tile goes to the
          // lane's own word of the padding column, which no vote inside
          // reaches and no write reads, so every vote is one unconditional
          // reduction (rows and columns past the plane's edge are counted
          // and never written out)
          for (int k = k0; k < k1; k += 4) {
            unsigned q[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              q[i] = k + i < k1 ? (unsigned)list[k + i] : 0u;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const unsigned at =
                  cnt0 + 4 * ((q[i] >> 16) * kStride + (q[i] & 0xffff));
#pragma unroll
              for (int j = 0; j < kPerLane; ++j) {
                const bool in = !(((q[i] + step[j]) ^ kBias2) & kOutside);
                vote(in ? at + off[j] : pad, wt[j]);
              }
            }
          }
        }
      }
    }
  }
  __syncthreads();

  // each thread writes one column of the tile, every kThreads / kTileW-th
  // row, coalesced across the warp
  constexpr int kRowStep = kThreads / kTileW;
  const int xx = t & (kTileW - 1);
  if (xx < w.tw) {
    float* o = out + ((size_t)p * H + w.ty0 + (t >> 7)) * W + w.tx0 + xx;
    const int* c = cnt + (t >> 7) * kStride + xx;
#pragma unroll 4
    for (int yy = t >> 7; yy < w.th; yy += kRowStep) {
      *o = static_cast<float>(*c);
      o += (size_t)kRowStep * W;
      c += kRowStep * kStride;
    }
  }
}

// Opt the kernel in to its shared memory (past the 48 KB default) and to
// the largest carveout, once per device.
cudaError_t prepare() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(accumulator_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kSmemBytes);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(accumulator_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  }
  if (e == cudaSuccess) done.fetch_or(bit);
  return e;
}

}  // namespace

// labels: [P, H, W] uint8 direction labels (label >= nb: no vote); start:
// [nb + 1] int32 offsets into the table; entries: [3, E] int32 rows dy, dx,
// weight; ext: [nb, 4] int16 per-bin spans (dymin, dymax, dxmin, dxmax;
// an empty bin's span is empty); ymin..xmax: the spans over all bins;
// out: [P, H, W] float32, every element written. nb <= 254 and every
// |offset| < 8000 (hough/accumulator_cuda.py MAX_HALO). Returns a
// cudaError_t.
extern "C" int img2sgf_accumulator(const unsigned char* labels,
                                   const int* start, const int* entries,
                                   int E, const void* ext, float* out, int P,
                                   int H, int W, int nb, int ymin, int ymax,
                                   int xmin, int xmax, void* stream) {
  if (nb < 1 || nb >= kMaxBins - 1) return cudaErrorInvalidValue;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles_y = (H + kTileH - 1) / kTileH;
  const long long blocks = (long long)P * tiles_x * tiles_y;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  const cudaError_t e = prepare();
  if (e != cudaSuccess) return e;
  accumulator_kernel<<<(unsigned)blocks, kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      labels, start, entries, E, static_cast<const short4*>(ext), out, P, H,
      W, nb, ymin, ymax, xmin, xmax, tiles_x, tiles_y);
  return cudaGetLastError();
}
