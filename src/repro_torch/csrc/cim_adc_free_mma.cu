// ADC-free CIM matmul and implicit-GEMM conv for Hopper (sm_90a) on the
// int8 tensor cores. Plain C interface, loaded with ctypes by
// repro_torch/kernels/_build.py.
//
// Replaces, for integer digit planes (int8, or int4 nibble pairs):
//   repro/kernels/cim_adc_free.py::cim_matmul_adc_free_pallas (:98), bodies
//     `_kernel` (:46) and `_kernel_sparse` (:66); entry point
//     cim_matmul_adc_free_mma_launch;
//   repro/kernels/cim_adc_free.py::cim_conv_adc_free_pallas (:180), which
//     takes stretched-kernel patches outside its Pallas kernel and lowers
//     them onto the matmul; here the kernel gathers the patch rows itself
//     from the NHWC codes (implicit GEMM), and no patch tensor exists;
//     entry point cim_conv_adc_free_implicit_launch.
// Float32 planes (cell variation) keep the float64 branch of cim_matmul.cu.
//
//   out[m,n] = sum_t sum_s deq[s,t,n] * rint(p[m,s,t,n]),
//   p[m,s,t,n] = sum_r a[m,t,r] * d[s,t,r,n]
//
// Numerics. |p| <= 128 * 255 * 127 < 2^24, so the s32 tensor-core sum is
// exact in any order and equals the dp4a sum; (float)p is exact and rintf
// is the identity. Zero rows may be added to both operands and the rows
// permuted freely. The shift-and-add keeps the plain version's float32
// order: t outer, s inner, one rounded multiply and one rounded add
// (__fmul_rn, __fadd_rn; no FMA contraction). So the kernel is bit-exact
// with repro_torch.kernels.ref.cim_matmul_adc_free_ref and adc_free equals
// emulate with psum_quant off. Build without --use_fast_math.
//
// What bounds it on this card. At the main path's shapes (ResNet-20 at
// batch 256, 3-bit weights on 1-bit cells: S = 3; 3x3 convs with 14
// channels per array, rows 126, k_tiles 2-5; N 16-64) a conv reads at most
// 4.2 MB of codes and writes up to 16.8 MB of float32 output, against
// ~6 G int8 MACs: bound by bytes (~6 us a layer at 3.35 TB/s), the output
// being most of them. The old route wrote each conv's patches to device
// memory (66 MB for a first-stage conv) and read them back on dp4a with
// byte loads. Measured on H100 while this design took shape: forming
// tiles byte by byte in shared memory cost more than the MACs; then the
// number of 16-byte requests through L1 (a granule per row, tap and tile:
// 18 per output pixel of a first-stage conv) set the pace, and after
// that the MMA chains. So:
//   - K5 gathers its patch rows itself (implicit GEMM): output row m is
//     (b, ho, wo) in conv_as_matmul's order, logical row r of tile t is
//     tap (dh, dw) = divmod(r / cpa, kw) and channel c = r % cpa, and the
//     code is a[b, ho*stride + dh - ph_lo, wo*stride + dw - pw_lo,
//     t*cpa + c], zero outside the image and for channels >= C_in. The
//     pads, H' and W' come from the wrapper (ref.conv_geometry, XLA's SAME
//     rule: 0 before and 1 after at stride 2 on an even input);
//   - window mode (C_in a multiple of 16, a 16-byte aligned base, windows
//     of at most 32 KB: every conv of ResNet-20): a row block's input rows
//     are one contiguous range of the NHWC codes, copied once with 16-byte
//     cp.async into shared memory, all its pixels and channels, whatever
//     the stride, padding or image boundary; the A fragments are then read
//     from it by ldmatrix with per-lane row addresses (a 16-byte granule of
//     a pixel per row, a zero granule outside the image), so no A tile is
//     formed and each code crosses L1 once per row block;
//   - the digit operand is laid out to match: tile t's segments start at
//     the same offset within their granule (t * cpa mod 16), so the tile
//     row holds taps x ceil((shift + len) / 16) granules and the digits
//     under a neighbouring tile's codes are zero. A small relayout
//     kernel writes every plane K-major this way, nibbles decoded
//     (ldmatrix.trans takes no 8-bit elements), into a workspace the
//     wrapper keeps beside the planes with the id of its layout: it runs
//     once per plane and layout, not once per call (a per-call relayout
//     would read and write every plane again on each call);
//   - K4 reads pre-tiled codes (M, kt, rows): granules straight into an A
//     tile where rows is a multiple of 16; otherwise (rows 126), and for
//     a conv outside window mode, each segment's aligned window is staged
//     and shifted into the A tile 16 bytes at a time (funnel shifts,
//     masks). Shapes of any alignment take a slower path of the same
//     kernel, never another route;
//   - MACs on mma.sync m16n8k32 (u8/s8 x s8 -> s32), fragments by
//     ldmatrix.x4 from rows padded by 16 bytes (conflict-free); one A
//     fragment serves up to three splits, whose MMA chains are independent;
//   - persistent blocks (as many as fit on the card): a block owns BN =
//     16, 32 or 64 columns (all of N up to 64) and walks row blocks of BM
//     = 128 rows (64 when 128-row blocks would leave SMs idle), 16 rows a
//     warp; its (row block, tile) steps run as one pipeline, the next
//     step's copies in flight under this step's MACs. Digit tiles stay
//     resident for the whole launch where they fit beside three blocks per
//     SM, else they are double (or single) buffered per step;
//   - dead (t, s) planes (occupancy map, decided once per block over its
//     columns) are neither copied nor multiplied; their p = 0 still goes
//     through the epilogue, as in cim_matmul.cu;
//   - the epilogue runs on the fragments in registers, the scales from
//     shared memory, and the output is written once, two floats per store.

// Nibble planes (uint8, half-split per group): packed row g*gh + w holds
// logical row g*2gh + w in its low nibble and g*2gh + gh + w in its high
// nibble; each decodes as ((x ^ 8) - 8). groups = kh*kw for the conv.
//
// Out-of-range bytes: a granule that covers part of a segment may cover up
// to 15 bytes outside the operand; it holds at least one byte of the
// operand, so it lies in the same page, and the digit rows under the bytes
// outside are zero (direct and window) or the bytes are masked (staged).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;      // BM = 128: 8 warps of 16 rows
constexpr long long kMaxSmem = 232448;   // 227 KB per block on H100
constexpr long long kTwoBlocks = 113 * 1024;    // two blocks per SM
constexpr long long kThreeBlocks = 75 * 1024;   // three blocks per SM

__host__ __device__ inline long long round_up(long long x, long long k) {
  return (x + k - 1) / k * k;
}

__host__ __device__ inline int imin(int x, int y) { return x < y ? x : y; }

// Sizes of one launch. The matmul is the conv with taps = 1, seg = rows,
// C = kt * rows.
struct Geo {
  long long M;       // output rows (B*H'*W' for the conv)
  int kt, rows, S, N;
  int nibble, groups;
  int taps;          // kh*kw; 1 for the matmul
  int seg;           // codes of one segment: cpa, or rows
  int C;             // codes of one pixel (conv) or of one row (matmul)
  int direct;        // 1: tile t's segments share one offset in a granule
                     // (granules straight into the A tile for the matmul,
                     // window mode for the conv)
  int segw;          // staged: bytes of a segment in the tile row
  int ch_a;          // staged: 16-byte granules of one staged window
  int kq;            // bytes of a tile row (largest over t), multiple of 32
  int bm, nb;        // rows per block; digit-tile buffers: 1, 2, or 0
                     // (every tile resident for the whole launch)
  int npad;          // N rounded up to the column tile
  int window_cap;    // window mode: bytes of one input-window buffer
  int H, W, Ho, Wo, kh, kw, stride, ph, pw;   // implicit conv
};

// codes of tile t in one segment: its channels below C
__host__ __device__ inline int tile_len(const Geo& g, int t) {
  return imin(g.seg, g.C - t * g.seg);
}

// offset of tile t's segments within their first granule (direct loads)
__host__ __device__ inline int tile_shift(const Geo& g, int t) {
  return g.direct ? (int)(((long long)t * g.seg) & 15) : 0;
}

// bytes of one segment in tile t's row
__host__ __device__ inline int tile_width(const Geo& g, int t) {
  if (!g.direct) return g.segw;
  const int len = tile_len(g, t);
  return len <= 0 ? 0 : (tile_shift(g, t) + len + 15) / 16 * 16;
}

__host__ __device__ inline int tile_ksteps(const Geo& g, int t) {
  return (g.taps * tile_width(g, t) + 31) / 32;
}

__host__ __device__ inline int rows_stored(const Geo& g) {
  return g.nibble ? g.rows / 2 : g.rows;
}

// Byte offsets into dynamic shared memory.
struct Layout {
  long long stage, meta, a_tile, window, addr, b_tile, pix, deq, live, total;
};

// Window mode (the implicit conv on 16-byte aligned pixels): no A tile;
// two input windows and a zero granule, a table of ldmatrix addresses per
// warp, two row tables and a tap table. Otherwise one A tile (staged) or
// two (direct), and a pixel table.
__host__ __device__ inline Layout layout(const Geo& g, int bn) {
  Layout L;
  const long long row = g.kq + 16;
  const bool window = g.window_cap > 0;
  long long o = 0;
  L.stage = o;
  if (!g.direct) o += round_up((long long)g.bm * g.taps * g.ch_a * 16, 16);
  L.meta = o;
  if (!g.direct) o += round_up((long long)g.bm * g.taps, 16);
  L.a_tile = o;
  if (!window) o += (g.direct ? 2 : 1) * g.bm * row;
  L.window = o;
  if (window) o += 2LL * g.window_cap + 16;   // + the zero granule
  L.addr = o;
  if (window) o += 4LL * (g.bm / 16) * (g.kq / 32) * 32;
  L.b_tile = o;
  o += (long long)(g.nb == 0 ? g.kt : g.nb) * g.S * bn * row;
  L.pix = o;
  o += window ? 32LL * g.bm + round_up(8LL * g.taps, 16)
              : round_up(4LL * g.bm * g.taps, 16);
  L.deq = o; o += 4LL * g.S * g.kt * bn;
  L.live = o; o += round_up((long long)g.kt * g.S, 16);
  L.total = o;
  return L;
}

// 16 bytes global -> shared; kL1: also keep them in L1 (data that other
// loads of the block or of the SM's other blocks read again)
template <bool kL1 = false>
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (kL1)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src));
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src));
}

// 16 zero bytes: a copy that reads no source byte
__device__ __forceinline__ void cp_async16_zero(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// four 8x8 matrices of 16-bit elements (here pairs of 8-bit codes) from
// shared memory; each lane gives one 16-byte row address
__device__ __forceinline__ void ldmatrix_x4(unsigned& r0, unsigned& r1,
                                            unsigned& r2, unsigned& r3,
                                            unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

template <bool kUnsignedA>
__device__ __forceinline__ void mma_k32(int (&c)[4], unsigned a0, unsigned a1,
                                        unsigned a2, unsigned a3, unsigned b0,
                                        unsigned b1) {
  if (kUnsignedA) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
}

// The pixel (conv) or row (matmul) whose codes segment slot (row mm, tap)
// of the row block at m0 holds, or -1 where it holds zeros (outside the
// image, past M). Segment (slot, tile t) starts at code pix * C + t * seg.
template <bool kImplicit>
__device__ __forceinline__ int slot_pixel(const Geo& g, long long m0, int mm,
                                          int tap) {
  const long long m = m0 + mm;
  if (m >= g.M) return -1;
  if (!kImplicit) return (int)m;
  const unsigned hw = (unsigned)g.Ho * (unsigned)g.Wo;   // M < 2^31
  const unsigned b = (unsigned)m / hw, rem = (unsigned)m - b * hw;
  const unsigned ho = rem / (unsigned)g.Wo, wo = rem - ho * (unsigned)g.Wo;
  const int dh = tap / g.kw;
  const int h = (int)ho * g.stride - g.ph + dh;
  const int w = (int)wo * g.stride - g.pw + tap - dh * g.kw;
  return h >= 0 && h < g.H && w >= 0 && w < g.W
             ? ((int)b * g.H + h) * g.W + w : -1;
}

__device__ __forceinline__ const uint8_t* granule(const uint8_t* p) {
  return reinterpret_cast<const uint8_t*>((uintptr_t)p & ~(uintptr_t)15);
}

// A thread's walk over the segment slots: slot = tid, tid + nthr, ...,
// with (row mm, tap) kept alongside, no division inside the loop.
struct SlotWalk {
  int mm, tap, dm, dt, taps;
  __device__ SlotWalk(int taps_) : taps(taps_) {
    mm = threadIdx.x / taps;
    tap = threadIdx.x - mm * taps;
    dm = blockDim.x / taps;
    dt = blockDim.x - dm * taps;
  }
  __device__ void next() {
    mm += dm;
    tap += dt;
    if (tap >= taps) {
      tap -= taps;
      ++mm;
    }
  }
};

// The pixel table of the row block at m0, once per row block: each thread
// loads and forms the same slots at every step, so it reads only the
// entries it wrote.
template <bool kImplicit>
__device__ void fill_pix(const Geo& g, const Layout& L, uint8_t* smem,
                         long long m0) {
  int* pix = reinterpret_cast<int*>(smem + L.pix);
  SlotWalk sw(g.taps);
  for (int slot = threadIdx.x; slot < g.bm * g.taps;
       slot += blockDim.x, sw.next())
    pix[slot] = slot_pixel<kImplicit>(g, m0, sw.mm, sw.tap);
}

// Window mode: the input rows the row block at m0 reads are global rows
// (b * H + h) r_lo .. r_lo + rows - 1 of the NHWC codes, one contiguous
// range; the launch sized window_cap for the largest such window.
__device__ __forceinline__ int window_first_row(const Geo& g, long long m0) {
  const unsigned hw = (unsigned)g.Ho * (unsigned)g.Wo;
  const unsigned b0 = (unsigned)m0 / hw;
  const int ho0 = (int)(((unsigned)m0 - b0 * hw) / (unsigned)g.Wo);
  const int h = ho0 * g.stride - g.ph;
  return (int)b0 * g.H + (h > 0 ? h : 0);
}

// Issue the copies of the row block's input window (its rows of W * C
// codes, C a multiple of 16) into window buffer wb.
__device__ void issue_window(const uint8_t* __restrict__ a, const Geo& g,
                             const Layout& L, uint8_t* smem, long long m0,
                             int wb) {
  const unsigned hw = (unsigned)g.Ho * (unsigned)g.Wo;
  const unsigned m1 = (unsigned)((m0 + g.bm < g.M ? m0 + g.bm : g.M) - 1);
  const unsigned b1 = m1 / hw;
  const int h = (int)((m1 - b1 * hw) / (unsigned)g.Wo) * g.stride - g.ph +
                g.kh;
  const int r_lo = window_first_row(g, m0);
  const long long r_end = (long long)b1 * g.H + (h < g.H ? h : g.H);
  const long long rowb = (long long)g.W * g.C;
  long long bytes = r_end > r_lo ? (r_end - r_lo) * rowb : 0;
  if (bytes > g.window_cap) bytes = g.window_cap;   // the launch's bound
  const uint8_t* src = a + (long long)r_lo * rowb;
  uint8_t* dst = smem + L.window + (long long)wb * g.window_cap;
  for (int i = threadIdx.x; i < (int)(bytes / 16); i += blockDim.x)
    cp_async16(dst + 16 * i, src + 16 * i);
}

// Window mode: each row's (b * H, first input row, first input column,
// row < M) for the row block at m0, into row table wb of two (every lane
// reads any entry, after a barrier); and, once, each tap's (dh, dw).
__device__ void fill_rows(const Geo& g, const Layout& L, uint8_t* smem,
                          long long m0, int wb) {
  int4* rows = reinterpret_cast<int4*>(smem + L.pix) + wb * g.bm;
  const unsigned hw = (unsigned)g.Ho * (unsigned)g.Wo;   // M < 2^31
  for (int mm = threadIdx.x; mm < g.bm; mm += blockDim.x) {
    const unsigned m = (unsigned)(m0 + mm);
    const unsigned b = m / hw, rem = m - b * hw;
    const unsigned ho = rem / (unsigned)g.Wo, wo = rem - ho * (unsigned)g.Wo;
    rows[mm] = make_int4((int)b * g.H, (int)ho * g.stride - g.ph,
                         (int)wo * g.stride - g.pw, m0 + mm < g.M);
  }
}

__device__ void fill_taps(const Geo& g, const Layout& L, uint8_t* smem) {
  int2* taps = reinterpret_cast<int2*>(smem + L.pix + 32LL * g.bm);
  for (int tap = threadIdx.x; tap < g.taps; tap += blockDim.x)
    taps[tap] = make_int2(tap / g.kw, tap % g.kw);
}

// Window mode: each lane's ldmatrix row address for every k-step of tile
// t, into the warp's address table. k-step kk covers granules 2kk, 2kk+1
// of the tile row (granule q: tap q / np, granule q % np of its segment);
// lanes 0-15 read granule 2kk of rows 0-15 of the warp, lanes 16-31
// granule 2kk+1. Outside the image, past M and in K's padding: the zero
// granule. wb: the row block's window and row table.
__device__ void window_addresses(const Geo& g, const Layout& L,
                                 uint8_t* smem, unsigned smem_base, int t,
                                 int wb, int r_lo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int4 r = reinterpret_cast<const int4*>(smem + L.pix)
      [wb * g.bm + warp * 16 + (lane & 15)];
  const int2* taps = reinterpret_cast<const int2*>(smem + L.pix +
                                                   32LL * g.bm);
  unsigned* tab = reinterpret_cast<unsigned*>(smem + L.addr) +
                  warp * (g.kq / 32) * 32;
  const int np = tile_width(g, t) / 16, ks = tile_ksteps(g, t);
  const unsigned zero = smem_base + (unsigned)(L.window + 2LL * g.window_cap);
  const long long base = L.window + (long long)wb * g.window_cap +
                         ((long long)t * g.seg & ~15LL) -
                         (long long)r_lo * g.W * g.C;
  for (int kk = 0; kk < ks; ++kk) {
    const int q = 2 * kk + (lane >> 4);
    unsigned addr = zero;
    if (r.w && q < g.taps * np) {
      const int tap = np == 1 ? q : q / np, j = q - tap * np;
      const int2 d = taps[tap];
      const int h = r.y + d.x, w = r.z + d.y;
      if (h >= 0 && h < g.H && w >= 0 && w < g.W)
        addr = smem_base +
               (unsigned)(base + ((long long)(r.x + h) * g.W + w) * g.C +
                          16 * j);
    }
    tab[kk * 32 + lane] = addr;
  }
}

// Issue tile t's code copies from global memory: straight into the A tile
// (direct), or each segment's aligned window into the staging area with
// its offset in meta. Reads the thread's pix entries. The conv's segments
// overlap (neighbouring taps read the same pixels): its copies go through
// L1.
template <bool kDirect, bool kImplicit>
__device__ void issue_codes(const uint8_t* __restrict__ a, const Geo& g,
                            const Layout& L, uint8_t* smem, int t, int buf) {
  const int* pix = reinterpret_cast<const int*>(smem + L.pix);
  const int len = tile_len(g, t);
  if (len <= 0) return;                  // tile t holds no code: zero digits
  const long long toff = (long long)t * g.seg;
  SlotWalk sw(g.taps);
  if (kDirect) {
    const int np = tile_width(g, t) / 16;   // granules per segment
    uint8_t* tile = smem + L.a_tile + (long long)buf * g.bm * (g.kq + 16);
    for (int slot = threadIdx.x; slot < g.bm * g.taps;
         slot += blockDim.x, sw.next()) {
      uint8_t* dst = tile + (long long)sw.mm * (g.kq + 16) + sw.tap * np * 16;
      const int p = pix[slot];
      if (p >= 0) {
        const uint8_t* src = granule(a + (long long)p * g.C + toff);
        for (int j = 0; j < np; ++j) cp_async16(dst + 16 * j, src + 16 * j);
      } else {
        for (int j = 0; j < np; ++j) cp_async16_zero(dst + 16 * j, a);
      }
    }
  } else {
    int8_t* meta = reinterpret_cast<int8_t*>(smem + L.meta);
    for (int slot = threadIdx.x; slot < g.bm * g.taps; slot += blockDim.x) {
      const int p = pix[slot];
      const uint8_t* src = a + (long long)p * g.C + toff;
      const int off = p >= 0 ? (int)((uintptr_t)src & 15) : -1;
      meta[slot] = (int8_t)off;
      if (p < 0) continue;
      uint8_t* dst = smem + L.stage + (long long)slot * g.ch_a * 16;
      for (int j = 0; j < (off + len + 15) >> 4; ++j)
        cp_async16<kImplicit>(dst + 16 * j, granule(src) + 16 * j);
    }
  }
}

// Staged windows -> A tile: 16 bytes of a segment per step, shifted by
// the window's offset, codes past the tile's channels masked to zero.
__device__ void form_codes(const Geo& g, const Layout& L, uint8_t* smem,
                           int t) {
  const int8_t* meta = reinterpret_cast<const int8_t*>(smem + L.meta);
  const int pp = g.segw / 16, len = tile_len(g, t);
  SlotWalk sw(g.taps);
  for (int slot = threadIdx.x; slot < g.bm * g.taps;
       slot += blockDim.x, sw.next()) {
    const int off = meta[slot];
    uint8_t* dst = smem + L.a_tile + (long long)sw.mm * (g.kq + 16) +
                   sw.tap * g.segw;
    const unsigned* w = reinterpret_cast<const unsigned*>(
        smem + L.stage + (long long)slot * g.ch_a * 16) + (off >> 2);
    const int sh = (off & 3) * 8;
    for (int p = 0; p < pp; ++p) {
      unsigned x[4] = {0, 0, 0, 0};
      if (off >= 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int rem = len - 16 * p - 4 * k;   // codes left in this word
          if (rem > 0) {
            x[k] = __funnelshift_r(w[4 * p + k], w[4 * p + k + 1], sh);
            if (rem < 4) x[k] &= (1u << (8 * rem)) - 1u;
          }
        }
      }
      *reinterpret_cast<uint4*>(dst + 16 * p) =
          make_uint4(x[0], x[1], x[2], x[3]);
    }
  }
}

// Issue the copies of tile t's live digit tiles (BN columns from n0) into
// digit buffer `buf`.
template <int BN>
__device__ void issue_digits(const uint8_t* __restrict__ bp, const Geo& g,
                             const Layout& L, uint8_t* smem, int t, int buf,
                             int n0) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const uint8_t* live = smem + L.live;
  const int cps = tile_ksteps(g, t) * 2;     // granules per digit-tile row
  if (cps == 0) return;
  const int nn0 = tid / cps, j0 = tid - nn0 * cps;
  const int dn = nthr / cps, dj = nthr - dn * cps;
  for (int s = 0; s < g.S; ++s) {
    if (!live[t * g.S + s]) continue;
    const uint8_t* src = bp + (((long long)s * g.kt + t) * g.npad + n0) * g.kq;
    uint8_t* dst = smem + L.b_tile +
                   ((long long)buf * g.S + s) * BN * (g.kq + 16);
    int nn = nn0, j = j0;
    for (int idx = tid; idx < BN * cps; idx += nthr) {
      cp_async16<true>(dst + (long long)nn * (g.kq + 16) + 16 * j,
                       src + (long long)nn * g.kq + 16 * j);
      nn += dn;
      j += dj;
      if (j >= cps) {
        j -= cps;
        ++nn;
      }
    }
  }
}

// The digit operand: bp[s, t, n, k] for k in the tile row of tile t (tap
// tap = k / width, byte k % width, code c = byte - shift), the logical
// digit d[s, t, tap * seg + c, n], zero where no code of the tile sits.
__global__ void relayout_digits_kernel(const uint8_t* __restrict__ digits,
                                       uint8_t* __restrict__ bp, Geo g) {
  const long long words = (long long)g.S * g.kt * g.npad * (g.kq / 4);
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= words) return;
  const int n = (int)(idx % g.npad);          // n fastest: coalesced reads
  const long long rest = idx / g.npad;
  const int w = (int)(rest % (g.kq / 4));
  const long long st = rest / (g.kq / 4);     // s * kt + t
  const int t = (int)(st % g.kt);
  const int width = tile_width(g, t), shift = tile_shift(g, t);
  const int len = tile_len(g, t), rst = rows_stored(g);
  const int gh = g.nibble ? rst / g.groups : 1;
  unsigned word = 0;
  if (n < g.N && width > 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * w + i, tap = k / width, c = k % width - shift;
      if (tap >= g.taps || c < 0 || c >= len) continue;
      const int r = tap * g.seg + c;
      int v;
      if (g.nibble) {
        const int grp = r / (2 * gh), q = r % (2 * gh), hi = q >= gh;
        const int b = digits[(st * rst + grp * gh + q - hi * gh) * g.N + n];
        v = (((b >> (4 * hi)) & 0xF) ^ 8) - 8;
      } else {
        v = digits[(st * rst + r) * g.N + n];
      }
      word |= (unsigned)(v & 0xFF) << (8 * i);
    }
  }
  // rows of kq bytes: (s, t, n) -> kq / 4 words
  reinterpret_cast<unsigned*>(bp)[(st * g.npad + n) * (g.kq / 4) + w] = word;
}

// A persistent block: BN columns from n0, and the row blocks of BM rows
// (16 per warp) blockIdx.x, blockIdx.x + gridDim.x, ... in turn. Its steps
// (row block, tile t) run as one pipeline: step k+1's copies are issued
// before step k's MACs; a row block's output is written after its last t.
template <int BN, bool kUnsignedA, bool kImplicit, bool kDirect>
__global__ void __launch_bounds__(kMaxThreads) cim_adc_free_mma_kernel(
    const uint8_t* __restrict__ a,       // (M, kt, rows) codes, or NHWC
    const uint8_t* __restrict__ bp,      // relaid digits (S, kt, npad, kq)
    const uint8_t* __restrict__ occ,     // (S, kt, N) or nullptr
    const float* __restrict__ deq,       // (S, kt, N)
    float* __restrict__ out,             // (M, N)
    Geo g) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout L = layout(g, BN);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;   // fragment row group, quad
  const int n0 = blockIdx.y * BN;
  const int ncols = imin(BN, g.N - n0);
  const long long nblk = (g.M + g.bm - 1) / g.bm;
  if (blockIdx.x >= nblk) return;
  const long long steps = (nblk - 1 - blockIdx.x) / gridDim.x + 1;
  const long long nsteps = steps * g.kt;

  // the block's dequant scales and live (t, s) planes (any occupied column)
  float* dq = reinterpret_cast<float*>(smem + L.deq);
  for (int i = tid; i < g.S * g.kt * BN; i += nthr) {
    const int pl = i / BN, nn = i - pl * BN;   // pl = s * kt + t
    dq[i] = nn < ncols ? deq[(long long)pl * g.N + n0 + nn] : 0.f;
  }
  uint8_t* live = smem + L.live;
  for (int i = tid; i < g.kt * g.S; i += nthr) live[i] = occ == nullptr;
  __syncthreads();
  if (occ != nullptr) {
    for (int i = tid; i < g.kt * g.S * BN; i += nthr) {
      const int pl = i / BN, nn = i - pl * BN;   // pl = t * S + s
      const int t = pl / g.S, s = pl - t * g.S;
      if (nn < ncols && occ[((long long)s * g.kt + t) * g.N + n0 + nn])
        live[pl] = 1;
    }
  }
  __syncthreads();

  float acc[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const unsigned smem_base = (unsigned)__cvta_generic_to_shared(smem);
  const long long mstride = (long long)gridDim.x * g.bm;
  long long m0 = (long long)blockIdx.x * g.bm;
  int t = 0;
  // window mode: the implicit conv on 16-byte aligned pixels copies each
  // row block's input window once (window and row table wbuf of two) and
  // reads the A fragments from it with per-lane ldmatrix addresses
  constexpr bool kWindow = kImplicit && kDirect;
  // splits per A fragment (measured on H100: 3 at 32 columns and on the
  // staged paths at 16, 1 in window mode at 16 and at 64)
  constexpr int kSG = BN == 64 || (BN == 16 && kWindow) ? 1 : 3;
  int wbuf = 0, r_lo = 0;
  const unsigned* atab = reinterpret_cast<const unsigned*>(smem + L.addr) +
                         warp * (g.kq / 32) * 32 + lane;
  if (kWindow) {
    unsigned* zero = reinterpret_cast<unsigned*>(smem + L.window +
                                                 2LL * g.window_cap);
    if (tid < 4) zero[tid] = 0;
    fill_taps(g, L, smem);
    fill_rows(g, L, smem, m0, 0);
    r_lo = window_first_row(g, m0);
    issue_window(a, g, L, smem, m0, 0);
  } else {
    fill_pix<kImplicit>(g, L, smem, m0);
    issue_codes<kDirect, kImplicit>(a, g, L, smem, 0, 0);
  }
  if (g.nb == 0) {      // every digit tile, once
    for (int tt = 0; tt < g.kt; ++tt)
      issue_digits<BN>(bp, g, L, smem, tt, tt, n0);
  } else {
    issue_digits<BN>(bp, g, L, smem, 0, 0, n0);
  }
  cp_async_commit();
  for (long long k = 0; k < nsteps; ++k) {
    const int buf = (int)(k & 1);
    cp_async_wait_all();
    __syncthreads();      // step k arrived; step k-1's MACs are done
    if (!kDirect) {
      form_codes(g, L, smem, t);
      __syncthreads();    // step k formed; the staging area is free
    }
    if (kWindow) {
      window_addresses(g, L, smem, smem_base, t, wbuf, r_lo);
      __syncwarp();
    }
    if (k + 1 < nsteps) {   // step k+1: the next tile, or the next row block
      const bool next_blk = t + 1 == g.kt;
      const int t1 = next_blk ? 0 : t + 1;
      if (kWindow) {
        if (next_blk) {
          fill_rows(g, L, smem, m0 + mstride, wbuf ^ 1);
          issue_window(a, g, L, smem, m0 + mstride, wbuf ^ 1);
        }
      } else {
        if (next_blk) fill_pix<kImplicit>(g, L, smem, m0 + mstride);
        issue_codes<kDirect, kImplicit>(a, g, L, smem, t1, buf ^ 1);
      }
      if (g.nb == 2) issue_digits<BN>(bp, g, L, smem, t1, buf ^ 1, n0);
      cp_async_commit();
    }
    // ldmatrix row addresses: A's four 8x16-byte matrices are a0..a3 of
    // the warp's 16 rows; B's are b0, b1 of two 8-column tiles
    const unsigned a_addr =
        smem_base + (unsigned)(L.a_tile + (kDirect ? (long long)buf * g.bm *
                                                         (g.kq + 16) : 0LL)) +
        (unsigned)((warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                   (g.kq + 16) + (lane >> 4) * 16);
    const int bbuf = g.nb == 0 ? t : g.nb == 2 ? buf : 0;
    const int ksteps = tile_ksteps(g, t);
    const unsigned b_lane =
        smem_base + (unsigned)L.b_tile +
        (unsigned)(((lane & 7) + (lane >> 4) * 8) * (g.kq + 16) +
                   ((lane >> 3) & 1) * 16);
    // the splits in groups of kSG: one A fragment per k-step serves the
    // group, whose MMA chains are independent
    for (int s0 = 0; s0 < g.S; s0 += kSG) {
      int p[kSG][BN / 8][4];
      bool lv[kSG];
      bool any = false;
#pragma unroll
      for (int i = 0; i < kSG; ++i) {
        lv[i] = s0 + i < g.S && live[t * g.S + s0 + i];
        any = any || lv[i];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[i][j][e] = 0;
      }
      if (any) {
        for (int kk = 0; kk < ksteps; ++kk) {
          unsigned a0, a1, a2, a3;
          ldmatrix_x4(a0, a1, a2, a3,
                      kWindow ? atab[kk * 32] : a_addr + 32 * kk);
#pragma unroll
          for (int i = 0; i < kSG; ++i) {
            if (!lv[i]) continue;
            const unsigned b_addr =
                b_lane + (unsigned)(((bbuf * g.S + s0 + i) * BN) *
                                        (g.kq + 16) + 32 * kk);
#pragma unroll
            for (int j = 0; j < BN / 8; j += 2) {
              unsigned b0, b1, b2, b3;
              ldmatrix_x4(b0, b1, b2, b3, b_addr + j * 8 * (g.kq + 16));
              mma_k32<kUnsignedA>(p[i][j], a0, a1, a2, a3, b0, b1);
              mma_k32<kUnsignedA>(p[i][j + 1], a0, a1, a2, a3, b2, b3);
            }
          }
        }
      }
      // epilogue on the fragments: rint, dequant, shift-and-add in the
      // order t, then s
#pragma unroll
      for (int i = 0; i < kSG; ++i) {
        if (s0 + i >= g.S) break;
        const float* dqs = dq + ((s0 + i) * g.kt + t) * BN;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float2 d =
              *reinterpret_cast<const float2*>(dqs + j * 8 + 2 * tq);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[j][e] = __fadd_rn(
                acc[j][e],
                __fmul_rn(rintf((float)p[i][j][e]), e & 1 ? d.y : d.x));
        }
      }
    }
    if (g.nb == 1 && k + 1 < nsteps) {
      __syncthreads();    // the one digit buffer is free again
      issue_digits<BN>(bp, g, L, smem, t + 1 == g.kt ? 0 : t + 1, 0, n0);
      cp_async_commit();
    }
    if (++t < g.kt) continue;
    // the row block is done: c0, c1 are row gr, columns 2tq, 2tq+1; c2, c3
    // row gr + 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + warp * 16 + gr + 8 * h;
      if (m >= g.M) continue;
      float* orow = out + m * g.N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + j * 8 + 2 * tq;
        if (n + 1 < g.N && (g.N & 1) == 0) {
          *reinterpret_cast<float2*>(orow + n) =
              make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
        } else {
          if (n < g.N) orow[n] = acc[j][2 * h];
          if (n + 1 < g.N) orow[n + 1] = acc[j][2 * h + 1];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    t = 0;
    m0 += mstride;
    if (kWindow) {
      wbuf ^= 1;
      r_lo = window_first_row(g, m0);
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms <= 0)
      sms = 132;
  }
  return sms;
}

// The column tile: all of N up to 64, so a block reads each code once;
// but 32 where 64-column blocks would put fewer than two blocks of 128
// rows on each SM (the extra blocks keep more warps in flight).
int column_tile(int n, long long m) {
  if (n <= 16) return 16;
  if (n <= 32) return 32;
  return (m + 127) / 128 * ((n + 63) / 64) >= 2LL * sm_count() ? 64 : 32;
}

constexpr long long kWindowMax = 32 * 1024;   // one input window, at most

// Window mode: bytes of the largest input window of a row block of bm
// rows. Its outputs span at most R = (bm - 1) / W' + 2 output rows, so
// its input rows at most (R - 1) * stride + kh, plus H - H' * stride for
// each image boundary it crosses.
long long window_bytes(const Geo& g, int bm) {
  const long long R = (bm - 1) / g.Wo + 2;
  const long long gap = g.H - (long long)g.Ho * g.stride;
  long long rows = (R - 1) * g.stride + g.kh +
                   ((R - 1) / g.Ho + 1) * (gap > 0 ? gap : 0);
  const long long all = g.M / ((long long)g.Ho * g.Wo) * g.H;
  if (rows > all) rows = all;
  return rows * g.W * g.C;
}

// Bytes of the relaid digit operand, at most: the tile row holds taps
// segments of at most round16(seg) + 16 bytes.
long long workspace_bytes(int kt, int S, int n, int taps, int seg) {
  const long long kq = round_up(taps * (round_up(seg, 16) + 16), 32);
  return (long long)S * kt * round_up(n, 64) * kq;   // any column tile
}

// Everything the relaid digit operand depends on, hashed (FNV-1a): two
// launches with the same id and the same planes relay them alike.
long long layout_id(const Geo& g) {
  const long long f[] = {g.S, g.kt, g.rows, g.N, g.nibble, g.groups, g.taps,
                         g.seg, g.C, g.direct, g.npad, g.kq};
  unsigned long long h = 14695981039346656037ULL;
  for (long long v : f) {
    h ^= (unsigned long long)v;
    h *= 1099511628211ULL;
  }
  return h == 0 ? 1 : (long long)h;
}

template <int BN, bool kUnsignedA, bool kImplicit, bool kDirect>
cudaError_t launch(const uint8_t* a, const uint8_t* digits, const uint8_t* occ,
                   const float* deq, float* out, uint8_t* work,
                   long long work_bytes, long long* held, Geo g,
                   cudaStream_t stream) {
  g.npad = (int)round_up(g.N, BN);
  g.kq = 32;
  for (int t = 0; t < g.kt; ++t)
    if (tile_ksteps(g, t) * 32 > g.kq) g.kq = tile_ksteps(g, t) * 32;
  if ((long long)g.S * g.kt * g.npad * g.kq > work_bytes)
    return cudaErrorInvalidValue;
  const long long nblk_n = g.npad / BN;
  // 128-row blocks unless they would leave half the SMs idle: a block
  // reloads the digit tiles for every row block it takes, so fewer, larger
  // row blocks move fewer digit bytes. Every digit tile resident if that
  // leaves room for three blocks per SM, else two digit buffers, else one,
  // for two blocks per SM; then whatever fits.
  const int bm0 = ((g.M + 127) / 128) * nblk_n * 2 >= sm_count() ? 128 : 64;
  const long long cand[6][3] = {
      {bm0, 0, kThreeBlocks}, {bm0, 2, kTwoBlocks}, {bm0, 1, kTwoBlocks},
      {64, 0, kThreeBlocks},  {64, 2, kTwoBlocks},  {64, 1, kTwoBlocks}};
  long long smem = -1;
  for (int pass = 0; pass < 2 && smem < 0; ++pass) {
    for (const auto& c : cand) {
      g.bm = (int)c[0];
      g.nb = (int)c[1];
      g.window_cap = kImplicit && kDirect ? (int)window_bytes(g, g.bm) : 0;
      if (layout(g, BN).total <= (pass == 0 ? c[2] : kMaxSmem)) {
        smem = layout(g, BN).total;
        break;
      }
    }
  }
  if (smem < 0) return cudaErrorInvalidValue;
  const long long nblk_m = (g.M + g.bm - 1) / g.bm;
  if (nblk_m > 0x7FFFFFFFLL || nblk_n > 65535) return cudaErrorInvalidValue;

  // relay the planes unless `work` already holds them in this layout
  cudaError_t e;
  const long long id = layout_id(g);
  if (*held != id) {
    const long long words = (long long)g.S * g.kt * g.npad * (g.kq / 4);
    relayout_digits_kernel<<<(unsigned)((words + 255) / 256), 256, 0,
                             stream>>>(digits, work, g);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    *held = id;
  }
  auto kern = cim_adc_free_mma_kernel<BN, kUnsignedA, kImplicit, kDirect>;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  // persistent blocks: as many as fit on the card at once, at most one per
  // row block
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                    g.bm / 16 * 32,
                                                    (size_t)smem);
  if (e != cudaSuccess) return e;
  const long long resident =
      (long long)(per_sm > 0 ? per_sm : 1) * sm_count();
  const dim3 grid((unsigned)(nblk_m < resident ? nblk_m : resident),
                  (unsigned)nblk_n);
  kern<<<grid, g.bm / 16 * 32, (size_t)smem, stream>>>(a, work, occ, deq, out,
                                                       g);
  return cudaGetLastError();
}

template <bool kImplicit>
int dispatch(const void* a, const void* digits, const void* occ,
             const void* deq, void* out, void* work, long long work_bytes,
             long long* held, Geo g, int a_unsigned, void* stream) {
  if (g.M <= 0 || g.M > 0x7FFFFFFFLL || g.kt <= 0 || g.rows <= 0 ||
      g.S <= 0 || g.N <= 0 || g.groups <= 0 || g.seg <= 0 || g.taps <= 0 ||
      (g.nibble && ((g.rows % 2) || ((g.rows / 2) % g.groups))))
    return (int)cudaErrorInvalidValue;
  // direct loads: every segment of a tile at one offset in its granule;
  // for the conv, window mode, when a 128-row block's window fits
  g.direct = ((uintptr_t)a % 16 == 0) &&
             (kImplicit ? g.C % 16 == 0 && window_bytes(g, 128) <= kWindowMax
                        : g.rows % 16 == 0);
  g.segw = (int)round_up(g.seg, 16);
  g.ch_a = g.segw / 16 + 1;
  const auto* A = static_cast<const uint8_t*>(a);
  const auto* D = static_cast<const uint8_t*>(digits);
  const auto* O = static_cast<const uint8_t*>(occ);
  const auto* Q = static_cast<const float*>(deq);
  auto* Y = static_cast<float*>(out);
  auto* Wk = static_cast<uint8_t*>(work);
  auto* st = static_cast<cudaStream_t>(stream);
#define CIM_LAUNCH(BN, U)                                                   \
  (g.direct ? launch<BN, U, kImplicit, true>(A, D, O, Q, Y, Wk, work_bytes, \
                                             held, g, st)                   \
            : launch<BN, U, kImplicit, false>(A, D, O, Q, Y, Wk,            \
                                              work_bytes, held, g, st))
  const int bn = column_tile(g.N, g.M);
  cudaError_t e;
  if (bn == 16)
    e = a_unsigned ? CIM_LAUNCH(16, true) : CIM_LAUNCH(16, false);
  else if (bn == 32)
    e = a_unsigned ? CIM_LAUNCH(32, true) : CIM_LAUNCH(32, false);
  else
    e = a_unsigned ? CIM_LAUNCH(64, true) : CIM_LAUNCH(64, false);
#undef CIM_LAUNCH
  return (int)e;
}

}  // namespace

extern "C" {

// Each launch returns a cudaError_t code: 0 on a successful launch. `occ`
// may be null. `rows` is the logical row count; nibble planes (nibble = 1)
// store rows / 2 rows in `groups` half-split blocks. `work` is a device
// buffer of `work_bytes` >= cim_adc_free_mma_workspace(...) bytes for the
// relaid digit operand, and `*held` the id of the layout it holds (0:
// none). A launch relays the planes into `work` (a small kernel, first on
// the stream) only if its layout id differs from `*held`, then stores
// its id there: a caller that keeps `work` and `*held` beside constant
// planes relays them once. Both kernels run on `stream`.

// Workspace bytes for kt tiles, S splits, n columns, taps segments of seg
// codes (the matmul: taps 1, seg rows; the conv: kh*kw, cpa).
long long cim_adc_free_mma_workspace(int kt, int S, int n, int taps,
                                     int seg) {
  if (kt <= 0 || S <= 0 || n <= 0 || taps <= 0 || seg <= 0) return 0;
  return workspace_bytes(kt, S, n, taps, seg);
}

// K4: codes (m, kt, rows) int8 (a_unsigned = 0) or uint8; out (m, n).
int cim_matmul_adc_free_mma_launch(const void* a, const void* digits,
                                   const void* occ, const void* deq, void* out,
                                   void* work, long long work_bytes,
                                   long long* held, long long m, int kt,
                                   int rows, int S, int n, int groups,
                                   int a_unsigned, int nibble, void* stream) {
  Geo g{};
  g.M = m; g.kt = kt; g.rows = rows; g.S = S; g.N = n;
  g.nibble = nibble; g.groups = groups;
  g.taps = 1; g.seg = rows; g.C = kt * rows; g.kh = 1; g.kw = 1;
  g.stride = 1;
  return dispatch<false>(a, digits, occ, deq, out, work, work_bytes, held,
                         g, a_unsigned, stream);
}

// K5: codes (batch, h, w, c) NHWC; planes (S, kt, kh*kw*cpa or half, n)
// with nibble groups kh*kw; out (batch, ho, wo, n). The pads before
// (ph, pw) and ho, wo come from the caller (XLA's SAME/VALID rule).
int cim_conv_adc_free_implicit_launch(const void* a, const void* digits,
                                      const void* occ, const void* deq,
                                      void* out, void* work,
                                      long long work_bytes, long long* held,
                                      int batch, int h, int w, int c, int kh,
                                      int kw, int stride, int ph, int pw,
                                      int ho, int wo, int cpa, int kt, int S,
                                      int n, int a_unsigned, int nibble,
                                      void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0 || kh <= 0 || kw <= 0 ||
      stride <= 0 || ho <= 0 || wo <= 0 || cpa <= 0 ||
      (long long)batch * h * w > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  Geo g{};
  g.M = (long long)batch * ho * wo; g.kt = kt; g.rows = kh * kw * cpa;
  g.S = S; g.N = n; g.nibble = nibble; g.groups = kh * kw;
  g.taps = kh * kw; g.seg = cpa; g.C = c;
  g.H = h; g.W = w; g.Ho = ho; g.Wo = wo; g.kh = kh; g.kw = kw;
  g.stride = stride; g.ph = ph; g.pw = pw;
  return dispatch<true>(a, digits, occ, deq, out, work, work_bytes, held,
                        g, a_unsigned, stream);
}

const char* cim_adc_free_mma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
