// Every dense decoder's whole trunk in one launch.
//
// Replaces the TPU kernel `emsanet_tpu/ops/decoder_trunk.py::decoder_trunk`
// (`_trunk_kernel`, pl.pallas_call at decoder_trunk.py:638). For D decoders
// and N images, per decoder module (input h x w, C_in channels; C
// channels; a C_s-channel encoder skip at 2h x 2w):
//   x = round(relu(conv3x3(x) * s_in + t_in))
//   K NonBottleneck1D blocks, each half
//     z = round(relu(conv3x1(src) + b31))
//     z = (conv1x3(z) + b13) * bn_s + bn_t
//     first half: y = round(relu(z)); second: x = round(relu(z + x))
//   x2 upsample (nearest + zero-padded depthwise 3x3) in polyphase form:
//     parity (pr, pc) of pixel (i, j) = round(sum over its 4 taps
//     x[i + pr - 1 + a, j + pc - 1 + b] * coef), in f32, in tap order
//   skip fusion: out = round(up + round(skip @ Wp * s_p + t_p))
// Every conv pads with zeros of its own; `round` is the storage type, at
// the points where the TPU kernel rounds. The last module's output, (D, N,
// 8 h0, 8 w0, C_last) NHWC, is each decoder's head input.
//
// What bounds it on the H100: at the flagship (640x480: 15x20x512 context,
// modules of 512, 256, 128 channels, K = 3) a decoder does 25 GFLOP per
// image against ~33 MB of bf16 weights and ~15 MB of activations, so it
// is bound by arithmetic (0.051 ms at b1, D = 2, at 989 TFLOP/s). What the
// TPU kernel was built for, and this one keeps, is one launch instead of
// ~50 per decoder: the b1 frame is bound by the host's launches.
//
// Design. The TPU kernel runs one grid step per (decoder, image) with the
// whole image resident in 16 MB of VMEM; here that would use 2 of 132 SMs
// and more shared memory than an SM has. Instead a persistent kernel,
// launched cooperatively with as many blocks as fit on the card at once,
// walks the trunk's phases in order, with a grid-wide barrier after each:
// per module conv_in, then the 4K convs of the blocks (the 1x3 conv needs
// the 3x1 conv's output of neighbouring tiles, so each conv is a phase),
// then one phase of projection + upsample + add: 3 (2 + 4K) = 42 phases
// at the flagship. In a phase every block loops over work units. A work
// item is an implicit-GEMM conv tile (decoder, 64 pixels, 64 output
// channels); the projection is a 1x1 conv whose epilogue computes the
// parity value of its pixel and channel from the module's map.
// Intermediates live in scratch maps in device memory (mostly
// L2-resident); a block reads them only through L2 (cp.async.cg,
// ld.global.cg), so no stale L1 line survives a barrier.
//
// bf16 (the inference path), redesigned for the H100. The first design
// (mma.sync, 32-wide K chunks through a 3-stage cp.async ring, one block
// per item's whole K loop, an epilogue per pair of channels) took 1.33 ms
// at b1, 0.91 ms of it fixed cost: at b1 the module-1 phases gave 80
// items to 396 blocks, and each block waited on one round trip at a time.
// Its phase stamps showed the barriers cheap (~1 us each) and the fixed
// cost inside each phase: first loads, epilogue loads serialised behind
// stores, integer divisions issued by every warp. Now:
//  - Warpgroup MMA: one warpgroup per block issues wgmma m64n64k16 on
//    128-byte-swizzled tiles of 64-wide K steps (csrc/conv_wgmma.cuh). A
//    is K-major (64 pixels x 64 channels of one tap): its 16-byte chunks
//    are copied with cp.async.cg straight into the swizzled layout (chunk q
//    of row r at q ^ (r % 8)), missing source pixels and channels past
//    C_in zero-filled by the copy, then fence.proxy.async makes them
//    visible to the tensor cores. B is the weights as stored, (taps x
//    C_in) rows x C_out: a TMA box of 64 rows x 64 channels lands
//    MN-major with the same swizzle, and the wgmma reads it transposed.
//    The weights' tensor maps are built on the host per call.
//  - A kStages-deep ring (16 KB a stage): the loads of the next
//    kStages - 1 steps are in flight while a step's MMAs run, three blocks
//    per SM (48 KB in flight a block; the first design had 8-16 KB). The
//    step's address arithmetic advances without divisions; a phase's
//    divisors are multiply-shift constants computed once per launch.
//  - Split K where a phase has fewer items than the grid has blocks: the
//    wrapper's plan (ops/decoder_trunk.py::trunk_plan) gives each
//    phase a split so that items x split fills the grid in one wave; a
//    split takes a contiguous range of whole K steps. Each split writes its
//    f32 partial tile to a workspace, then takes an integer ticket of its
//    item (one acq_rel atomic after the block's barrier, no float
//    atomics); the block that draws the last ticket adds the partials in
//    split order (through the idle ring, four at a time), runs the
//    epilogue and resets the ticket, so the tickets are zero again when
//    the launch ends and repeated calls give the same bits.
//  - Epilogue: the accumulators go to an f32 tile in shared memory; each
//    thread then takes 8 channels of a pixel (16-byte loads and stores),
//    with every residual or upsample load of a pair of vectors issued
//    before its stores. The per-channel constants are copied to shared
//    memory while the unit's first loads fly.
//  - Before each grid barrier, thread 0 writes the next phase's
//    description to shared memory and issues the B tiles of its block's
//    first unit of that phase into the ring: the weights do not depend on
//    the barrier.
// f32 (the path that checks the arithmetic): the CUDA cores, f32 FMA, one
// block per item's whole K loop, as in the first design, with the same
// epilogue.
//
// Phase stamps: given a buffer (null on the main path), block 0 writes
// %globaltimer after each grid barrier (the phase's start) and every block
// raises the phase's "work end" to the time it finished its units, so the
// time of each phase splits into work and wait at the barrier; block 0
// also stamps the steps of its first unit of each bf16 phase.
//
// Layouts: activations NHWC contiguous; per decoder d the weights are
// cin_w (3*3, C_in, C) and proj_w (C_s, C) in the storage type; w31 / w13
// (K, 2, 3, C, C); b31, b13, bn_s, bn_t (K, 2, C), s_in, t_in, s_p, t_p
// (C) and the parity taps (4 parities, 4 taps, C) in f32.

#include <cooperative_groups.h>

#include <cstdint>
#include <type_traits>

#include "conv_tc.cuh"
#include "conv_wgmma.cuh"

namespace cg = cooperative_groups;

namespace emsanet {
namespace trunk {

using wg::bf16;

constexpr int kBM = 64;           // pixels per work item
constexpr int kBN = 64;           // output channels per work item
constexpr int kThreads = 128;     // one warpgroup
constexpr int kMaxModules = 4;
constexpr int kTile = kBM * kBN;  // floats of one split's partial tile

// bf16 path: K steps of 64 channels of one tap through a ring of stages
constexpr int kBK = 64;
constexpr int kStages = 4;
constexpr int kABytes = kBM * kBK * 2;
constexpr int kBBytes = kBK * kBN * 2;
constexpr size_t kWgSmem = 1024 + kStages * (kABytes + kBBytes) +
                           kStages * sizeof(uint64_t);
constexpr int kBlocksPerSm = 3;   // bf16: the ring takes ~65 KB a block

// f32 path: 32-wide K chunks, A tile [k][pixel] with padded rows
constexpr int kFK = 32;
constexpr int kFStride = kBM + 4;
struct F32TileSmem {
  float a[kFK * kFStride];
  float b[kFK * kBN];
};

struct TrunkModule {
  int h, w, cin, c, cs;  // input size, channels in / out, skip channels
  int split_in, split_blk, split_proj;  // bf16: K splits of the phases
  const void* cin_w;
  const float* cin_s;
  const float* cin_t;
  const void* w31;
  const void* w13;
  const float* b31;
  const float* b13;
  const float* bn_s;
  const float* bn_t;
  const float* ups;
  const void* skip;  // (N, 2h, 2w, cs), shared by the decoders
  const void* proj_w;
  const float* proj_s;
  const float* proj_t;
  void* out;  // (D, N, 2h, 2w, c)
};

// Weight tensor maps of a module (bf16): conv_in, 3x1, 1x3, projection.
enum { kMapIn = 0, kMap31, kMap13, kMapProj, kMaps };

struct TrunkArgs {
  CUtensorMap wmap[kMaxModules][kMaps];  // (rows, C) per weight array
  int d, n, k, n_modules;
  const void* ctx;  // (N, h0, w0, C_in of module 0), shared
  void* bx;         // scratch maps, D * N * h * w * c each
  void* by;
  void* bz;
  float* ws;            // split partials (bf16 with a split > 1)
  int* tickets;         // one per item of a split phase, zero between calls
  unsigned long long* stamps;  // null, or kStampRow per phase + 1
  TrunkModule m[kMaxModules];
};

// n / d by a multiply (the high half of n ceil(2^64 / d)), exact for n
// and d below 2^32: the index arithmetic of a phase's units and pixels,
// whose divisors the phase prepares once.
struct FastDiv {
  unsigned long long m;
  int d;
  __device__ __forceinline__ void set(int dd) {
    d = dd;
    m = ~0ull / (unsigned long long)dd + 1;  // 0 for d = 1
  }
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : (int)__umul64hi((unsigned long long)n, m);
  }
  __device__ __forceinline__ int mod(int n) const { return n - div(n) * d; }
};

// One conv phase: a th x tw conv of every decoder's map, `total` pixels
// of images h x w each. Decoder d reads x + d * x_ds. f32: weights wt + d
// * wt_ds; bf16: rows d * w_rows_d + w_row0 + tap * cin + k of wmap.
// `prepare` fills in the derived counts and divisors.
struct ConvSpec {
  const void* x;
  size_t x_ds;
  int total, h, w, cin, th, tw, cout;
  const void* wt;
  size_t wt_ds;
  const CUtensorMap* wmap;
  int w_rows_d, w_row0, split;
  // derived: output-channel tiles, items per decoder, K steps (of kBK
  // channels of one tap), channel chunks per tap, units of n_dec decoders
  int n_tiles, per_dec, steps, kch, units;
  FastDiv f_split, f_per_dec, f_n_tiles, f_hw, f_w, f_kch, f_tw;
};

// The output tile of an item in shared memory, f32 [pixel][channel], for
// the epilogue (rows padded by 16 bytes).
constexpr int kOutStride = kBN + 4;
constexpr int kOutBytes = kBM * kOutStride * 4;

// Eight neighbouring channels of a map, as loaded (bf16: one 16-byte
// vector; f32: two).
template <typename T>
struct Raw8;
template <>
struct Raw8<bf16> {
  uint4 u;
};
template <>
struct Raw8<float> {
  uint4 a, b;
};

// 16 bytes through L2 only (the maps are written by other blocks of the
// same launch before the last barrier). Volatile, and ordered with every
// memory access: an epilogue issues all its loads before its first store,
// and the compiler may not sink them to their uses.
__device__ __forceinline__ uint4 ld_cg16(const void* p) {
  uint4 r;
  asm volatile("ld.global.cg.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p)
               : "memory");
  return r;
}

__device__ __forceinline__ Raw8<bf16> ld_cg8(const bf16* p) {
  return {ld_cg16(p)};
}
__device__ __forceinline__ Raw8<float> ld_cg8(const float* p) {
  return {ld_cg16(p), ld_cg16(p + 4)};
}

template <typename T>
__device__ __forceinline__ Raw8<T> zero8() {
  return Raw8<T>{};
}

__device__ __forceinline__ void unpack8(const Raw8<bf16>& r,
                                        float (&f)[8]) {
  const unsigned w[4] = {r.u.x, r.u.y, r.u.z, r.u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack8(const Raw8<float>& r,
                                        float (&f)[8]) {
  const unsigned w[8] = {r.a.x, r.a.y, r.a.z, r.a.w,
                         r.b.x, r.b.y, r.b.z, r.b.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __uint_as_float(w[i]);
}

// Eight channels rounded to the storage type, one store (two in f32).
__device__ __forceinline__ void st8(bf16* p, const float (&f)[8]) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&v);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void st8(float* p, const float (&f)[8]) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = make_float4(f[0], f[1], f[2], f[3]);
  q[1] = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// ---- f32 path -----------------------------------------------------------

// Thread t computes pixels 8 (t / 16) .. +7 and channels 4 (t % 16) .. +3
// of an item, summing in f32 over taps, then channels, and leaves them in
// the output tile `out` (which may overlay sm).
__device__ __forceinline__ void conv_tile_f32(F32TileSmem& sm, float* out,
                                              const float* x, int total,
                                              int h, int w, int cin, int th,
                                              int tw, const float* wt,
                                              int cout, int m0, int n0) {
  const int tid = threadIdx.x, tm = tid / 16, tn = tid % 16;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int tap = 0; tap < th * tw; ++tap) {
    const int dy = tap / tw - th / 2, dx = tap % tw - tw / 2;
    for (int k0 = 0; k0 < cin; k0 += kFK) {
      __syncthreads();
      for (int i = tid; i < kBM * kFK; i += kThreads) {
        const int m = i / kFK, kk = i % kFK, p = m0 + m;
        const int rem = p % (h * w), y = rem / w + dy, xx = rem % w + dx;
        float v = 0.f;
        if (p < total && y >= 0 && y < h && xx >= 0 && xx < w &&
            k0 + kk < cin)
          v = __ldcg(x + (size_t)(p + dy * w + dx) * cin + k0 + kk);
        sm.a[kk * kFStride + m] = v;
      }
      for (int i = tid; i < kFK * kBN; i += kThreads) {
        const int kr = i / kBN, nn = i % kBN;
        sm.b[i] = k0 + kr < cin
                      ? wt[((size_t)tap * cin + k0 + kr) * cout + n0 + nn]
                      : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kFK; ++kk) {
        float a[8], b[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = sm.a[kk * kFStride + tm * 8 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = sm.b[kk * kBN + tn * 4 + j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }
  __syncthreads();  // every thread has read sm
#pragma unroll
  for (int i = 0; i < 8; ++i)
    *reinterpret_cast<float4*>(out + (tm * 8 + i) * kOutStride + tn * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// ---- bf16 path ----------------------------------------------------------

struct Ring {
  uint8_t* a;      // kStages A tiles (K-major, swizzled)
  uint8_t* b;      // kStages B tiles (MN-major, swizzled)
  uint64_t* full;  // per stage: the B tile's TMA has landed
  uint32_t step;   // K steps this block has run so far (stage = step %
                   // kStages, mbarrier parity = step / kStages % 2)
  int b_ahead;     // thread 0: B tiles of the block's next unit already
                   // issued (`preload_weights`)
};

// Waits for a stage's TMA; a load that never lands (a fault in the tensor
// map) ends the launch with a trap after a second instead of hanging every
// block of the cooperative grid.
__device__ __forceinline__ void wait_full(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = wg::smem_u32(bar);
  unsigned long long t0 = 0;
  for (uint32_t spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spins % 1024 == 0) {
      const unsigned long long now = global_ns();
      if (t0 == 0) t0 = now;
      if (now - t0 > 1000000000ull) asm volatile("trap;");
    }
  }
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (wg::smem_u32(p) & 1023)) & 1023);
}

// Staged per-channel constants of a unit's 64 output channels: conv_in's
// scale and shift, the blocks' biases and folded BatchNorm, the
// projection's scale and shift and the upsample's 16 taps.
constexpr int kVecRows = 18;

// Stamps of a phase (see the notes at the top): 0 its start, 1 the last
// block's end of work, 2-7 block 0's first unit (loads issued, first stage
// landed, K loop done, ticket drawn, partials added, epilogue done).
constexpr int kStampRow = 8;

// Where a unit sits in its phase: item (decoder d, pixels m0.., channels
// n0..), and split sp's K steps [lo, lo + n_it).
struct UnitGeom {
  int item, sp, d, m0, n0, lo, n_it;
};

// A phase's derived counts; with `fd` (kFastDivs, in the order of
// ConvSpec's FastDiv fields) also its divisors.
constexpr int kFastDivs = 7;

__device__ __forceinline__ ConvSpec prepare(ConvSpec cs, int n_dec,
                                            const FastDiv* fd = nullptr) {
  cs.n_tiles = cs.cout / kBN;
  cs.per_dec = ceil_div(cs.total, kBM) * cs.n_tiles;
  cs.kch = ceil_div(cs.cin, kBK);
  cs.steps = cs.th * cs.tw * cs.kch;
  cs.units = n_dec * cs.per_dec * cs.split;
  if (fd != nullptr) {
    cs.f_split = fd[0];
    cs.f_per_dec = fd[1];
    cs.f_n_tiles = fd[2];
    cs.f_hw = fd[3];
    cs.f_w = fd[4];
    cs.f_kch = fd[5];
    cs.f_tw = fd[6];
  }
  return cs;
}

// Divisor f of a prepared phase (the order of ConvSpec's FastDivs).
__device__ __forceinline__ int divisor(const ConvSpec& cs, int f) {
  switch (f) {
    case 0: return cs.split;
    case 1: return cs.per_dec;
    case 2: return cs.n_tiles;
    case 3: return cs.h * cs.w;
    case 4: return cs.w;
    case 5: return cs.kch;
    default: return cs.tw;
  }
}

__device__ __forceinline__ UnitGeom unit_geom(const ConvSpec& cs, int u) {
  UnitGeom g;
  g.item = cs.f_split.div(u);
  g.sp = u - g.item * cs.split;
  g.d = cs.f_per_dec.div(g.item);
  const int r = g.item - g.d * cs.per_dec, mt = cs.f_n_tiles.div(r);
  g.m0 = mt * kBM;
  g.n0 = (r - mt * cs.n_tiles) * kBN;
  g.lo = cs.f_split.div(g.sp * cs.steps);
  g.n_it = cs.f_split.div((g.sp + 1) * cs.steps) - g.lo;
  return g;
}

// What a phase's epilogue does with its conv output a (8 channels ch.. of
// pixel p of decoder d, f32), the staged constants k[row][channel]:
//   kIn:   dst = relu(a k0 + k1)                       (conv_in, BN)
//   k31:   dst = relu(a + k0)                          (3x1 conv, bias)
//   k13:   dst = relu((a + k0) k1 + k2 (+ src))        (1x3 conv, BN,
//                                                      residual in half 1)
//   kProj: dst = up + round(a k0 + k1), up = round(the parity value of the
//          x2 upsample of src at p: 4 taps, rows 2 + 4 parity + tap of k)
// Rows: v0, v1, v2 (+ d v_ds), ups (+ 16 C d, 16 rows of C) in f32.
enum EpiKind { kIn = 0, k31, k13, kProj };

template <typename T>
struct EpiCtx {
  int kind, half;
  T* dst;
  size_t dst_ds;    // elements between the decoders' outputs
  const T* src;     // k13 half 1: the residual map; kProj: the map to
  size_t src_ds;    // upsample, h x w (each decoder's)
  int c, h, w;
  const float* v0;
  const float* v1;
  const float* v2;
  size_t v_ds;
  const float* ups;
};

template <typename T>
__device__ __forceinline__ int epi_rows(const EpiCtx<T>& e) {
  return e.kind == kIn ? 2 : e.kind == k31 ? 1 : e.kind == k13 ? 3
                                                                : kVecRows;
}

// The unit's constants into s_vec by asynchronous 16-byte copies (every
// row starts on a 256-byte boundary: C is a multiple of 64); the caller
// commits them with its first K step's copies.
template <typename T>
__device__ __forceinline__ void stage_consts(const EpiCtx<T>& e,
                                             float (*s_vec)[kBN], int d,
                                             int n0) {
  const int chunks = epi_rows(e) * (kBN / 4);
  for (int i = threadIdx.x; i < chunks; i += kThreads) {
    const int r = i / (kBN / 4), q = (i % (kBN / 4)) * 4;
    const float* row =
        r == 0   ? e.v0 + d * e.v_ds
        : r == 1 ? e.v1 + d * e.v_ds
        : e.kind == k13 ? e.v2 + d * e.v_ds
                        : e.ups + ((size_t)d * 16 + r - 2) * e.c;
    cp_async16(&s_vec[r][q], row + n0 + q, true);
  }
}

// The loads a vector's epilogue needs before it stores (the residual; the
// upsample's 4 taps, zero outside the map). (y, x): pixel p's row and
// column in its image of the phase's output map.
template <typename T>
__device__ __forceinline__ void epi_load(const EpiCtx<T>& e, int d, int p,
                                         int y, int x, int ch,
                                         Raw8<T> (&pre)[4]) {
  if (e.kind == k13 && e.half) {
    pre[0] = ld_cg8(e.src + d * e.src_ds + (size_t)p * e.c + ch);
  } else if (e.kind == kProj) {
    // the first pixel of p's image in the h x w map: p's image starts at
    // p - (y 2w + x) in the 2h x 2w output, 4 times as far in
    const int img0 = (p - y * 2 * e.w - x) >> 2;
    const int y0 = (y >> 1) + (y & 1) - 1, x0 = (x >> 1) + (x & 1) - 1;
    const T* xm = e.src + d * e.src_ds + (size_t)img0 * e.c + ch;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int sy = y0 + (t >> 1), sx = x0 + (t & 1);
      pre[t] = sy >= 0 && sy < e.h && sx >= 0 && sx < e.w
                   ? ld_cg8(xm + ((size_t)sy * e.w + sx) * e.c)
                   : zero8<T>();
    }
  }
}

template <typename T>
__device__ __forceinline__ void epi_store(const EpiCtx<T>& e,
                                          const float (*k)[kBN], int d,
                                          int p, int y, int x, int ch,
                                          const float (&a)[8],
                                          const Raw8<T> (&pre)[4]) {
  const int j = ch % kBN;
  float f[8];
  if (e.kind == kIn) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      f[i] = fmaxf(a[i] * k[0][j + i] + k[1][j + i], 0.f);
  } else if (e.kind == k31) {
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = fmaxf(a[i] + k[0][j + i], 0.f);
  } else if (e.kind == k13) {
    float r[8];
    unpack8(pre[0], r);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v = (a[i] + k[0][j + i]) * k[1][j + i] + k[2][j + i];
      if (e.half) v += r[i];
      f[i] = fmaxf(v, 0.f);
    }
  } else {
    const int par = (y & 1) * 2 + (x & 1);
    float up[8];
#pragma unroll
    for (int t = 0; t < 4; ++t) {  // the taps in order
      float v[8];
      unpack8(pre[t], v);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float prod = __fmul_rn(v[i], k[2 + par * 4 + t][j + i]);
        up[i] = t == 0 ? prod : __fadd_rn(up[i], prod);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      f[i] = __fadd_rn(round_to<T>(up[i]),
                       round_to<T>(a[i] * k[0][j + i] + k[1][j + i]));
  }
  st8(e.dst + d * e.dst_ds + (size_t)p * e.c + ch, f);
}

// The epilogue of one item from its output tile: thread t takes 8
// channels (t % 8) of pixels t / 8 + 16 v, v < 4 (a warp 4 pixels x 64
// channels, 128 contiguous bytes a pixel in bf16), two vectors at a time,
// each pair's loads (residual, upsample inputs) issued before its first
// store. The output map is cs.h x cs.w an image.
template <typename T>
__device__ __forceinline__ void tile_epilogue(const float* out,
                                              const ConvSpec& cs, int d,
                                              int m0, int n0,
                                              const EpiCtx<T>& e,
                                              const float (*k)[kBN]) {
  constexpr int kVecs = kBM * kBN / 8 / kThreads;  // 4
  constexpr int kBatch = 2;
  const int total = cs.total, hh = cs.h, ww = cs.w;
  const int r0 = threadIdx.x / 8, ch = n0 + (threadIdx.x % 8) * 8;
  int ys[kVecs], xs[kVecs];
  {
    const int rem = cs.f_hw.mod(m0 + r0);
    int y = cs.f_w.div(rem), x = rem - y * ww;
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      ys[v] = y;
      xs[v] = x;
      for (x += kThreads / 8; x >= ww; x -= ww)
        if (++y == hh) y = 0;
    }
  }
#pragma unroll
  for (int v0 = 0; v0 < kVecs; v0 += kBatch) {
    Raw8<T> pre[kBatch][4];
#pragma unroll
    for (int v = 0; v < kBatch; ++v) {
      const int p = m0 + r0 + (v0 + v) * (kThreads / 8);
      if (p < total) epi_load(e, d, p, ys[v0 + v], xs[v0 + v], ch, pre[v]);
    }
#pragma unroll
    for (int v = 0; v < kBatch; ++v) {
      const int row = r0 + (v0 + v) * (kThreads / 8), p = m0 + row;
      if (p >= total) continue;
      const float* o = out + row * kOutStride + (ch - n0);
      const float4 lo = *reinterpret_cast<const float4*>(o);
      const float4 hi = *reinterpret_cast<const float4*>(o + 4);
      const float a[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      epi_store(e, k, d, p, ys[v0 + v], xs[v0 + v], ch, a, pre[v]);
    }
  }
}

// A split's ticket of its item: an acq_rel atomic add at GPU scope, after
// the block's barrier, so it releases the partial the whole block stored
// and, for the last split, acquires every other split's.
__device__ __forceinline__ int ticket(int* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

// Thread 0, before the grid barrier that precedes a phase: the B tiles
// of the block's first unit's first kStages - 1 K steps into their ring
// stages (the weights do not depend on the barrier; every warp has left
// its last K loop); the unit's prologue then issues only their A tiles.
__device__ __forceinline__ void preload_weights(Ring& ring,
                                                const ConvSpec& cs,
                                                int n_dec) {
  ring.b_ahead = 0;
  if ((int)blockIdx.x >= cs.units) return;
  const UnitGeom g = unit_geom(cs, blockIdx.x);
  const int kch = cs.kch;
  const int w_row = g.d * cs.w_rows_d + cs.w_row0;
  for (int s = 0; s < g.n_it && s < kStages - 1; ++s) {
    const int stage = (ring.step + s) % kStages, step = g.lo + s;
    wg::mbar_expect_tx(&ring.full[stage], kBBytes);
    wg::tma_load_2d(ring.b + stage * kBBytes, cs.wmap, &ring.full[stage],
                    g.n0, w_row + cs.f_kch.div(step) * cs.cin +
                              cs.f_kch.mod(step) * kBK);
    ++ring.b_ahead;
  }
}

// One bf16 phase. Per unit: the loads of its first kStages - 1 K steps,
// the epilogue constants (`stage`, while those loads fly), the K loop,
// then the epilogue, or, with a split, the partial and the ticket.
__device__ __forceinline__ void conv_phase(Ring& ring, int* s_last,
                                           float (*s_vec)[kBN],
                                           const TrunkArgs& args, int n_dec,
                                           const ConvSpec& cs,
                                           const EpiCtx<bf16>& e,
                                           unsigned long long* detail) {
  constexpr int kAcc = kTile / kThreads;  // 32 accumulators a thread
  constexpr int kQ = kAcc / 4;            // as float4
  const bf16* x = static_cast<const bf16*>(cs.x);
  const int total = cs.total, h = cs.h, w = cs.w, cin = cs.cin;
  const int kch = cs.kch, split = cs.split, units = cs.units;
  const int t = threadIdx.x, q = t & 7;  // the 16-byte chunk t copies

  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const UnitGeom g = unit_geom(cs, u);
    const int m0 = g.m0, n0 = g.n0, lo = g.lo, n_it = g.n_it;
    const bf16* xd = x + g.d * cs.x_ds;
    const int w_row = g.d * cs.w_rows_d + cs.w_row0;
    // the 4 rows of A this thread copies: rows r0 + 16 i, chunk q, at the
    // same swizzled column in every row (16 is a multiple of 8); their
    // image row and column, stepped without divisions
    const int r0 = t >> 3;
    const uint32_t a_off = r0 * 128 + ((q ^ (r0 & 7)) << 4);
    const bf16* a_src = xd + (size_t)(m0 + r0) * cin + q * 8;
    int py[4], px[4];
    {
      const int rem = cs.f_hw.mod(m0 + r0);
      int y = cs.f_w.div(rem), xx = rem - y * w;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        py[i] = m0 + r0 + 16 * i < total ? y : -(1 << 20);  // never in
        px[i] = xx;                                         // the image
        for (xx += 16; xx >= w; xx -= w)
          if (++y == h) y = 0;
      }
    }
    // the next K step to issue: its tap (ty, tx), channel chunk kc, count
    int ty, tx, kc, n_issued = 0;
    {
      const int tap = cs.f_kch.div(lo);
      kc = lo - tap * kch;
      ty = cs.f_tw.div(tap);
      tx = tap - ty * cs.tw;
    }
    auto issue = [&](uint32_t gs) {  // the next K step into stage gs
      const int stage_i = gs % kStages, k0 = kc * kBK;
      const int dy = ty - cs.th / 2, dx = tx - cs.tw / 2;
      uint8_t* sa = ring.a + stage_i * kABytes + a_off;
      const bf16* src = a_src + (dy * w + dx) * cin + k0;
      const bool ch_ok = k0 + q * 8 < cin;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int y = py[i] + dy, xx = px[i] + dx;
        const bool ok = ch_ok && y >= 0 && y < h && xx >= 0 && xx < w;
        cp_async16(sa + i * 16 * 128, ok ? src + i * 16 * cin : xd, ok);
      }
      if (t == 0 && n_issued >= ring.b_ahead) {
        wg::mbar_expect_tx(&ring.full[stage_i], kBBytes);
        wg::tma_load_2d(ring.b + stage_i * kBBytes, cs.wmap,
                        &ring.full[stage_i], n0,
                        w_row + (ty * cs.tw + tx) * cin + k0);
      }
      ++n_issued;
      if (++kc == kch) {
        kc = 0;
        if (++tx == cs.tw) {
          tx = 0;
          ++ty;
        }
      }
    };

    // the previous unit's MMAs have read every stage, its epilogue the
    // staged constants
    __syncthreads();
    stage_consts(e, s_vec, g.d, n0);  // joins the first step's copies
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_it) issue(ring.step + s);
      cp_async_commit();
    }
    ring.b_ahead = 0;
    // block 0's first unit, when stamping: its timeline
    const bool mark = detail != nullptr && u == (int)blockIdx.x && t == 0;
    if (mark) detail[0] = global_ns();
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    for (int it = 0; it < n_it; ++it) {
      const uint32_t gs = ring.step + it;
      const int stage_i = gs % kStages;
      cp_async_wait<kStages - 2>();  // this thread's A chunks of step it
      wg::fence_proxy_async();
      wait_full(&ring.full[stage_i], (gs / kStages) & 1);
      // every thread's chunks have landed, and every warp has finished
      // the MMAs of step it - 1, whose stage the next loads refill
      __syncthreads();
      if (mark && it == 0) detail[1] = global_ns();
      if (it + kStages - 1 < n_it) issue(gs + kStages - 1);
      cp_async_commit();
      wg::fence_regs(acc);
      wg::wgmma_fence();
      const uint64_t da = wg::make_desc(ring.a + stage_i * kABytes);
      const uint64_t db = wg::make_desc_mn(ring.b + stage_i * kBBytes);
#pragma unroll
      for (int k = 0; k < kBK / 16; ++k)  // A: +32 bytes, B: +16 rows
        wg::wgmma_m64n64k16<1>(acc, da + 2 * k, db + 128 * k);
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_regs(acc);
    }
    cp_async_wait<0>();
    ring.step += n_it;
    if (mark) detail[2] = global_ns();

    if (split > 1) {
      // publish the partial, then the ticket (thread 0's release after the
      // block's barrier covers every thread's stores); the last split
      // adds all partials in split order
      float4* part = reinterpret_cast<float4*>(args.ws) +
                     (size_t)u * (kTile / 4) + t;
#pragma unroll
      for (int i = 0; i < kQ; ++i)
        part[i * kThreads] = make_float4(acc[4 * i], acc[4 * i + 1],
                                         acc[4 * i + 2], acc[4 * i + 3]);
      __syncthreads();
      if (t == 0) *s_last = ticket(&args.tickets[g.item]) == split - 1;
      __syncthreads();
      if (mark) detail[3] = global_ns();
      if (!*s_last) continue;
      // the partials, kRed at a time, through the idle ring by 16-byte
      // copies (thread t copies and reads back only its own float4s, so
      // one wait and no barrier separate a batch's copies and sums)
      constexpr int kRed = kStages * (kABytes + kBBytes) / (kTile * 4);
      const float* base = args.ws + (size_t)g.item * split * kTile;
      float4* red = reinterpret_cast<float4*>(ring.a);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
      for (int s0 = 0; s0 < split; s0 += kRed) {
        const int nb = split - s0 < kRed ? split - s0 : kRed;
        for (int b = 0; b < nb; ++b)
#pragma unroll
          for (int i = 0; i < kQ; ++i)
            cp_async16(red + (b * kQ + i) * kThreads + t,
                       base + ((size_t)(s0 + b) * kQ * kThreads +
                               i * kThreads + t) * 4, true);
        cp_async_commit();
        cp_async_wait<0>();
        for (int b = 0; b < nb; ++b)
#pragma unroll
          for (int i = 0; i < kQ; ++i) {
            const float4 v = red[(b * kQ + i) * kThreads + t];
            acc[4 * i] += v.x;
            acc[4 * i + 1] += v.y;
            acc[4 * i + 2] += v.z;
            acc[4 * i + 3] += v.w;
          }
      }
      if (t == 0) args.tickets[g.item] = 0;
      if (mark) detail[4] = global_ns();
    }
    // the accumulators into the output tile (over the ring's A stages,
    // which every warp has finished reading), then the epilogue: thread t
    // holds rows row0 + 8 half, channels 8 j + col0 + e in acc[4 j + 2
    // half + e]
    float* out = reinterpret_cast<float*>(ring.a);
    __syncthreads();
    const int row0 = (t >> 5) * 16 + ((t & 31) >> 2), col0 = (t & 3) * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
        *reinterpret_cast<float2*>(out + (row0 + 8 * half) * kOutStride +
                                   8 * j + col0) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    __syncthreads();
    tile_epilogue(out, cs, g.d, m0, n0, e, s_vec);
    if (mark) detail[5] = global_ns();
  }
}

// The f32 phase: every block loops over items, each its whole K loop.
__device__ __forceinline__ void conv_phase(uint8_t* smem,
                                           float (*s_vec)[kBN], int n_dec,
                                           const ConvSpec& cs,
                                           const EpiCtx<float>& e) {
  const int m_tiles = ceil_div(cs.total, kBM), n_tiles = cs.cout / kBN;
  const int per_dec = m_tiles * n_tiles;
  const float* x = static_cast<const float*>(cs.x);
  const float* wt = static_cast<const float*>(cs.wt);
  float* out = reinterpret_cast<float*>(smem);
  for (int item = blockIdx.x; item < n_dec * per_dec; item += gridDim.x) {
    const int d = item / per_dec, r = item % per_dec;
    const int m0 = (r / n_tiles) * kBM, n0 = (r % n_tiles) * kBN;
    // the previous item's epilogue has read the tile and the staged
    // constants; conv_tile_f32 synchronises before it computes
    __syncthreads();
    stage_consts(e, s_vec, d, n0);
    cp_async_commit();
    cp_async_wait<0>();
    conv_tile_f32(*reinterpret_cast<F32TileSmem*>(smem), out,
                  x + d * cs.x_ds, cs.total, cs.h, cs.w, cs.cin, cs.th,
                  cs.tw, wt + d * cs.wt_ds, cs.cout, m0, n0);
    __syncthreads();
    tile_epilogue(out, cs, d, m0, n0, e, s_vec);
  }
}

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decoder_trunk_kernel(const __grid_constant__ TrunkArgs args) {
  constexpr bool kWg = std::is_same<T, bf16>::value;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // the modules' fields, indexed by the module loop: in shared memory,
  // since a kernel parameter indexed at run time goes to local memory
  __shared__ TrunkModule mods[kMaxModules];
  __shared__ __align__(16) float s_vec[kVecRows][kBN];
  __shared__ int s_last;
  // the phase's conv and epilogue, read from shared memory where used
  // rather than held in registers through the K loop; two of each, by
  // phase parity, so thread 0 writes the next phase's before the barrier
  __shared__ ConvSpec s_cs[2];
  __shared__ EpiCtx<T> s_epi[2];
  // the divisors of each module's four kinds of phase (conv_in, 3x1, 1x3,
  // projection), computed once: a 64-bit division is long
  __shared__ FastDiv s_fd[kMaxModules][4][kFastDivs];
  Ring ring{};
  if constexpr (kWg) {
    ring.a = align1024(smem_raw);
    ring.b = ring.a + kStages * kABytes;
    ring.full = reinterpret_cast<uint64_t*>(ring.b + kStages * kBBytes);
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kMaxModules; ++i) mods[i] = args.m[i];
    if constexpr (kWg) {
      for (int s = 0; s < kStages; ++s) wg::mbar_init(&ring.full[s], 1);
      wg::mbar_fence_init();
      for (int i = 0; i < args.n_modules; ++i)
        for (int j = 0; j < kMaps; ++j) prefetch_tensormap(&args.wmap[i][j]);
    }
  }
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  const int nd = args.d, n = args.n, nk = args.k, tid = threadIdx.x;
  const int per = 2 + 4 * nk;  // phases per module
  T* bx = static_cast<T*>(args.bx);
  T* by = static_cast<T*>(args.by);
  T* bz = static_cast<T*>(args.bz);
  unsigned long long* stamps = args.stamps;
  const bool stamp0 = stamps != nullptr && blockIdx.x == 0 && tid == 0;
  int phase = 0;
  if (stamp0) stamps[0] = global_ns();

  // phase j of module mi: 0 conv_in; 1 + 4 kb + 2 half + {0: 3x1, 1: 1x3}
  // the NBt1D blocks; per - 1 the projection + upsample
  auto spec = [&](int mi, int j) -> ConvSpec {
    const TrunkModule& m = mods[mi];
    const CUtensorMap* maps = args.wmap[mi];
    const int total = n * m.h * m.w, c = m.c;
    const size_t map = (size_t)total * c;  // one decoder's map
    if (j == 0)
      return {mi == 0 ? args.ctx : mods[mi - 1].out,
              mi == 0 ? 0 : (size_t)total * m.cin, total, m.h, m.w, m.cin,
              3, 3, c, m.cin_w, (size_t)9 * m.cin * c, maps + kMapIn,
              9 * m.cin, 0, m.split_in};
    if (j == per - 1)
      return {m.skip, 0, 4 * total, 2 * m.h, 2 * m.w, m.cs, 1, 1, c,
              m.proj_w, (size_t)m.cs * c, maps + kMapProj, m.cs, 0,
              m.split_proj};
    const int b = j - 1, kb = b / 4, half = (b / 2) % 2;
    const int row0 = (kb * 2 + half) * 3 * c, rows = nk * 6 * c;
    if (b % 2 == 0)
      return {half ? by : bx, map, total, m.h, m.w, c, 3, 1, c,
              static_cast<const T*>(m.w31) + (size_t)row0 * c,
              (size_t)rows * c, maps + kMap31, rows, row0, m.split_blk};
    return {bz, map, total, m.h, m.w, c, 1, 3, c,
            static_cast<const T*>(m.w13) + (size_t)row0 * c,
            (size_t)rows * c, maps + kMap13, rows, row0, m.split_blk};
  };
  // phase j's epilogue (see EpiKind)
  auto epi = [&](int mi, int j) -> EpiCtx<T> {
    const TrunkModule& m = mods[mi];
    const int c = m.c;
    const size_t map = (size_t)n * m.h * m.w * c;  // one decoder's map
    EpiCtx<T> e{};
    e.c = c;
    e.h = m.h;
    e.w = m.w;
    e.dst_ds = map;
    e.src = bx;
    e.src_ds = map;
    if (j == 0) {
      e.kind = kIn;
      e.dst = bx;
      e.v0 = m.cin_s;
      e.v1 = m.cin_t;
      e.v_ds = c;
    } else if (j == per - 1) {
      e.kind = kProj;
      e.dst = static_cast<T*>(m.out);
      e.dst_ds = 4 * map;
      e.v0 = m.proj_s;
      e.v1 = m.proj_t;
      e.v_ds = c;
      e.ups = m.ups;
    } else {
      const int b = j - 1;
      const size_t vo = (size_t)(b / 2) * c;  // (K, 2, C) row
      e.half = (b / 2) % 2;
      e.v_ds = (size_t)nk * 2 * c;
      if (b % 2 == 0) {
        e.kind = k31;
        e.dst = bz;
        e.v0 = m.b31 + vo;
      } else {
        // half 0 x -> z -> y, half 1 y -> z -> x (in place: each output
        // element reads only its own residual)
        e.kind = k13;
        e.dst = e.half ? bx : by;
        e.v0 = m.b13 + vo;
        e.v1 = m.bn_s + vo;
        e.v2 = m.bn_t + vo;
      }
    }
    return e;
  };

  // phase j's kind: 0 conv_in, 1 the 3x1 convs, 2 the 1x3 convs, 3 the
  // projection; each module's phases of one kind share their divisors
  auto kind_phase = [&](int k) { return k == 3 ? per - 1 : k; };
  auto phase_kind = [&](int j) {
    return j == 0 ? 0 : j == per - 1 ? 3 : 2 - j % 2;
  };
  for (int i = tid; i < args.n_modules * 4 * kFastDivs; i += kThreads) {
    const int mi = i / (4 * kFastDivs), k = i / kFastDivs % 4;
    s_fd[mi][k][i % kFastDivs].set(
        divisor(prepare(spec(mi, kind_phase(k)), nd), i % kFastDivs));
  }
  __syncthreads();
  if (tid == 0) {
    s_cs[0] = prepare(spec(0, 0), nd, s_fd[0][0]);
    s_epi[0] = epi(0, 0);
  }
  __syncthreads();
  for (int mi = 0; mi < args.n_modules; ++mi) {
    for (int j = 0; j < per; ++j) {
      const ConvSpec& cs = s_cs[phase & 1];
      if constexpr (kWg) {
        conv_phase(ring, &s_last, s_vec, args, nd, cs, s_epi[phase & 1],
                   stamp0 ? stamps + kStampRow * phase + 2 : nullptr);
      } else {
        conv_phase(smem_raw, s_vec, nd, cs, s_epi[phase & 1]);
      }
      // the end of the phase: the next phase's first weight tiles into
      // the ring, the block's work-end stamp, the grid barrier (the last phase
      // has one only when stamping), the next phase's start stamp
      const bool last = mi + 1 == args.n_modules && j == per - 1;
      if (!last && tid == 0) {
        const int mn = j + 1 < per ? mi : mi + 1, jn = j + 1 < per ? j + 1 : 0;
        s_cs[(phase + 1) & 1] =
            prepare(spec(mn, jn), nd, s_fd[mn][phase_kind(jn)]);
        s_epi[(phase + 1) & 1] = epi(mn, jn);
        if constexpr (kWg) preload_weights(ring, s_cs[(phase + 1) & 1], nd);
      }
      if (stamps != nullptr) {
        __syncthreads();
        if (tid == 0) atomicMax(&stamps[kStampRow * phase + 1], global_ns());
      }
      if (!last || stamps != nullptr) grid.sync();
      ++phase;
      if (stamp0) stamps[kStampRow * phase] = global_ns();
    }
  }
}

template <typename T>
constexpr size_t smem_bytes() {
  return std::is_same<T, bf16>::value
             ? kWgSmem
             : (sizeof(F32TileSmem) > kOutBytes ? sizeof(F32TileSmem)
                                                : kOutBytes);
}

// Blocks of the cooperative grid: every block must be resident at once
// for the grid barrier (the cooperative launch refuses, and never hangs
// on, a larger grid). A fixed number per device and type, so every call
// splits its phases the same way.
template <typename T>
int grid_blocks() {
  static int blocks = 0;
  if (blocks > 0) return blocks;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = cudaFuncSetAttribute(
      decoder_trunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<T>());
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, decoder_trunk_kernel<T>, kThreads, smem_bytes<T>());
  if (err != cudaSuccess) return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
  const int cap = std::is_same<T, bf16>::value ? kBlocksPerSm : 4;
  blocks = sms * (per_sm < cap ? per_sm : cap);
  return blocks;
}

// (rows, C) bf16 weights, one 64 x 64 box a K step
inline int weight_map(CUtensorMap* map, const void* p, long long rows,
                      int c) {
  const cuuint64_t dims[2] = {(cuuint64_t)c, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)c * 2};
  const cuuint32_t box[2] = {kBN, kBK};
  return encode_map(map, p, 2, dims, strides, box);
}

template <typename T>
int launch(TrunkArgs& args, cudaStream_t stream) {
  const int blocks = grid_blocks<T>();
  if (blocks <= 0) return -blocks;
  if constexpr (std::is_same<T, bf16>::value) {
    for (int i = 0; i < args.n_modules; ++i) {
      const TrunkModule& m = args.m[i];
      const long long d = args.d;
      int err = weight_map(&args.wmap[i][kMapIn], m.cin_w, d * 9 * m.cin,
                           m.c);
      if (!err)
        err = weight_map(&args.wmap[i][kMap31], m.w31,
                         d * args.k * 6 * m.c, m.c);
      if (!err)
        err = weight_map(&args.wmap[i][kMap13], m.w13,
                         d * args.k * 6 * m.c, m.c);
      if (!err)
        err = weight_map(&args.wmap[i][kMapProj], m.proj_w, d * m.cs, m.c);
      if (err) return err;
    }
  }
  void* params[] = {&args};
  cudaLaunchCooperativeKernel((const void*)decoder_trunk_kernel<T>,
                              dim3(blocks), dim3(kThreads), params,
                              smem_bytes<T>(), stream);
  return (int)cudaGetLastError();
}

}  // namespace trunk
}  // namespace emsanet

// Blocks of the kernel's grid for dtype (0 f32, 1 bf16), or -cudaError.
// The wrapper plans each phase's K split for this many blocks.
extern "C" int decoder_trunk_grid(int dtype) {
  using namespace emsanet;
  return dtype == kBF16 ? trunk::grid_blocks<bf16>()
                        : trunk::grid_blocks<float>();
}

// a: D, N, K, n_modules, ctx, bx, by, bz, ws, tickets, stamps, then per
// module the 23 fields of TrunkModule in order (pointers as integers).
// The wrapper (ops/decoder_trunk.py) checks every shape, dtype and
// alignment and plans the splits.
extern "C" int decoder_trunk_launch(int dtype, const long long* a,
                                    void* stream) {
  using namespace emsanet::trunk;
  TrunkArgs args{};
  args.d = (int)a[0];
  args.n = (int)a[1];
  args.k = (int)a[2];
  args.n_modules = (int)a[3];
  if (args.n_modules < 1 || args.n_modules > kMaxModules)
    return (int)cudaErrorInvalidValue;
  args.ctx = (const void*)a[4];
  args.bx = (void*)a[5];
  args.by = (void*)a[6];
  args.bz = (void*)a[7];
  args.ws = (float*)a[8];
  args.tickets = (int*)a[9];
  args.stamps = (unsigned long long*)a[10];
  for (int i = 0; i < args.n_modules; ++i) {
    const long long* f = a + 11 + 23 * i;
    TrunkModule& m = args.m[i];
    m.h = (int)f[0];
    m.w = (int)f[1];
    m.cin = (int)f[2];
    m.c = (int)f[3];
    m.cs = (int)f[4];
    m.split_in = (int)f[5];
    m.split_blk = (int)f[6];
    m.split_proj = (int)f[7];
    m.cin_w = (const void*)f[8];
    m.cin_s = (const float*)f[9];
    m.cin_t = (const float*)f[10];
    m.w31 = (const void*)f[11];
    m.w13 = (const void*)f[12];
    m.b31 = (const float*)f[13];
    m.b13 = (const float*)f[14];
    m.bn_s = (const float*)f[15];
    m.bn_t = (const float*)f[16];
    m.ups = (const float*)f[17];
    m.skip = (const void*)f[18];
    m.proj_w = (const void*)f[19];
    m.proj_s = (const float*)f[20];
    m.proj_t = (const float*)f[21];
    m.out = (void*)f[22];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == emsanet::kBF16 ? launch<emsanet::bf16>(args, s)
                                 : launch<float>(args, s);
}
