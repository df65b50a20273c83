// Whole-window chromatic Gibbs sweep for Hopper (sm_90a).
//
// Replaces grample_tpu/ops/gibbs_pallas.py::_make_kernel (launched by
// _pallas_window), the reference's only TPU kernel, in both of its forms
// (local tables of at most 32 rows, and the wide-OA form of 33 to 256
// rows, gibbs_pallas.py:355-367).  It computes the same window: for each
// sweep and color, every site's local-table log-conditional summed over
// its incidences, masked to the card, max-shifted exp, the 1e-6 * total
// floor, and one counter-hashed uniform drawn by inverse CDF; if counting,
// one count per site into half (sweep >= half_point).  The plain PyTorch
// version of the same function is
// grample_tpu_torch/ops/gibbs_torch.py::window_plain.
//
// What bounds it on this card: operations issued per site, the number of
// warps an SM can keep resident to hide the latency of the dependent
// shared-memory loads between them (list word -> state word -> table
// row), and, in a counted window, the count stream.  A window reads its
// state once and writes it once, but a counted draw is a 4-byte
// reduction into counts[N, 2, K, NSLOT, C], and one half's rows of every
// live site and outcome are live at once: 203 MB for a 10x10 grid at
// 2 x 131072 chains, 912 MB for a 916-var Promedus-shaped net at
// 2 x 65536, far over the 50 MB L2.  So each reduction is a
// read-modify-write of device memory: a warp's binary draws touch one
// 128-byte row segment per outcome drawn, 16 bytes of traffic a counted
// update where every outcome was reduced (about 2 TB/s at 1.2e11 updates
// a second), 8 where outcome 0's is derived (below).  The reference's
// layout is dense rectangles padded to the caps of the whole group (every
// slot row, every incidence slot, every scope slot), which a vector unit
// sweeps for free and a GPU thread pays for slot by slot: on a
// Promedus-shaped collapse encoding fewer than 1 row in 4 is a site and 1
// scope slot in 80 has a stride.  So:
//
//  - The kernel walks the compact work lists of ops/layout.py: live
//    sites only, each site's live incidences only, each incidence's live
//    scope entries only, and tables cut to the rows a stride can reach.
//    Skipping a dead incidence is exact (its table row is all 0.0f and
//    x + 0.0f == x); dead rows are neither drawn nor counted nor written
//    (their counts stay 0, their state stays as given: 0 in every caller).
//  - Most sites walk one merged incidence in those lists: its scope is
//    the site's Markov blanket and its table holds, per blanket
//    configuration, the sum of the site's incidences' rows, added from
//    0.0f in f order at layout time as this walk would add them, so
//    0.0f + that row is the sum the unmerged walk makes, bit for bit.
//    Nothing here tells the two apart: a merged site is a site with one
//    incidence, and a grid site walks 1 incidence where it walked 4.6.
//    The header's H_WALK_FLOATS is the table floats the lists hold.
//  - A block copies its variant's lists, and the tables when they fit,
//    into shared memory once per window with 16-byte cp.async copies, and
//    every thread reuses them for all sweeps.  What does not fit stays in
//    device memory and is read through L1 (every thread of a warp reads
//    the same list word, a broadcast); the compact tables of a variant
//    are tens of KB, so they stay in L2 however many variants run.
//  - One thread per (variant, chain), as colors make sites of one color
//    independent: threads never synchronise after staging.  A thread's
//    chain state is held in shared memory over the rows the lists touch
//    only (live sites, then the evidence rows some scope entry reads),
//    packed to 1, 2 or 4 bits a row by the card bound, word w of thread t
//    at sm[w * T + t] (conflict-free).  A 916-var binary net needs 116
//    bytes a thread where the padded byte rows needed 3128 to 4200, which
//    is what lets 256-thread blocks and several blocks per SM be resident.
//  - Counts: the per-site count is a reduction without a return value
//    into counts[N, 2, K, NSLOT, C] (atomicAdd whose result is unused
//    compiles to RED, so the warp does not wait for device memory as it
//    did for a load-add-store).  16-bit counters in shared memory, flushed
//    at the half point and at the end, were measured beside it and were
//    slower on every shape: they cost more resident warps than the
//    reductions cost memory traffic (PERF.md).
//  - Only outcomes 1..K-1 are reduced per draw.  A chain draws every live
//    site once a sweep, so outcome 0's count in a half is the half's
//    sweeps less the other outcomes' counts, exactly, whatever the site's
//    in-card bits; derive_rest stores it once a window, after the sweeps.
//    On a binary net that halves the count stream.
//
//  - A launch too small to fill the card with a thread per chain (the
//    split group's aux launches: a few variants x 256 chains) takes the
//    site-parallel form instead, gibbs_window_sites_kernel below: a warp
//    per chain, its lanes on the live sites of one color.
//
//  - The gather form (template parameter GATHER) also walks the flat-table
//    gather bank, the reference's XLA code in
//    grample_tpu/ops/gibbs_xla.py::_color_logits (:129-141), which the
//    reference kernel's gate refuses: after a site's dense incidences it
//    sums its live gather incidences, in Fg order, into a second
//    accumulator, one int32 index (offset + sum of state * stride) and one
//    table read per in-card outcome (index + k * self_stride) each, then
//    adds that sum to the dense one (the reference's dense + sum over Fg).
//    The flat table is cut to the stretches live incidences can read and
//    rides behind the dense tables, so it is staged with them.  Skipping a
//    dead gather slot is exact as for a dense one: the encoder floors the
//    tables at LOG_EPS, so a masked entry is +-0.  Its plain version is
//    grample_tpu_torch/ops/gibbs_bank.py::window_ops.  At card bound 16 the
//    two accumulators take 32 registers, so those instances are bounded to
//    512-thread blocks (128 registers a thread).
//
// The hash is stateless per (site row in its color, chain, sweep, color),
// so the mapping of threads to sites does not change a draw.  Float
// arithmetic uses the _rn intrinsics so that the compiler does not
// contract a*b+c into an FMA, and sums run in the reference's order
// (incidences in f order, outcomes in k order): the draw rounds as the
// plain version and the reference kernel do, and a site differs only
// where expf's last bit moves a uniform across a CDF boundary.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kFloor = 1e-6f;
constexpr float kInv24 = 5.9604644775390625e-8f;  // 2^-24

// c_lists header words (ops/layout.py H_*)
constexpr int H_SITES = 0, H_ROWS = 1, H_OFF_COLOR = 5, H_OFF_SITES = 6, H_OFF_INCS = 7,
              H_OFF_SCOPE = 8, H_WORDS = 9, H_OFF_GSITES = 12, H_OFF_GINCS = 13,
              H_OFF_GSCOPE = 14, H_WALK_FLOATS = 18;

// Threads a block of an instance may have: the gather form at card bound
// 16 holds two 16-logit accumulators (ops/gibbs_cuda.py::max_threads).
#define MAX_THREADS(KMAX, GATHER) (((GATHER) && (KMAX) > 8) ? 512 : 1024)

struct Params {
  const int32_t* c_lists;   // [N, lw]
  const float* c_tables;    // [N, tw]
  const int32_t* c_rows;    // [N, rw]
  int32_t* state;           // [N, NVp, C]
  int32_t* counts;          // [N, 2, K, NC*G, C]
  int lw, tw, rw, nc, g, k, nvp, c_total;
  uint32_t seed;
  int num_sweeps, half_point, cb;
  int stage_lists, stage_tables;  // copy them into shared memory
  int state_words;                // packed state words per chain
};

__device__ __forceinline__ float hash_uniform(uint32_t row, uint32_t lane_mix,
                                              uint32_t counter) {
  uint32_t x = (row * 0x9E3779B9u) ^ lane_mix ^ counter;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
  }
  // 24-bit mantissa-exact, through int32 as the reference does
  return static_cast<float>(static_cast<int32_t>(x >> 8)) * kInv24;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// Copy `n` 4-byte words (a multiple of 4) with every thread of the block.
__device__ __forceinline__ void stage(void* dst, const void* src, int n) {
  auto* d = static_cast<uint8_t*>(dst);
  const auto* s = static_cast<const uint8_t*>(src);
  for (int i = threadIdx.x * 4; i < n; i += blockDim.x * 4)
    cp_async16(d + static_cast<size_t>(i) * 4, s + static_cast<size_t>(i) * 4);
}

// A variant's work lists, wherever they lie (shared or device memory).
struct Lists {
  const int32_t* color_end;
  const int2* sites;   // (gi | kmask bits << 16, end index into incs)
  const int2* incs;    // (first table row, end index into scope)
  const uint32_t* scope;  // dense state row | stride << 16
  const float* tabs;
  const int32_t* gsites;  // end index into gincs, per site (gather form)
  const int4* gincs;   // (offset into tabs, self stride, end index into gscope, 0)
  const int2* gscope;  // (dense state row, stride)
};

// Start the block's copies of variant n's tables and lists into shared
// memory (those the launch stages) and commit them; returns where the
// lists and tables will be read from, and moves `sp` past the copies.
// Nothing staged may be read before cp_async_wait_all() and a barrier.
__device__ __forceinline__ void stage_variant(const Params& p, int n, uint8_t*& sp,
                                              const int32_t*& lists, const float*& tabs) {
  // header words come from device memory: the staged copy lands later
  lists = p.c_lists + static_cast<size_t>(n) * p.lw;
  tabs = p.c_tables + static_cast<size_t>(n) * p.tw;
  if (p.stage_tables) {
    stage(sp, tabs, (lists[H_WALK_FLOATS] + 3) & ~3);
    tabs = reinterpret_cast<const float*>(sp);
    sp += static_cast<size_t>(p.tw) * 4;
  }
  if (p.stage_lists) {
    stage(sp, lists, lists[H_WORDS]);
    lists = reinterpret_cast<const int32_t*>(sp);
    sp += static_cast<size_t>(p.lw) * 4;
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

template <bool GATHER>
__device__ __forceinline__ Lists open_lists(const int32_t* lists, const float* tabs) {
  Lists ls{lists + lists[H_OFF_COLOR],
           reinterpret_cast<const int2*>(lists + lists[H_OFF_SITES]),
           reinterpret_cast<const int2*>(lists + lists[H_OFF_INCS]),
           reinterpret_cast<const uint32_t*>(lists + lists[H_OFF_SCOPE]), tabs,
           nullptr, nullptr, nullptr};
  if (GATHER) {
    ls.gsites = lists + lists[H_OFF_GSITES];
    ls.gincs = reinterpret_cast<const int4*>(lists + lists[H_OFF_GINCS]);
    ls.gscope = reinterpret_cast<const int2*>(lists + lists[H_OFF_GSCOPE]);
  }
  return ls;
}

// One live gather incidence of a site: its table entries for the in-card
// outcomes (bits of km) added into acc, at gw.x + base + k * gw.y, where
// base is the sum of state * stride over its scope entries, int32 as the
// reference computes it.
template <int KMAX>
__device__ __forceinline__ void add_gather(float (&acc)[KMAX], const float* tabs,
                                           int4 gw, int base, uint32_t km, int k) {
  const int idx = gw.x + base;
#pragma unroll
  for (int kk = 0; kk < KMAX; ++kk)
    if (kk < k && ((km >> kk) & 1u)) acc[kk] = __fadd_rn(acc[kk], tabs[idx + kk * gw.y]);
}

// The inverse-CDF draw of one site from its summed logits lg[0..k), its
// in-card bits km and its hash row; the reference's arithmetic, op for op.
template <int KMAX>
__device__ __forceinline__ int draw_site(float (&lg)[KMAX], uint32_t km, int k,
                                         uint32_t row, uint32_t lane_mix,
                                         uint32_t counter) {
  float mx = kNeg;
#pragma unroll
  for (int kk = 0; kk < KMAX; ++kk) {
    if (kk < k) {
      lg[kk] = (km >> kk) & 1u ? lg[kk] : kNeg;
      mx = kk == 0 ? lg[kk] : fmaxf(mx, lg[kk]);
    }
  }
  float tot = 0.0f;
#pragma unroll
  for (int kk = 0; kk < KMAX; ++kk) {
    if (kk < k) {
      lg[kk] = expf(__fsub_rn(lg[kk], mx));
      tot = kk == 0 ? lg[kk] : __fadd_rn(tot, lg[kk]);
    }
  }
  const float floor_add = __fmul_rn(tot, kFloor);
  float tot2 = 0.0f;
#pragma unroll
  for (int kk = 0; kk < KMAX; ++kk) {
    if (kk < k) {
      lg[kk] = __fmul_rn(__fadd_rn(lg[kk], floor_add), (km >> kk) & 1u ? 1.0f : 0.0f);
      tot2 = kk == 0 ? lg[kk] : __fadd_rn(tot2, lg[kk]);
    }
  }
  const float u = __fmul_rn(hash_uniform(row, lane_mix, counter), tot2);
  float run = 0.0f;
  int newv = 0;
#pragma unroll
  for (int kk = 0; kk < KMAX - 1; ++kk) {
    if (kk < k - 1) {
      run = kk == 0 ? lg[kk] : __fadd_rn(run, lg[kk]);
      newv += u > run ? 1 : 0;
    }
  }
  return newv;
}

// Outcome 0's counts of count slot `slot` of one chain (cn: the chain's
// counts of its variant, at half 0, outcome 0, slot 0), in each half that
// counted a sweep: the half's n0 or n1 sweeps less the slot's counts at
// outcomes 1..k-1, which only this thread reduced into those addresses
// (each (slot, chain) belongs to one thread, or in the site-parallel form
// to one lane), so a load after its own reductions reads their sum (same
// thread, same address), and the store needs no atomic.  __ldcg reads L2,
// where the reductions land.
__device__ __forceinline__ void derive_rest(int32_t* cn, int slot, int nslot, size_t C, int k,
                                            int n0, int n1) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int sweeps = h == 0 ? n0 : n1;
    if (sweeps == 0) continue;
    int rest = sweeps;
    for (int kk = 1; kk < k; ++kk)
      rest -= __ldcg(cn + static_cast<size_t>((h * k + kk) * nslot + slot) * C);
    cn[static_cast<size_t>(h * k * nslot + slot) * C] = rest;
  }
}

// Where the window's end writes a chain's live-site states: the variant's
// live-site count, its kernel-row map and the chain's state column.  The
// variant index is read again from its special register, and the count
// from the lists' header, rather than held across the sweeps: held, the
// two spilled at card bound 16 in the counted instances.
struct WriteBack {
  int sites;
  const int32_t* rows;
  int32_t* state;
};

__device__ __forceinline__ WriteBack write_back(const Params& p, int c) {
  int n;
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(n));
  const auto* header = reinterpret_cast<const volatile int32_t*>(
      p.c_lists + static_cast<size_t>(n) * p.lw);
  const int sites = header[H_SITES];
  return {sites, p.c_rows + static_cast<size_t>(n) * p.rw,
          p.state + static_cast<size_t>(n) * p.nvp * static_cast<size_t>(p.c_total) + c};
}

// Blocks are up to 1024 threads wide whatever the card bound: the launch
// bound keeps the 16 logits of the widest instance within 64 registers.
// It asks for one resident block, not two: aiming at two, the compiler
// holds every instance to 32 registers and spills the logits at card
// bounds above 2, and the binary instance gains nothing from the second
// block (instruction throughput bounds the kernel, not latency).
template <int KMAX, bool COUNT, bool GATHER>
__global__ void __launch_bounds__(MAX_THREADS(KMAX, GATHER), 1)
gibbs_window_kernel(const Params p) {
  // state rows are packed BITS to a row, 32 / BITS rows to a word
  constexpr int BITS = KMAX <= 2 ? 1 : KMAX <= 4 ? 2 : 4;
  constexpr int RSH = BITS == 1 ? 5 : BITS == 2 ? 4 : 3;  // log2(rows per word)
  constexpr uint32_t RMASK = (1u << RSH) - 1u;
  constexpr uint32_t VMASK = (1u << BITS) - 1u;

  extern __shared__ __align__(16) uint8_t smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int c = blockIdx.x * T + tid;
  const int k = p.k;
  const size_t C = static_cast<size_t>(p.c_total);

  const int32_t* rows = p.c_rows + static_cast<size_t>(n) * p.rw;
  const int R = p.c_lists[static_cast<size_t>(n) * p.lw + H_ROWS];
  uint8_t* sp = smem;
  const int32_t* lists;
  const float* tabs;
  stage_variant(p, n, sp, lists, tabs);
  uint32_t* sm = reinterpret_cast<uint32_t*>(sp);  // [state_words][T]

  int32_t* st = p.state + static_cast<size_t>(n) * p.nvp * C + c;
  if (c < p.c_total) {
    // the copies above are in flight while the state is packed
    for (int w = 0; (w << RSH) < R; ++w) {
      uint32_t acc = 0;
#pragma unroll 4
      for (int j = 0; j <= static_cast<int>(RMASK); ++j) {
        const int r = (w << RSH) + j;
        if (r < R) acc |= (static_cast<uint32_t>(st[rows[r] * C]) & VMASK) << (j * BITS);
      }
      sm[w * T + tid] = acc;
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (c >= p.c_total) return;  // no barrier below

  const Lists ls = open_lists<GATHER>(lists, tabs);

  const uint32_t lane_mix = static_cast<uint32_t>(c % p.cb) * 0x85EBCA6Bu;
  const uint32_t cell = p.seed + 65537u * static_cast<uint32_t>(n) +
                        257u * static_cast<uint32_t>(c / p.cb);
  const int nslot = p.nc * p.g;
  int32_t* cn = p.counts + static_cast<size_t>(n) * 2 * k * nslot * C + c;

  for (int si = 0; si < p.num_sweeps; ++si) {
    const int hsel = si >= p.half_point ? 1 : 0;
    int site = 0, inc = 0, q = 0, ginc = 0, gq = 0;
    for (int ci = 0; ci < p.nc; ++ci) {
      const uint32_t counter =
          cell + 2654435761u * (static_cast<uint32_t>(si) * static_cast<uint32_t>(p.nc) +
                                static_cast<uint32_t>(ci));
      const int site_end = ls.color_end[ci];
      for (; site < site_end; ++site) {
        const int2 sw = ls.sites[site];
        const uint32_t gi = static_cast<uint32_t>(sw.x) & 0xFFFFu;
        const uint32_t km = static_cast<uint32_t>(sw.x) >> 16;
        float lg[KMAX];
#pragma unroll
        for (int kk = 0; kk < KMAX; ++kk) lg[kk] = 0.0f;
        for (; inc < sw.y; ++inc) {
          const int2 iw = ls.incs[inc];
          int trow = iw.x;
          // most incidences have one or two live entries: no unrolling
#pragma unroll 1
          for (; q < iw.y; ++q) {
            const uint32_t e = ls.scope[q];
            const uint32_t row = e & 0xFFFFu;
            const uint32_t v = (sm[(row >> RSH) * T + tid] >> ((row & RMASK) * BITS)) & VMASK;
            trow += static_cast<int>(v * (e >> 16));
          }
          const float* t = ls.tabs + trow * k;  // a variant's tables stay far below 2^31 floats
#pragma unroll
          for (int kk = 0; kk < KMAX; ++kk)
            if (kk < k) lg[kk] = __fadd_rn(lg[kk], t[kk]);
        }
        if (GATHER) {
          float ga[KMAX];
#pragma unroll
          for (int kk = 0; kk < KMAX; ++kk) ga[kk] = 0.0f;
          for (const int ginc_end = ls.gsites[site]; ginc < ginc_end; ++ginc) {
            const int4 gw = ls.gincs[ginc];
            int base = 0;
#pragma unroll 1
            for (; gq < gw.z; ++gq) {
              const int2 e = ls.gscope[gq];
              const uint32_t row = static_cast<uint32_t>(e.x);
              const uint32_t v = (sm[(row >> RSH) * T + tid] >> ((row & RMASK) * BITS)) & VMASK;
              base += static_cast<int>(v) * e.y;
            }
            add_gather<KMAX>(ga, ls.tabs, gw, base, km, k);
          }
#pragma unroll
          for (int kk = 0; kk < KMAX; ++kk)
            if (kk < k) lg[kk] = __fadd_rn(lg[kk], ga[kk]);
        }
        const int newv = draw_site<KMAX>(lg, km, k, gi, lane_mix, counter);
        uint32_t* word = sm + (site >> RSH) * T + tid;
        const int sh = (site & RMASK) * BITS;
        *word = (*word & ~(VMASK << sh)) | (static_cast<uint32_t>(newv) << sh);
        if (COUNT && newv != 0)
          atomicAdd(cn + static_cast<size_t>((hsel * k + newv) * nslot + ci * p.g + gi) * C, 1);
      }
    }
  }
  if (COUNT) {
    const int n0 = min(max(p.half_point, 0), p.num_sweeps);
    int site = 0;
    for (int ci = 0; ci < p.nc; ++ci)
      for (const int site_end = ls.color_end[ci]; site < site_end; ++site) {
        const int gi = ls.sites[site].x & 0xFFFF;
        derive_rest(cn, ci * p.g + gi, nslot, C, k, n0, p.num_sweeps - n0);
      }
  }
  const WriteBack wb = write_back(p, c);
  for (int s = 0; s < wb.sites; ++s)
    wb.state[wb.rows[s] * C] =
        static_cast<int32_t>((sm[(s >> RSH) * T + tid] >> ((s & RMASK) * BITS)) & VMASK);
}

// The site-parallel form, for launches too small to fill the card with
// one thread per chain: one warp per (variant, chain), and the lanes take
// the live sites of a color side by side (they are independent given the
// rest, and kernel order sorts a color by degree, so neighbouring lanes do
// like work), with __syncwarp() between colors.  Same site function, same
// hash row, lane and counter, so the same draws.  A chain's state is one
// byte a row here, since lanes write neighbouring rows at once; counts are
// reductions.  blockDim.x / 32 chains share a block's staged lists.
template <int KMAX, bool COUNT, bool GATHER>
__global__ void __launch_bounds__(MAX_THREADS(KMAX, GATHER), 1)
gibbs_window_sites_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.y;
  const int c = blockIdx.x * W + warp;
  const int k = p.k;
  const size_t C = static_cast<size_t>(p.c_total);

  const int32_t* rows = p.c_rows + static_cast<size_t>(n) * p.rw;
  const int R = p.c_lists[static_cast<size_t>(n) * p.lw + H_ROWS];
  uint8_t* sp = smem;
  const int32_t* lists;
  const float* tabs;
  stage_variant(p, n, sp, lists, tabs);
  uint8_t* sm = sp + static_cast<size_t>(warp) * p.rw;  // this chain's rows

  int32_t* st = p.state + static_cast<size_t>(n) * p.nvp * C + c;
  if (c < p.c_total)
    for (int r = lane; r < R; r += 32) sm[r] = static_cast<uint8_t>(st[rows[r] * C]);
  cp_async_wait_all();
  __syncthreads();
  if (c >= p.c_total) return;  // the whole warp leaves; only __syncwarp below

  const Lists ls = open_lists<GATHER>(lists, tabs);

  const uint32_t lane_mix = static_cast<uint32_t>(c % p.cb) * 0x85EBCA6Bu;
  const uint32_t cell = p.seed + 65537u * static_cast<uint32_t>(n) +
                        257u * static_cast<uint32_t>(c / p.cb);
  const int nslot = p.nc * p.g;
  int32_t* cn = p.counts + static_cast<size_t>(n) * 2 * k * nslot * C + c;

  for (int si = 0; si < p.num_sweeps; ++si) {
    const int hsel = si >= p.half_point ? 1 : 0;
    int site0 = 0;
    for (int ci = 0; ci < p.nc; ++ci) {
      const uint32_t counter =
          cell + 2654435761u * (static_cast<uint32_t>(si) * static_cast<uint32_t>(p.nc) +
                                static_cast<uint32_t>(ci));
      const int site_end = ls.color_end[ci];
      for (int site = site0 + lane; site < site_end; site += 32) {
        const int2 sw = ls.sites[site];
        const uint32_t gi = static_cast<uint32_t>(sw.x) & 0xFFFFu;
        const uint32_t km = static_cast<uint32_t>(sw.x) >> 16;
        float lg[KMAX];
#pragma unroll
        for (int kk = 0; kk < KMAX; ++kk) lg[kk] = 0.0f;
        for (int inc = site > 0 ? ls.sites[site - 1].y : 0; inc < sw.y; ++inc) {
          const int2 iw = ls.incs[inc];
          int trow = iw.x;
#pragma unroll 1
          for (int q = inc > 0 ? ls.incs[inc - 1].y : 0; q < iw.y; ++q) {
            const uint32_t e = ls.scope[q];
            trow += static_cast<int>(sm[e & 0xFFFFu] * (e >> 16));
          }
          const float* t = ls.tabs + trow * k;
#pragma unroll
          for (int kk = 0; kk < KMAX; ++kk)
            if (kk < k) lg[kk] = __fadd_rn(lg[kk], t[kk]);
        }
        if (GATHER) {
          float ga[KMAX];
#pragma unroll
          for (int kk = 0; kk < KMAX; ++kk) ga[kk] = 0.0f;
          for (int ginc = site > 0 ? ls.gsites[site - 1] : 0; ginc < ls.gsites[site]; ++ginc) {
            const int4 gw = ls.gincs[ginc];
            int base = 0;
#pragma unroll 1
            for (int gq = ginc > 0 ? ls.gincs[ginc - 1].z : 0; gq < gw.z; ++gq) {
              const int2 e = ls.gscope[gq];
              base += static_cast<int>(sm[e.x]) * e.y;
            }
            add_gather<KMAX>(ga, ls.tabs, gw, base, km, k);
          }
#pragma unroll
          for (int kk = 0; kk < KMAX; ++kk)
            if (kk < k) lg[kk] = __fadd_rn(lg[kk], ga[kk]);
        }
        const int newv = draw_site<KMAX>(lg, km, k, gi, lane_mix, counter);
        // no site of this color reads another: write at once
        sm[site] = static_cast<uint8_t>(newv);
        if (COUNT && newv != 0)
          atomicAdd(cn + static_cast<size_t>((hsel * k + newv) * nslot + ci * p.g + gi) * C, 1);
      }
      __syncwarp();
      site0 = site_end;
    }
  }
  if (COUNT) {  // each lane its own sites, as in every sweep
    const int n0 = min(max(p.half_point, 0), p.num_sweeps);
    int site0 = 0;
    for (int ci = 0; ci < p.nc; ++ci) {
      const int site_end = ls.color_end[ci];
      for (int site = site0 + lane; site < site_end; site += 32) {
        const int gi = ls.sites[site].x & 0xFFFF;
        derive_rest(cn, ci * p.g + gi, nslot, C, k, n0, p.num_sweeps - n0);
      }
      site0 = site_end;
    }
  }
  const WriteBack wb = write_back(p, c);
  for (int s = lane; s < wb.sites; s += 32) wb.state[wb.rows[s] * C] = sm[s];
}

using Kernel = void (*)(const Params);

template <int KMAX, bool GATHER>
Kernel pick_form(bool count, bool sites) {
  if (sites)
    return count ? gibbs_window_sites_kernel<KMAX, true, GATHER>
                 : gibbs_window_sites_kernel<KMAX, false, GATHER>;
  return count ? gibbs_window_kernel<KMAX, true, GATHER>
               : gibbs_window_kernel<KMAX, false, GATHER>;
}

template <int KMAX>
Kernel pick_bank(bool count, bool sites, bool gather) {
  return gather ? pick_form<KMAX, true>(count, sites) : pick_form<KMAX, false>(count, sites);
}

// The template instance for card bound k, counted or not, in the
// thread-per-chain or the site-parallel form, with or without the gather
// walk; nullptr for a card above 16.
Kernel pick(int k, bool count, bool sites, bool gather) {
  if (k <= 2) return pick_bank<2>(count, sites, gather);
  if (k <= 4) return pick_bank<4>(count, sites, gather);
  if (k <= 8) return pick_bank<8>(count, sites, gather);
  if (k <= 16) return pick_bank<16>(count, sites, gather);
  return nullptr;
}

}  // namespace

// Every entry point returns a cudaError_t (0 = success); 1000 = no kernel
// for this card bound (the wrapper's gate refuses it first).

// out[0..3] = resident blocks per SM for `threads` threads and `smem` bytes
// of dynamic shared memory, registers per thread, bytes of local memory
// per thread (spills), and the most threads a block may have.
extern "C" int gibbs_window_occupancy(int k, int count, int sites, int gather,
                                      int threads, int smem, void* out4) {
  Kernel kern = pick(k, count != 0, sites != 0, gather != 0);
  if (kern == nullptr) return 1000;
  auto* out = static_cast<int*>(out4);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kern, threads, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = attr.maxThreadsPerBlock;
  return cudaSuccess;
}

// One window for n variants x c chains on `stream`; see Params.  `sites`
// picks the site-parallel form (a warp per chain, `threads` a multiple of
// 32) over the thread-per-chain form; `gather` the instances that walk the
// gather bank too.
extern "C" int gibbs_window_launch(
    const void* c_lists, const void* c_tables, const void* c_rows, void* state,
    void* counts, int n, int lw, int tw, int rw, int nc, int g, int k, int nvp,
    int c, int seed, int num_sweeps, int half_point, int cb, int count, int sites,
    int gather, int stage_lists, int stage_tables, int state_words, int threads,
    int smem, void* stream) {
  Kernel kern = pick(k, count != 0, sites != 0, gather != 0);
  if (kern == nullptr) return 1000;
  Params p;
  p.c_lists = static_cast<const int32_t*>(c_lists);
  p.c_tables = static_cast<const float*>(c_tables);
  p.c_rows = static_cast<const int32_t*>(c_rows);
  p.state = static_cast<int32_t*>(state);
  p.counts = static_cast<int32_t*>(counts);
  p.lw = lw; p.tw = tw; p.rw = rw; p.nc = nc; p.g = g; p.k = k; p.nvp = nvp;
  p.c_total = c;
  p.seed = static_cast<uint32_t>(seed);
  p.num_sweeps = num_sweeps; p.half_point = half_point; p.cb = cb;
  p.stage_lists = stage_lists; p.stage_tables = stage_tables;
  p.state_words = state_words;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int per_block = sites ? threads / 32 : threads;  // chains
  dim3 grid((c + per_block - 1) / per_block, n);
  kern<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
