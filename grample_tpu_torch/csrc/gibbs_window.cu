// Whole-window chromatic Gibbs sweep for Hopper (sm_90a).
//
// Replaces grample_tpu/ops/gibbs_pallas.py::_make_kernel (launched by
// _pallas_window), the reference's only TPU kernel, in both of its forms:
// the plain form (local tables of at most 32 rows, an unrolled select
// chain) and the wide-OA form (33 to 256 rows, a counted-loop lookup,
// gibbs_pallas.py:355-367).  Here one code path serves every width: the
// table row is indexed directly, t = tb + (fi * oa + base) * k, so `oa` is
// a run-time argument and only the bytes read per incidence grow with it.
// It computes the same window: for each sweep and color, every site's
// local-table log-conditional summed over its incidences, masked to the
// card, max-shifted exp, the 1e-6 * total floor, and one counter-hashed
// uniform drawn by inverse CDF; if counting, one count per site into half
// (sweep >= half_point).  The plain PyTorch version of the same function
// is grample_tpu_torch/ops/gibbs_torch.py::window_plain.
//
// Design: one thread per (variant, chain).  Variables of one color are
// conditionally independent given the rest, so a thread that updates its
// chain's color rows one after another makes the same chromatic update;
// threads never synchronise.  A block's chain states live in shared
// memory as uint8 [NVp][blockDim.x] for the whole window, so device
// memory sees the state once in and once out.  Neighbour states are read
// from shared memory, tables straight from device memory (every thread of
// a warp reads the same scope/stride words, a broadcast; table rows are
// small and stay in L1), and counts are int32 read-modify-writes into
// [N, 2, K, NSLOT, C]: each thread owns its chain's column, so no atomics
// are needed and neighbouring lanes hit neighbouring words.
//
// What bounds it on the card: the count read-modify-write (about 8 bytes
// of device traffic per counted site), the shared-memory gathers of the
// neighbour states, and one expf per (site, outcome).  Making it fast
// (counts held in registers or shared memory, tables staged in shared
// memory, several chains per thread) is later work.
//
// Wide tables (collapse variants) change the limits, not the code: their
// stacks have more state rows (NVp near 3100 on a 916-var Promedus-shaped
// net against about 1500 for its plain caps), so the uint8 state of a
// 64-thread block fills most of the SM's shared memory and one block runs
// per SM; their scopes reach 9-11 vars, so each incidence costs that many
// shared-memory reads; and a row of a 256-row local table is a scattered
// 8-byte read from tables that no longer fit L2 (44 MB per variant).
// gibbs_window_occupancy reports the blocks per SM that a launch gets.
//
// Float arithmetic uses the _rn intrinsics so that the compiler does not
// contract a*b+c into an FMA: the draw then rounds as the plain version
// and the reference kernel do, and a site differs only where expf's last
// bit moves a uniform across a CDF boundary.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kFloor = 1e-6f;
constexpr float kInv24 = 5.9604644775390625e-8f;  // 2^-24

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

template <int KMAX, bool COUNT>
__global__ void gibbs_window_kernel(
    const int32_t* __restrict__ k_scope,    // [N, NC, G, F, S]
    const int32_t* __restrict__ k_strides,  // [N, NC, G, F, S]
    const float* __restrict__ k_tables,     // [N, NC, G, F, OA, K]
    const uint8_t* __restrict__ k_kmask,    // [N, NC, G, K]
    int32_t* __restrict__ state,            // [N, NVp, C]
    int32_t* __restrict__ counts,           // [N, 2, K, NC*G, C]
    int nc, int g, int f, int s, int oa, int k, int nvp, int c_total,
    uint32_t seed, int num_sweeps, int half_point, int cb) {
  extern __shared__ uint8_t sm[];  // [NVp][blockDim.x]
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int c = blockIdx.x * T + tid;
  if (c >= c_total) return;  // no barrier anywhere: early exit is safe

  const size_t C = static_cast<size_t>(c_total);
  const int nslot = nc * g;
  int32_t* st = state + static_cast<size_t>(n) * nvp * C + c;
  for (int r = 0; r < nvp; ++r) sm[r * T + tid] = static_cast<uint8_t>(st[r * C]);

  const uint32_t lane_mix = static_cast<uint32_t>(c % cb) * 0x85EBCA6Bu;
  const uint32_t cell = seed + 65537u * static_cast<uint32_t>(n) +
                        257u * static_cast<uint32_t>(c / cb);
  const size_t fs = static_cast<size_t>(f) * s;

  for (int si = 0; si < num_sweeps; ++si) {
    const int hsel = si >= half_point ? 1 : 0;
    for (int ci = 0; ci < nc; ++ci) {
      const uint32_t counter =
          cell + 2654435761u * (static_cast<uint32_t>(si) * static_cast<uint32_t>(nc) +
                                static_cast<uint32_t>(ci));
      for (int gi = 0; gi < g; ++gi) {
        const size_t row = (static_cast<size_t>(n) * nc + ci) * g + gi;
        const int32_t* sc = k_scope + row * fs;
        const int32_t* sd = k_strides + row * fs;
        const float* tb = k_tables + row * f * oa * k;
        float lg[KMAX];
#pragma unroll
        for (int kk = 0; kk < KMAX; ++kk) lg[kk] = 0.0f;
        for (int fi = 0; fi < f; ++fi) {
          int base = 0;
          for (int q = 0; q < s; ++q)
            base += static_cast<int>(sm[sc[fi * s + q] * T + tid]) * sd[fi * s + q];
          const float* t = tb + (static_cast<size_t>(fi) * oa + base) * k;
#pragma unroll
          for (int kk = 0; kk < KMAX; ++kk)
            if (kk < k) lg[kk] = __fadd_rn(lg[kk], t[kk]);
        }
        const uint8_t* mk = k_kmask + row * k;
        float mx = kNeg;
#pragma unroll
        for (int kk = 0; kk < KMAX; ++kk) {
          if (kk < k) {
            lg[kk] = mk[kk] ? lg[kk] : kNeg;
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
            lg[kk] = __fmul_rn(__fadd_rn(lg[kk], floor_add), mk[kk] ? 1.0f : 0.0f);
            tot2 = kk == 0 ? lg[kk] : __fadd_rn(tot2, lg[kk]);
          }
        }
        const float u = __fmul_rn(hash_uniform(static_cast<uint32_t>(gi), lane_mix, counter), tot2);
        float run = 0.0f;
        int newv = 0;
#pragma unroll
        for (int kk = 0; kk < KMAX - 1; ++kk) {
          if (kk < k - 1) {
            run = kk == 0 ? lg[kk] : __fadd_rn(run, lg[kk]);
            newv += u > run ? 1 : 0;
          }
        }
        const int r = ci * g + gi;
        sm[r * T + tid] = static_cast<uint8_t>(newv);
        if (COUNT) {
          counts[((static_cast<size_t>(n) * 2 + hsel) * k + newv) * nslot * C +
                 static_cast<size_t>(r) * C + c] += 1;
        }
      }
    }
  }
  for (int r = 0; r < nslot; ++r) st[r * C] = sm[r * T + tid];
}

template <int KMAX, bool COUNT>
cudaError_t launch(const int32_t* k_scope, const int32_t* k_strides,
                   const float* k_tables, const uint8_t* k_kmask, int32_t* state,
                   int32_t* counts, int n, int nc, int g, int f, int s, int oa,
                   int k, int nvp, int c, uint32_t seed, int num_sweeps,
                   int half_point, int cb, int threads, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(nvp) * threads;
  auto kern = gibbs_window_kernel<KMAX, COUNT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((c + threads - 1) / threads, n);
  kern<<<grid, threads, smem, stream>>>(k_scope, k_strides, k_tables, k_kmask,
                                        state, counts, nc, g, f, s, oa, k, nvp,
                                        c, seed, num_sweeps, half_point, cb);
  return cudaGetLastError();
}

template <int KMAX>
cudaError_t launch_k(bool count, const int32_t* k_scope, const int32_t* k_strides,
                     const float* k_tables, const uint8_t* k_kmask, int32_t* state,
                     int32_t* counts, int n, int nc, int g, int f, int s, int oa,
                     int k, int nvp, int c, uint32_t seed, int num_sweeps,
                     int half_point, int cb, int threads, cudaStream_t stream) {
  if (count)
    return launch<KMAX, true>(k_scope, k_strides, k_tables, k_kmask, state, counts,
                              n, nc, g, f, s, oa, k, nvp, c, seed, num_sweeps,
                              half_point, cb, threads, stream);
  return launch<KMAX, false>(k_scope, k_strides, k_tables, k_kmask, state, counts,
                             n, nc, g, f, s, oa, k, nvp, c, seed, num_sweeps,
                             half_point, cb, threads, stream);
}

template <int KMAX, bool COUNT>
cudaError_t occupancy(int threads, size_t smem, int* blocks) {
  auto kern = gibbs_window_kernel<KMAX, COUNT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, threads, smem);
}

template <int KMAX>
cudaError_t occupancy_k(bool count, int threads, size_t smem, int* blocks) {
  return count ? occupancy<KMAX, true>(threads, smem, blocks)
               : occupancy<KMAX, false>(threads, smem, blocks);
}

}  // namespace

// Resident blocks per SM for a launch of `threads` threads over `nvp` state
// rows at card bound k (the same template instance gibbs_window_launch
// picks).  Returns a cudaError_t; 1000 = card above 16.
extern "C" int gibbs_window_occupancy(int k, int count, int threads, int nvp,
                                      void* blocks) {
  const size_t smem = static_cast<size_t>(nvp) * threads;
  auto* out = static_cast<int*>(blocks);
  const bool cnt = count != 0;
  if (k <= 2) return occupancy_k<2>(cnt, threads, smem, out);
  if (k <= 4) return occupancy_k<4>(cnt, threads, smem, out);
  if (k <= 8) return occupancy_k<8>(cnt, threads, smem, out);
  if (k <= 16) return occupancy_k<16>(cnt, threads, smem, out);
  return 1000;
}

// C entry point, bound with ctypes.  Returns a cudaError_t (0 = success);
// 1000 = card above 16 (the wrapper's gate refuses it first).
extern "C" int gibbs_window_launch(
    const void* k_scope, const void* k_strides, const void* k_tables,
    const void* k_kmask, void* state, void* counts, int n, int nc, int g, int f,
    int s, int oa, int k, int nvp, int c, int seed, int num_sweeps,
    int half_point, int cb, int count, int threads, void* stream) {
  const auto* sc = static_cast<const int32_t*>(k_scope);
  const auto* sd = static_cast<const int32_t*>(k_strides);
  const auto* tb = static_cast<const float*>(k_tables);
  const auto* km = static_cast<const uint8_t*>(k_kmask);
  auto* st = static_cast<int32_t*>(state);
  auto* cn = static_cast<int32_t*>(counts);
  const auto useed = static_cast<uint32_t>(seed);
  auto strm = static_cast<cudaStream_t>(stream);
  const bool cnt = count != 0;
  if (k <= 2)
    return launch_k<2>(cnt, sc, sd, tb, km, st, cn, n, nc, g, f, s, oa, k, nvp, c,
                       useed, num_sweeps, half_point, cb, threads, strm);
  if (k <= 4)
    return launch_k<4>(cnt, sc, sd, tb, km, st, cn, n, nc, g, f, s, oa, k, nvp, c,
                       useed, num_sweeps, half_point, cb, threads, strm);
  if (k <= 8)
    return launch_k<8>(cnt, sc, sd, tb, km, st, cn, n, nc, g, f, s, oa, k, nvp, c,
                       useed, num_sweeps, half_point, cb, threads, strm);
  if (k <= 16)
    return launch_k<16>(cnt, sc, sd, tb, km, st, cn, n, nc, g, f, s, oa, k, nvp, c,
                        useed, num_sweeps, half_point, cb, threads, strm);
  return 1000;
}
