// K1 for Hopper: fused per-tile sort + stats + narrow banded match count,
// and the band geometry's prepass.
//
// Replaces the TPU kernel htm_hashjoin_tpu/ops/pallas/join_kernels.py:
// _fused_sort_count_kernel (entry fused_sort_count, pallas_call in
// _fused_sort_count_jit).  For each T-key tile t of the build side R it
//   1. sorts the tile ("bitonic", "blocks" or "oddeven": sort_tile_regs in
//      banded_common.cuh, K2's register sort),
//   2. writes the sorted tile and the stats row [min, max without MAXI32
//      padding, adjacent inversions], and the tile's key sums (MAXI32 left
//      out, int64) before and after the sort, the join's conservation check,
//   3. counts the tile against its S band S[row_off[t]*128, +T + OV) and
//      applies the narrow-band certificate (narrow_count_regs, shared with
//      K5).
// A tile whose band would end past s_len reads no S, counts 0 and gets
// flag 2: the caller's probe side lacks prepare_probe_side's end padding.
//
// What bounds it on an H100: device memory sees 8 bytes a key of R (the
// tile in, the sorted tile out) and (T + 1024)/T x 4 bytes a key of S,
// 0.48 ms for a 2^27 build on its 2^27 probe.  The first port sorted in
// shared memory (two loads, two stores and a block barrier per pair and
// stage) and counted by two binary searches a key over the band: 2.52 ms.
// The design: one block per tile holds the tile in registers, E keys a
// thread (16 at T = 8192), and sorts it as K2 does; then the band is
// copied into the sort's shared exchange buffers, now free (cp.async, 16
// bytes a copy, padded as K4's chunks), while the sorted tile, its stats
// row and its sums are written; the count runs from the sorted registers,
// each thread galloping through the band from its first key's binary
// search (count_chunk, K4's search).  The key sums come from the loaded and
// the sorted registers, so conservation still checks the sort.  Shared
// memory holds the two exchange buffers (about 66 KB at T = 8192), so
// three blocks share an SM, and one block's sort runs beside another's
// count.  Copying the band before the sort, beside the buffers (about
// 107 KB, two blocks an SM), overlapped its bytes with the sort but
// measured slower: the count's dependent shared reads need the third
// block's warps to hide behind.
//
// htm_tile_minmax is the prepass that gives K1 its band offsets: each
// unsorted tile's min and max without MAXI32 (sort-invariant), in one read
// of R (0.16 ms at 2^27) where torch's amin, where and amax read R three
// times and write an R-sized temporary.  It is glue of the port, not a TPU
// kernel (the JAX package leaves it to XLA: pallas_backend._tile_minmax).

#include "banded_common.cuh"

namespace {

template <int E, int P>
__global__ void __launch_bounds__(P, P <= 512 ? 3 : 1)
fused_sort_count_kernel(const int* __restrict__ r, const int* __restrict__ s,
                        long long s_len, const int* __restrict__ row_off,
                        const int* __restrict__ rows_needed,
                        int* __restrict__ sorted_out, int* __restrict__ stats,
                        long long* __restrict__ counts,
                        int* __restrict__ flags,
                        long long* __restrict__ in_sums,
                        long long* __restrict__ out_sums, int method,
                        int passes) {
    extern __shared__ int4 smem4[];
    constexpr int kT = E * P;
    // the sort's exchange rounds, then the padded band
    int* buf = reinterpret_cast<int*>(smem4);
    const int t = blockIdx.x;
    const long long base = static_cast<long long>(t) * kT;

    int x[E];
    load_blocked(x, r + base);
    const long long in_sum = key_sum(x);
    sort_tile_regs<E, P>(x, buf, method, passes);
    __syncthreads();   // the sort's last shared round is read
    const bool in_range = load_band_async(buf, s, s_len, row_off[t], kT);
    store_blocked(sorted_out + base, x);
    tile_stats_row_regs<E, P>(x, method != kBitonic, stats + 3 * t);
    const long long out_sum = key_sum(x);
    cp_async_wait<0>();
    __syncthreads();
    narrow_count_regs<E, P>(x, buf, in_range, rows_needed[t], in_sum,
                            out_sum, counts + t, flags + t, in_sums + t,
                            out_sums + t);
}

template <int E, int P>
int launch_k1(const int* r, const int* s, long long s_len, const int* row_off,
              const int* rows_needed, int* sorted_out, int* stats,
              long long* counts, int* flags, long long* in_sums,
              long long* out_sums, int n_tiles, int method, int passes,
              void* stream) {
    static_assert(padded_chunk(E * P + kOv) * 4 <= RegTile<E, P>::kSmemBytes,
                  "the band fits the exchange buffers");
    const int smem = RegTile<E, P>::kSmemBytes;
    return launch(fused_sort_count_kernel<E, P>, n_tiles, P, smem, stream, r,
                  s, s_len, row_off, rows_needed, sorted_out, stats, counts,
                  flags, in_sums, out_sums, method, passes);
}

constexpr int kMinmaxThreads = 256;

__global__ void __launch_bounds__(kMinmaxThreads)
tile_minmax_kernel(const int* __restrict__ r, int* __restrict__ mins,
                   int* __restrict__ maxs, int tile) {
    const int4* r4 = reinterpret_cast<const int4*>(
        r + static_cast<long long>(blockIdx.x) * tile);
    int mn = kMaxI32, mx = kMinI32;
#pragma unroll 4
    for (int i = threadIdx.x; i < tile / 4; i += kMinmaxThreads) {
        const int4 v = r4[i];
        mn = min(mn, min(min(v.x, v.y), min(v.z, v.w)));
        mx = max(mx, max(max(v.x != kMaxI32 ? v.x : kMinI32,
                             v.y != kMaxI32 ? v.y : kMinI32),
                         max(v.z != kMaxI32 ? v.z : kMinI32,
                             v.w != kMaxI32 ? v.w : kMinI32)));
    }
    mn = block_min(mn);
    mx = block_max(mx);
    if (threadIdx.x == 0) {
        mins[blockIdx.x] = mn;
        maxs[blockIdx.x] = mx;
    }
}

}  // namespace

// Launches K1 on `stream` over n_tiles tiles (one block each) and returns
// the CUDA error code of the launch (0 on success).  All pointers are device
// pointers; r, s and sorted_out must be 16-byte aligned; stats gets 3 ints a
// tile, counts, in_sums and out_sums one int64 a tile, flags one int.  tile
// is 2048, 4096, 8192 or 16384 (K2's register tiles: 4, 8, 16 and 16 keys
// a thread).
extern "C" int htm_fused_sort_count(const int* r, const int* s, long long s_len,
                                    const int* row_off, const int* rows_needed,
                                    int* sorted_out, int* stats,
                                    long long* counts, int* flags,
                                    long long* in_sums, long long* out_sums,
                                    int n_tiles, int tile, int method,
                                    int passes, void* stream) {
    switch (tile) {
        case 2048:
            return launch_k1<4, 512>(r, s, s_len, row_off, rows_needed,
                                     sorted_out, stats, counts, flags, in_sums,
                                     out_sums, n_tiles, method, passes, stream);
        case 4096:
            return launch_k1<8, 512>(r, s, s_len, row_off, rows_needed,
                                     sorted_out, stats, counts, flags, in_sums,
                                     out_sums, n_tiles, method, passes, stream);
        case 8192:
            return launch_k1<16, 512>(r, s, s_len, row_off, rows_needed,
                                      sorted_out, stats, counts, flags,
                                      in_sums, out_sums, n_tiles, method,
                                      passes, stream);
        case 16384:
            return launch_k1<16, 1024>(r, s, s_len, row_off, rows_needed,
                                       sorted_out, stats, counts, flags,
                                       in_sums, out_sums, n_tiles, method,
                                       passes, stream);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

// Launches the prepass on `stream`: mins[t] and maxs[t] = the min and the
// max without MAXI32 (INT32_MIN for a tile of padding only) of the tile
// r[t*tile, +tile), one block a tile.  r is 16-byte aligned; tile is a
// multiple of 4.  Returns the CUDA error code (0 on success).
extern "C" int htm_tile_minmax(const int* r, int* mins, int* maxs,
                               int n_tiles, int tile, void* stream) {
    return launch(tile_minmax_kernel, n_tiles, kMinmaxThreads, 0, stream, r,
                  mins, maxs, tile);
}

extern "C" const char* htm_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
