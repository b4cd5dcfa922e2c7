// K2 for Hopper: streaming per-tile sort with a stats row per tile.
//
// Replaces the TPU kernel htm_hashjoin_tpu/ops/pallas/join_kernels.py:
// _sort_megakernel (entry sort_tiles, pallas_call in _sort_tiles_jit).  For
// each T-key tile t it sorts the tile by method ("bitonic"; "bitonic_alt",
// descending on odd tiles, so that every pair of tiles forms a bitonic
// sequence for the global sort's next level; "blocks"; "oddeven": the
// networks of sort_tile in banded_common.cuh), writes it back, and writes
// the stats row [min, max without MAXI32 padding, adjacent inversions]
// (inversions 0 for the two exact sorters).
//
// What bounds it on an H100: the shared-memory compare-exchange stages
// (log2(T)(log2(T)+1)/2 stages of T/2 exchanges for the bitonic sorters, 91
// at T = 8192) and their barriers; device memory sees only 8 bytes per key
// (one read, one write).  The design is one block per tile with the whole
// tile in dynamic shared memory, 16-byte loads and stores, and a descending
// tile sorted as its complement (~x reverses int32 order), so every stage
// is the same ascending exchange.  Holding no band, it takes tiles up to
// 32768 keys (128 KB), which lets the global sort (K3) start from blocks
// larger than the join tile.  Register-resident stages and a persistent
// multi-tile loop are later work.

#include "banded_common.cuh"

namespace {

__global__ void __launch_bounds__(kMaxThreads)
sort_tiles_kernel(const int* __restrict__ in, int* __restrict__ out,
                  int* __restrict__ stats, int tile, int method, int passes) {
    extern __shared__ int4 smem4[];
    int* v = reinterpret_cast<int*>(smem4);
    const int t = blockIdx.x;
    const long long base = static_cast<long long>(t) * tile;
    const bool descending = method == kBitonicAlt && (t & 1);

    copy_keys(v, in + base, tile);
    __syncthreads();
    if (descending) complement_keys(v, tile);
    sort_tile(v, tile, method, passes);
    if (descending) complement_keys(v, tile);
    copy_keys(out + base, v, tile);
    tile_stats_row(v, tile, method == kBlocks || method == kOddEven,
                   stats + 3 * t);
}

}  // namespace

// Launches K2 on `stream` over n_tiles tiles (one block each) and returns
// the CUDA error code (0 on success).  in and out are 16-byte aligned
// device pointers to n_tiles * tile keys (they may not overlap); stats has
// 3 ints a tile.  tile is a power of two in [2048, 32768].
extern "C" int htm_sort_tiles(const int* in, int* out, int* stats,
                              int n_tiles, int tile, int method, int passes,
                              void* stream) {
    const int threads = tile >= 16384 ? kMaxThreads : kThreads;
    const int smem = tile * static_cast<int>(sizeof(int));
    return launch(sort_tiles_kernel, n_tiles, threads, smem, stream, in, out,
                  stats, tile, method, passes);
}
