// K2 for Hopper: streaming per-tile sort with a stats row per tile.
//
// Replaces the TPU kernel htm_hashjoin_tpu/ops/pallas/join_kernels.py:
// _sort_megakernel (entry sort_tiles, pallas_call in _sort_tiles_jit).  For
// each T-key tile t it sorts the tile by method ("bitonic"; "bitonic_alt",
// descending on odd tiles, so that every pair of tiles forms a bitonic
// sequence for a global sort's next level; "blocks"; "oddeven": the
// functions of sort_tile in banded_common.cuh), writes it back, and writes
// the stats row [min, max without MAXI32 padding, adjacent inversions]
// (inversions 0 for the two exact sorters).
//
// What bounds it on an H100: device memory sees 8 bytes a key (one read,
// one write), 0.32 ms for 2^27 keys; the sort itself is log2(T)(log2(T)+1)/2
// compare-exchange stages for a bitonic network, 91 at T = 8192.  Run in
// shared memory, as the first port of this kernel did, every stage was two
// shared loads and two stores a pair and a block barrier: 4.89 ms at 2^27,
// 15x the bound.  The design (sort_tile_regs in banded_common.cuh) keeps the
// tile in registers, E = T / threads keys a thread (16 at T = 8192 with 512
// threads).  A network stage inside a thread runs in registers, one across
// lanes with __shfl_xor_sync (a shuffle a key; on the card the shuffle
// unit's rate bounds these stages), one across warps through a shared
// round and a barrier.  So the exact sorters run the
// network only up to each warp's 32E keys (levels 1-9 at T = 8192, no
// block barrier), then merge the sorted warp runs level by level along the
// merge path (four shared rounds, about three shared accesses a key each,
// where the network's top four levels cost 20 shuffle stages and 10
// shared rounds).  "blocks" at window 16 (b = 32) sorts its blocks inside
// warps; its half-shifted blocks are aligned by turning the tile by b/2
// through shared memory, and back.  "oddeven" pays one shuffle and one
// barrier a round.  The stats row comes from registers.  A tile that reads
// as MAXI32 throughout (the multipass join's padding) is copied and not
// sorted.  Loads and stores are 16 bytes a thread.  Registers are sized for
// three blocks an SM for the exact sorters (the merges and barriers need
// warps to hide behind) and two for the others (which would spill at
// three).

#include "banded_common.cuh"

namespace {

// kMinBlocks: the blocks an SM the registers are sized for.  The exact
// sorters run fastest at three blocks of 512 threads (their merges and
// barriers need warps to hide behind); the shifted-block and odd-even
// networks at two, where they keep their keys without spilling.
template <int E, int P, int kMinBlocks>
__global__ void __launch_bounds__(P, kMinBlocks)
sort_tiles_kernel(const int* __restrict__ in, int* __restrict__ out,
                  int* __restrict__ stats, int method, int passes) {
    extern __shared__ int4 smem4[];
    constexpr int kT = E * P;
    const int t = blockIdx.x;
    const long long base = static_cast<long long>(t) * kT;
    const bool descending = method == kBitonicAlt && (t & 1);

    int x[E];
    load_blocked(x, in + base);
    bool padding = true;
#pragma unroll
    for (int j = 0; j < E; ++j) padding = padding && x[j] == kMaxI32;
    if (__syncthreads_and(padding)) {   // the same for every thread
        store_blocked(out + base, x);
        if (threadIdx.x == 0) {
            stats[3 * t] = kMaxI32;
            stats[3 * t + 1] = kMinI32;
            stats[3 * t + 2] = 0;
        }
        return;
    }
    if (descending) {
#pragma unroll
        for (int j = 0; j < E; ++j) x[j] = ~x[j];
    }
    sort_tile_regs<E, P>(x, reinterpret_cast<int*>(smem4), method, passes);
    if (descending) {
#pragma unroll
        for (int j = 0; j < E; ++j) x[j] = ~x[j];
    }
    store_blocked(out + base, x);
    tile_stats_row_regs<E, P>(x, method == kBlocks || method == kOddEven,
                              stats + 3 * t);
}

template <int E, int P>
int launch_sort(const int* in, int* out, int* stats, int n_tiles, int method,
                int passes, void* stream) {
    constexpr int kMaxBlocks = P <= 512 ? 3 : 1;
    const bool exact = method == kBitonic || method == kBitonicAlt;
    return launch(exact ? sort_tiles_kernel<E, P, kMaxBlocks>
                        : sort_tiles_kernel<E, P, (kMaxBlocks > 2 ? 2 : 1)>,
                  n_tiles, P, RegTile<E, P>::kSmemBytes, stream, in, out,
                  stats, method, passes);
}

}  // namespace

// Launches K2 on `stream` over n_tiles tiles (one block each) and returns
// the CUDA error code (0 on success).  in and out are 16-byte aligned
// device pointers to n_tiles * tile keys (they may not overlap); stats has
// 3 ints a tile.  tile is a power of two in [2048, 32768].
extern "C" int htm_sort_tiles(const int* in, int* out, int* stats,
                              int n_tiles, int tile, int method, int passes,
                              void* stream) {
    switch (tile) {
        case 2048:
            return launch_sort<4, 512>(in, out, stats, n_tiles, method, passes, stream);
        case 4096:
            return launch_sort<8, 512>(in, out, stats, n_tiles, method, passes, stream);
        case 8192:
            return launch_sort<16, 512>(in, out, stats, n_tiles, method, passes, stream);
        case 16384:
            return launch_sort<16, 1024>(in, out, stats, n_tiles, method, passes, stream);
        case 32768:
            return launch_sort<32, 1024>(in, out, stats, n_tiles, method, passes, stream);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}
