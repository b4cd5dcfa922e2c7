// K7a for Hopper: per-block key-value sort, phase A of the key-value global
// sort.
//
// Replaces the TPU kernel htm_hashjoin_tpu/ops/pallas/join_kernels.py:
// _sort_kv_megakernel (entry global_sort_kv_tiles, pallas_call in
// _sort_kv_tiles_jit).  For each block of B (key, value) pairs it sorts the
// keys ascending, each value moving with its key (linops.bitonic_sort_kv),
// ascending on every block, or, with `alternate`, descending on odd blocks
// (the TPU's "bitonic_alt"), so that each pair of blocks is a bitonic
// sequence for the global sort's next level (K7b).  Equal keys keep their
// input order, on descending blocks too: the result is the stable sort's
// (ops/sort_kv_tiles.py: sort_kv_tiles_ref) bit for bit, where the TPU's
// network leaves ties in its own order.
//
// What bounds it on an H100: device memory sees 16 bytes a pair (one read
// and one write of key and value), 1.28 ms for 2^28 pairs; the sort is
// log2(B)(log2(B)+1)/2 compare-exchange stages, 105 at B = 16384.  The
// first port ran them in shared memory, two loads, two stores and a block
// barrier a stage: 22.86 ms at 2^28, 18x the bound.  The design is K2's
// register tile (sort_tile_regs in banded_common.cuh) on 64-bit elements:
// each key becomes the composite (key << 32) | row, row its index in the
// block (below 2^14), ~key on a descending block, so that ascending order
// of the composites is key order with ties in input order and no value
// rides the network.  A block of P threads holds its B composites in
// registers, E = B / P a thread (16 at B = 16384 with 1024 threads, as
// K2): the bitonic network runs inside each warp's 32E composites with
// shuffles (two a composite a stage) and no block barrier, then the warps'
// runs are merged along the merge path through shared memory, one barrier
// a level (five at B = 16384).  Meanwhile cp.async stages the block's
// values in shared memory; after the sort each thread writes its keys
// (the composites' high words) and gathers its values by their rows, one
// shared read a pair, with 16-byte stores.  So the shuffle rate and the
// merge levels bound it.  Shared memory holds one exchange buffer of
// padded composites (136 KB at B = 16384) and the padded values (72 KB):
// one block an SM, whose loads and stores the other blocks cannot hide.

#include "banded_common.cuh"

namespace {

template <int E, int P>
__global__ void __launch_bounds__(P, 1)
sort_kv_kernel(const int* __restrict__ keys_in, const int* __restrict__ vals_in,
               int* __restrict__ keys_out, int* __restrict__ vals_out,
               int alternate) {
    using Tile = RegTile<E, P, long long>;
    constexpr int kT = Tile::kT;
    extern __shared__ int4 smem4[];
    long long* buf = reinterpret_cast<long long*>(smem4);
    int* vals = reinterpret_cast<int*>(smem4) + Tile::kSmemBytes / 4;
    const long long base = static_cast<long long>(blockIdx.x) * kT;
    const bool descending = alternate && (blockIdx.x & 1);

    cp_async_padded(vals, vals_in + base, kT);
    cp_async_commit();
    const int first = threadIdx.x * E;
    long long x[E];
    {
        int k[E];
        load_blocked(k, keys_in + base);
#pragma unroll
        for (int j = 0; j < E; ++j) {
            const int key = descending ? ~k[j] : k[j];
            x[j] = static_cast<long long>(key) * (1LL << 32) + first + j;
        }
    }
    ShuffleBuf<E, P, long long> sh{buf, 0};
    constexpr int kWarpLevels = ilog2(32 * E);
    bitonic_levels_unrolled<E, P, 1, kWarpLevels>(x, sh);
    merge_levels<E, P>(x, sh, kWarpLevels + 1, Tile::kLogT);
    cp_async_wait<0>();
    __syncthreads();   // every thread's values have landed

    int4* k4 = reinterpret_cast<int4*>(keys_out + base) + threadIdx.x * (E / 4);
    int4* v4 = reinterpret_cast<int4*>(vals_out + base) + threadIdx.x * (E / 4);
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
        int key[4], val[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const long long c = x[4 * q + r];
            const int high = static_cast<int>(c >> 32);
            key[r] = descending ? ~high : high;
            val[r] = at(vals, static_cast<int>(c & 0xffffffffLL));
        }
        k4[q] = make_int4(key[0], key[1], key[2], key[3]);
        v4[q] = make_int4(val[0], val[1], val[2], val[3]);
    }
}

template <int E, int P>
int launch_kv(const int* keys_in, const int* vals_in, int* keys_out,
              int* vals_out, int n_blocks, int alternate, void* stream) {
    constexpr int kSmem = RegTile<E, P, long long>::kSmemBytes +
                          padded_chunk(E * P) * static_cast<int>(sizeof(int));
    static_assert(kSmem <= 232448, "a block's shared memory on Hopper");
    return launch(sort_kv_kernel<E, P>, n_blocks, P, kSmem, stream, keys_in,
                  vals_in, keys_out, vals_out, alternate);
}

}  // namespace

// Launches K7a on `stream` over n_blocks blocks of `block` pairs (one CUDA
// block each) and returns the CUDA error code (0 on success).  keys_in,
// vals_in, keys_out and vals_out are 16-byte aligned device pointers to
// n_blocks * block ints; the outputs may not overlap the inputs.  block is
// 2048, 4096, 8192 or 16384.
extern "C" int htm_sort_kv_tiles(const int* keys_in, const int* vals_in,
                                 int* keys_out, int* vals_out, int n_blocks,
                                 int block, int alternate, void* stream) {
    switch (block) {
        case 2048:
            return launch_kv<4, 512>(keys_in, vals_in, keys_out, vals_out,
                                     n_blocks, alternate, stream);
        case 4096:
            return launch_kv<8, 512>(keys_in, vals_in, keys_out, vals_out,
                                     n_blocks, alternate, stream);
        case 8192:
            return launch_kv<16, 512>(keys_in, vals_in, keys_out, vals_out,
                                      n_blocks, alternate, stream);
        case 16384:
            return launch_kv<16, 1024>(keys_in, vals_in, keys_out, vals_out,
                                       n_blocks, alternate, stream);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}
