// The table probe of the scatter joins for Hopper: the matches of every S
// key among its slots of an open-addressing table (the Atomic and NoCC
// joins) or of a bucket table (npo, npo_st, htm's scatter route), as one
// int64 count.
//
// Replaces no TPU kernel: the JAX package leaves its probe
// (htm_hashjoin_tpu/ops/probe.py: probe_open_addressing, probe_buckets) to
// XLA's gathers.  It replaces the port's torch formulation of it
// (ops/probe.py: probe_open_addressing_ref, probe_buckets_ref), which stays
// as the plain version and the CPU path: an int64 copy of the hash values,
// then for each of the J slots an int64 add and mask, a gather, a compare,
// a cast of the bool vector to int64 and a sum, some 20 GiB of traffic at
// |S| = 2^27 and J = 4.  The count is that formulation's, exactly:
//     sum over S keys s, j < J of  table[slot_j(h(s))] == s,
// with the slot rule and hash of the build (hash_table.cuh).  Empty slots
// hold 0, so a key 0 counts the empty slots it scans, as the plain version
// does.
//
// What bounds it on an H100: device memory, 8 bytes a key.  Each S key is
// read once, and its J home slots (16 bytes at J = 4) are read about once:
// neighbouring keys share sectors, which L1 and L2 hold, wherever S is
// sorted or the keys of a stretch of S hash near each other.  At 2^27
// sorted keys into the 2^28-slot table that is 1.07 GB, 0.32 ms at 3.35
// TB/s (the benchmark's hash_probe_roofline counts 8|S| bytes).  The design
// reaches for that bound as follows: a grid of as many blocks as the SMs
// hold at once strides over S; a thread reads four keys with one 16-byte
// streaming load (S is read once; a scalar head up to the first 16-byte
// boundary and a ragged tail take one key a thread, so any view of S
// works), and then, slot by slot, the four keys' slots with four
// independent 32-bit read-only loads, so that some 16 loads a thread are in
// flight.  Neighbouring threads hold neighbouring keys, so on a sorted S
// under the identity hash a warp's loads of one slot fall on about 128
// consecutive slots.  Matches are counted in registers, summed over the
// block, and one 64-bit atomic add a block goes into the result, which
// the launcher zeroes on the same stream: no int64 vector and no second
// pass.  Nothing assumes a sorted S or unique table keys; on an unsorted
// S each key's slots are a random sector or two, and the kernel runs at
// the rate of such reads.

#include "banded_common.cuh"
#include "hash_table.cuh"

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                // keys a 16-byte load
// the head and the tail, at most kVec - 1 keys each, take one thread a key
// of the first block
static_assert(kThreads >= 2 * (kVec - 1), "head and tail threads");

// Matches of the keys `key` (S rows row..row + kVec - 1) among their first
// `probes` slots.
__device__ __forceinline__ long long count_vec(const int (&key)[kVec],
                                               long long row,
                                               const int* __restrict__ hvec,
                                               const SlotRule& rule,
                                               int probes,
                                               const int* __restrict__ table) {
    unsigned h[kVec];
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
        h[q] = hash_of(key[q], hvec ? hvec[row + q] : 0, rule);
    }
    long long count = 0;
#pragma unroll 2
    for (int j = 0; j < probes; ++j) {
        int c = 0;
#pragma unroll
        for (int q = 0; q < kVec; ++q) {
            c += __ldg(&table[slot_of(h[q], j, rule)]) == key[q];
        }
        count += c;
    }
    return count;
}

// Adds the matches of the n keys of `skeys` to *matches.  `head` keys come
// before the first 16-byte boundary of `skeys`.
__global__ void __launch_bounds__(kThreads)
hash_probe_kernel(const int* __restrict__ skeys,
                  const int* __restrict__ hvec, SlotRule rule, long long n,
                  int head, int probes, const int* __restrict__ table,
                  unsigned long long* __restrict__ matches) {
    const long long first =
        static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    const long long body = (n - head) / kVec;
    const int4* vec = reinterpret_cast<const int4*>(skeys + head);
    long long count = 0;
    for (long long v = first; v < body; v += stride) {
        const int4 k = __ldcs(vec + v);
        const int key[kVec] = {k.x, k.y, k.z, k.w};
        count += count_vec(key, head + v * kVec, hvec, rule, probes, table);
    }
    // the head and the ragged tail, one key a thread of the first block
    const long long tail = head + body * kVec;
    if (first < head + (n - tail)) {
        const long long row = first < head ? first : tail + first - head;
        const int key = skeys[row];
        const unsigned h = hash_of(key, hvec ? hvec[row] : 0, rule);
        for (int j = 0; j < probes; ++j) {
            count += __ldg(&table[slot_of(h, j, rule)]) == key;
        }
    }
    count = block_sum(count);
    if (threadIdx.x == 0 && count) {
        atomicAdd(matches, static_cast<unsigned long long>(count));
    }
}

}  // namespace

// Counts on `stream` the matches of the n S keys among their first
// `probes` slots of `table` into *matches (zeroed here first), and returns
// the CUDA error code (0 on success; cudaErrorInvalidValue for sizes out of
// range).  hvec: n int32 hash values (kind 0) or null (kind 1 identity, 2
// locality, computed here from mask); stride: 0 for open addressing, else
// the slots of a bucket.  Every slot the rule gives must lie in the table.
// n < 2^31.
extern "C" int htm_hash_probe(const int* skeys, const int* hvec, int kind,
                              long long n, long long mask, int stride,
                              int probes, const int* table,
                              long long* matches, void* stream) {
    if (n < 0 || n >= (1LL << 31) || probes < 0 || mask < 0 ||
        mask >= (1LL << 31) || stride < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(matches, 0, sizeof(long long), st);
    if (err != cudaSuccess || n == 0 || probes == 0) {
        return static_cast<int>(err);
    }
    int device = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
    }
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, hash_probe_kernel, kThreads, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long misaligned =
        (reinterpret_cast<std::uintptr_t>(skeys) / sizeof(int)) % kVec;
    const long long lead = (kVec - misaligned) % kVec;
    const long long head = lead < n ? lead : n;
    const long long chunks = (n - head) / kVec;
    const long long want = (chunks + kThreads - 1) / kThreads;
    const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    const int blocks = static_cast<int>(want < 1 ? 1 : want < cap ? want : cap);
    const SlotRule rule{kind, static_cast<unsigned>(mask), stride};
    return launch(hash_probe_kernel, blocks, kThreads, 0, stream, skeys, hvec,
                  rule, n, static_cast<int>(head), probes, table,
                  reinterpret_cast<unsigned long long*>(matches));
}
