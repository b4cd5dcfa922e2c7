// The claim rounds of the scatter builds for Hopper: the Atomic build's
// linear probing, the S-slot bucket builds (npo, npo_st) and the HTM
// build's retry rounds, one launch a round.
//
// Replaces no TPU kernel: the JAX package leaves its claim rounds
// (htm_hashjoin_tpu/ops/insert.py: claim_insert_round, a scatter-max into a
// claim table, then a scatter of the winners) to XLA's scatter.  It
// replaces the port's torch formulation of them (ops/insert.py:
// _insert_rounds), which stays as the plain version and the CPU path:
// about a dozen passes a round over int64 vectors of all n rows, through a
// claim table, with a spare slot a row so that no two writes of
// index_put_ share an index.  The result is that formulation's, bit for
// bit: the table of `size` slots and the pending mask.
//
// Round j (j < rounds) of a build: every pending row attempts its slot s_j
// (open addressing, stride 0: (h + j) & mask; buckets of S slots, stride S:
// h * S + j) if that slot was empty (0) when the round began; among the
// attempters of a slot the highest row wins and writes its key there; the
// others stay pending.  The rows still pending after the last round are
// the spill.  The hash h is computed here (identity: key & mask; locality:
// floor(key / 3) & mask) or handed over as int32 values.
//
// Packed path, for rounds + seeded <= 4 classes, n <= 2^30 rows and no key
// 0 among the rows to place (every cell and CLI default: probeLength 4,
// buckets of 2 and 3, keys 1..N): a scratch table W of `size` 64-bit words,
// 0 meaning empty.  A round-j attempt is one atomicMax
// (atom.global.max.u64) of the word
//     prio << 62 | row << 32 | (uint32) key,   prio = rounds - 1 - j,
// two bits of round class, 30 of row and 32 of key.  Earlier rounds carry
// the higher prio, so a later attempt never displaces an earlier winner:
// an attempt on a slot taken before the round changes nothing, which is
// "attempts only if empty at round start" without a read of the slot
// first.  Within a round the row field decides,
// so the highest row wins, the claim table's rule.  A seeded table (the
// HTM retry's, filled by the optimistic scatter) enters with prio =
// rounds, above every round, and row field 0.  An attempt that finds a
// lower word has landed: it placed unless a higher attempt of the same
// round came later, and that attempt, finding a nonzero lower word, marks
// the round as one that displaced.  Launch k first resolves round k - 1: in
// a round that displaced nothing (each slot one attempter, as for distinct
// keys under the identity hash) every landed row placed; otherwise a landed
// row reads W[s_{k-1}], and its own prio and row there mean that it placed
// (no seeded word and no other round's word can match).  Then launch k
// attempts round k; one more launch resolves the last round, and the
// unpack writes table[s] = the low 32 bits of W[s], coalesced.  A key 0
// would break the word: placed, it has to leave its slot empty (0) for
// later rounds, as the plain version's table does, and row 0's attempt
// with key 0 in the last round packs to the empty word itself.
//
// Claim path, otherwise (budgets above 4 and buckets above 4 slots, which
// no cell runs; more than 2^30 rows; a key 0 to place): two launches a
// round over the int32 table and a 64-bit claim table C zeroed once.  The attempters of round j
// (pending, slot empty in the table) atomicMax(&C[s], (j + 1) << 32 | row);
// then each attempter that finds its own word in C writes its key to the
// table and leaves pending.  A claim of an earlier round lies below every
// claim of this one, so C needs no reset between rounds.  This path
// follows the plain version for every key, 0 included.  The call's
// numbers pick the claim path on the host; a key 0 picks it on the device,
// found by the partition's count pass with no readback: the host enqueues
// both paths' launches, and each launch of the path not taken returns
// after one read (there the claim path's launches stride over the entries
// from a capped grid, so that an idle one costs about 2 us).
//
// What bounds it on an H100: device memory.  The table's own traffic is
// 4|R| + 4T bytes (each key read once, each of the T slots written once;
// the benchmark's hash_build_roofline counts that), 1.61 GB at 2^27 keys
// into 2^28 slots, 0.48 ms at 3.35 TB/s.  Taken in row order, every
// attempt and every resolve read is a random 32-byte sector of a table far
// larger than the 50 MB L2: at 2^27 into 2^28 the rounds took 15.2 of a
// 17.1 ms build that way, the atomics at about the rate of torch's
// scatter_reduce_.  So the rounds never take rows in row order.  Two
// passes first partition the rows to place by their first slot into at
// most 2^8 runs of consecutive slots (a histogram, then a scatter of (key,
// row) entries: a tile groups its entries by run in shared memory,
// reserves its share of each run with one atomic and writes each share as
// one stretch).  Blocks of one entry tile each start in ascending order,
// so the attempts and resolve reads in flight fall in a window of a few
// runs, 8 MiB of W each at 2^28 slots, which L2 holds, and W goes through
// DRAM about once (blocks that stride over tiles drift apart and lose the
// window: round 0 took 6.9 ms that way, 3.1 ms this way).  What the build
// moves then, streamed: the keys twice and the entries written once (1.5
// GiB at 2^27), the entries and a state byte read by each launch with rows
// pending, W zeroed (8T), its touched sectors into L2 and back, the unpack
// (8T read, 4T written).  At 2^27 into 2^28 (NVIDIA H100 80GB HBM3, 700 W)
// a build takes 7.2 ms: partition 1.5, zeroing 0.8, round 0 3.1, its
// resolve 0.2, the three launches that find no row pending 0.08 each, the
// unpack 1.3, the claim path's eight idle launches 0.002 each.  The order of a run's entries changes nothing: a maximum
// does not depend on it, and the spill is written back by row.

#include "banded_common.cuh"

namespace {

constexpr int kThreads = 256;          // the rounds, the fill and the unpack
constexpr int kRows = 4;               // entries a thread, kThreads apart
constexpr int kTile = kThreads * kRows;   // entries a block of the rounds
constexpr int kPartThreads = 512;      // the partition passes
constexpr int kPartRows = 8;           // rows a thread there
constexpr int kTileRows = kPartThreads * kPartRows;
constexpr int kPartBits = 8;           // at most 2^8 runs of slots
constexpr int kParts = 1 << kPartBits;
constexpr int kRankBits = 13;          // a row's rank in its tile's run
constexpr int kClassBits = 2;          // the packed word: round classes,
constexpr int kRowBits = 30;           // row bits, and 32 key bits
constexpr unsigned char kPlaced = 0;   // entry states
constexpr unsigned char kPending = 1;
constexpr unsigned char kLanded = 2;
// aux ints: the histogram, the entry count, the last round with a row
// pending, the rounds that displaced an attempt, the path (0 packed), the
// claim path's last round with a row pending.  The path not taken finds
// its own last round at -1, so that its launches return after the one
// read they make anyway (a second flag read at the start of each block
// cost round 0 a tenth of its time).
constexpr int kAux = kParts + 4 + (1 << kClassBits);
constexpr int kTwoStepBlocks = 2048;   // the claim path's grid, when idle
constexpr int kIdentityHash = 1;       // else 2: locality; 0: handed over
constexpr int kLocalityHash = 2;
static_assert(kTileRows <= 1 << kRankBits, "rank bits");
static_assert(kParts <= kPartThreads && kParts % 32 == 0, "one run a thread");

// How the rows of a build find their slots.
struct SlotRule {
    int kind;         // kIdentityHash, kLocalityHash, or 0: h handed over
    unsigned mask;    // the hash's mask
    int stride;       // 0: open addressing; else the slots of a bucket
};

__device__ __forceinline__ unsigned hash_of(int key, int given,
                                            const SlotRule& r) {
    if (r.kind == kIdentityHash) return static_cast<unsigned>(key) & r.mask;
    if (r.kind == kLocalityHash) {
        int q = key / 3;
        if (key % 3 < 0) --q;          // floor, as torch's // on int32
        return static_cast<unsigned>(q) & r.mask;
    }
    return static_cast<unsigned>(given) & r.mask;
}

__device__ __forceinline__ unsigned slot_of(unsigned h, int j,
                                            const SlotRule& r) {
    return r.stride ? h * static_cast<unsigned>(r.stride) + j
                    : (h + j) & r.mask;
}

// Histogram of the rows to place (todo, or all if null) by the run of
// their first slot (slot >> shift); a key 0 among them sets *two_step.
__global__ void __launch_bounds__(kPartThreads)
partition_count_kernel(const int* __restrict__ keys,
                       const int* __restrict__ hvec, SlotRule rule,
                       const bool* __restrict__ todo, long long n, int shift,
                       int* __restrict__ hist, int* __restrict__ two_step) {
    __shared__ int count[kParts];
    for (int p = threadIdx.x; p < kParts; p += kPartThreads) count[p] = 0;
    __syncthreads();
    const long long first =
        static_cast<long long>(blockIdx.x) * kTileRows + threadIdx.x;
#pragma unroll
    for (int i = 0; i < kPartRows; ++i) {
        const long long row = first + static_cast<long long>(i) * kPartThreads;
        if (row < n && (!todo || todo[row])) {
            const int key = keys[row];
            if (key == 0) *two_step = 1;   // the packed word cannot hold it
            const unsigned h = hash_of(key, hvec ? hvec[row] : 0, rule);
            atomicAdd(&count[slot_of(h, 0, rule) >> shift], 1);
        }
    }
    __syncthreads();
    for (int p = threadIdx.x; p < kParts; p += kPartThreads) {
        if (count[p]) atomicAdd(&hist[p], count[p]);
    }
}

// The runs' first entries (an exclusive scan of the histogram, in place)
// and the number of entries; the last round of the path not taken set to
// -1.  One thread.
__global__ void partition_scan_kernel(int* __restrict__ hist,
                                      int* __restrict__ total,
                                      const int* __restrict__ two_step,
                                      int* __restrict__ live_round,
                                      int* __restrict__ live_claim) {
    int run = 0;
    for (int p = 0; p < kParts; ++p) {
        const int c = hist[p];
        hist[p] = run;
        run += c;
    }
    *total = run;
    *(*two_step ? live_round : live_claim) = -1;
}

// The shared memory of a partition tile: its entries grouped by run.
struct TileSmem {
    int2 entry[kTileRows];
    int given[kTileRows];
    unsigned char run[kTileRows];
    int count[kParts];
    int offset[kParts];                // the run's first entry in the tile
    int base[kParts];                  // the run's first entry reserved
    int warp_total[kParts / 32];
};

// Writes each row to place as the entry (key, row) of its run (and its
// hash value, where handed over).  A tile of kTileRows rows groups its
// entries by run in shared memory, reserves its share of every run with
// one atomic on the run's cursor and writes each run's share as one
// contiguous stretch.
__global__ void __launch_bounds__(kPartThreads)
partition_scatter_kernel(const int* __restrict__ keys,
                         const int* __restrict__ hvec, SlotRule rule,
                         const bool* __restrict__ todo, long long n, int shift,
                         int* __restrict__ cursor, int2* __restrict__ entries,
                         int* __restrict__ hperm) {
    extern __shared__ __align__(16) unsigned char smem_bytes[];
    TileSmem& sm = *reinterpret_cast<TileSmem*>(smem_bytes);
    const int t = threadIdx.x;
    if (t < kParts) sm.count[t] = 0;
    __syncthreads();
    const long long first = static_cast<long long>(blockIdx.x) * kTileRows + t;
    int key[kPartRows];
    int given[kPartRows];
    int place[kPartRows];              // run << kRankBits | rank, or -1
#pragma unroll
    for (int i = 0; i < kPartRows; ++i) {
        const long long row = first + static_cast<long long>(i) * kPartThreads;
        place[i] = -1;
        if (row < n && (!todo || todo[row])) {
            key[i] = keys[row];
            given[i] = hvec ? hvec[row] : 0;
            const int p = slot_of(hash_of(key[i], given[i], rule), 0, rule) >>
                          shift;
            place[i] = p << kRankBits | atomicAdd(&sm.count[p], 1);
        }
    }
    __syncthreads();
    // the runs' offsets in the tile (an exclusive scan of the counts, a
    // warp scan then a scan of the warps' totals) and their reservations
    int c = 0;
    int x = 0;
    if (t < kParts) {
        c = sm.count[t];
        x = c;
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, x, o);
            if (t % 32 >= o) x += y;
        }
        if (t % 32 == 31) sm.warp_total[t / 32] = x;
        sm.base[t] = c ? atomicAdd(&cursor[t], c) : 0;
    }
    __syncthreads();
    if (t < kParts) {
        int before = 0;
        for (int w = 0; w < t / 32; ++w) before += sm.warp_total[w];
        sm.offset[t] = before + x - c;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPartRows; ++i) {
        if (place[i] < 0) continue;
        const int p = place[i] >> kRankBits;
        const int at = sm.offset[p] + (place[i] & ((1 << kRankBits) - 1));
        sm.entry[at] = make_int2(
            key[i], static_cast<int>(first + static_cast<long long>(i) *
                                                 kPartThreads));
        sm.given[at] = given[i];
        sm.run[at] = static_cast<unsigned char>(p);
    }
    __syncthreads();
    const int filled = sm.offset[kParts - 1] + sm.count[kParts - 1];
    for (int i = t; i < filled; i += kPartThreads) {
        const int p = sm.run[i];
        const int at = sm.base[p] + i - sm.offset[p];
        entries[at] = sm.entry[i];
        if (hperm) hperm[at] = sm.given[i];
    }
}

// Records that some row of the block was pending in `round` (*live_round
// = round + 1), so that the launches of later rounds and the spill run
// only while one is.  Every thread of the block calls it.
__device__ __forceinline__ void mark_live(bool any, int* live_round,
                                          int round) {
    if (__syncthreads_or(any) && threadIdx.x == 0) *live_round = round + 1;
}

// Writes W[s] = the seeded table's key with prio `top` where it holds one,
// else 0 (an empty word); the claim path's C[s] = 0 and table[s] = the
// seeded key or 0.  Grid-stride over the size slots.
__global__ void __launch_bounds__(kThreads)
claim_init_kernel(const int* __restrict__ seed, unsigned long long top,
                  const int* __restrict__ two_step,
                  unsigned long long* __restrict__ words,
                  int* __restrict__ table, long long size) {
    const bool claim_path = *two_step;
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    for (long long s = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
         s < size; s += stride) {
        const int key = seed ? seed[s] : 0;
        if (claim_path) {
            table[s] = key;
            words[s] = 0;
        } else {
            words[s] = key ? top << 62 | static_cast<unsigned>(key) : 0;
        }
    }
}

// Packed path, launch `round` (0..rounds) over the entries: resolve round
// - 1, then attempt `round` (none at round == rounds).  An entry's state:
// kPlaced, kPending, or kLanded: pending, and its attempt found a lower
// word in its slot, so that it placed unless a higher attempt of the same
// round came after it.  Such an attempt displaces it and sets
// displaced[round]; in a round that displaced nothing (every slot with one
// attempter, as for distinct keys) every landed entry placed and the
// resolve reads no word.
__global__ void __launch_bounds__(kThreads)
claim_round_kernel(const int2* __restrict__ entries,
                   const int* __restrict__ hperm, SlotRule rule,
                   const int* __restrict__ total, int* live_round,
                   int* displaced, int round, int rounds,
                   unsigned long long* words,
                   unsigned char* __restrict__ state) {
    // no row was pending in round - 1, or the claim path runs this build
    if (*live_round < round) return;
    const long long m = *total;
    const bool check = round > 0 && displaced[round - 1];
    bool any = false;
    const long long first =
        static_cast<long long>(blockIdx.x) * kTile + threadIdx.x;
    unsigned char st[kRows];
    int2 entry[kRows];
    unsigned h[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const long long e = first + i * kThreads;
        st[i] = e < m ? state[e] : kPlaced;
        if (st[i] == kLanded && !check) st[i] = kPlaced;
        if (st[i] != kPlaced) {
            entry[i] = entries[e];
            h[i] = hash_of(entry[i].x, hperm ? hperm[e] : 0, rule);
        }
    }
    if (check) {
        // Round round - 1's words are final: this launch's attempts carry
        // a lower prio and cannot change a word that one of them matches.
        unsigned long long seen[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            if (st[i] == kLanded) {
                seen[i] = __ldcg(&words[slot_of(h[i], round - 1, rule)]);
            }
        }
        const unsigned long long prio = rounds - round;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            if (st[i] == kLanded) {
                st[i] = seen[i] >> 32 == (prio << kRowBits |
                                          static_cast<unsigned>(entry[i].y))
                            ? kPlaced : kPending;
            }
        }
    }
    if (round < rounds) {
        const unsigned long long prio = rounds - 1 - round;
        bool displacing = false;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            if (st[i] != kPlaced) {
                any = true;
                const unsigned long long word =
                    prio << 62 |
                    static_cast<unsigned long long>(entry[i].y) << 32 |
                    static_cast<unsigned>(entry[i].x);
                const unsigned long long old =
                    atomicMax(&words[slot_of(h[i], round, rule)], word);
                st[i] = old < word ? kLanded : kPending;
                displacing |= old < word && old != 0;
            }
        }
        if (displacing) displaced[round] = 1;
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const long long e = first + i * kThreads;
        if (e < m) state[e] = st[i];
    }
    if (round < rounds) mark_live(any, live_round, round);
}

__global__ void __launch_bounds__(kThreads)
claim_unpack_kernel(const unsigned long long* __restrict__ words,
                    const int* __restrict__ two_step,
                    int* __restrict__ table, long long size) {
    // read beside the first words, not before them: on the claim path (a
    // key 0 found on the device) the table is written already, and only
    // the stores are skipped
    const int claim_path = *two_step;
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    for (long long s = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
         s < size; s += stride) {
        const unsigned long long word = words[s];
        if (!claim_path) {
            table[s] = static_cast<int>(static_cast<unsigned>(word));
        }
    }
}

// Claim path, round `round` over the entries: the attempters claim
// (resolve == 0), or the winners write and leave pending (resolve == 1).
// Blocks stride over the entry tiles.
__global__ void __launch_bounds__(kThreads)
claim_two_step_kernel(const int2* __restrict__ entries,
                      const int* __restrict__ hperm, SlotRule rule,
                      const int* __restrict__ total, int* live_claim,
                      int round, int resolve, unsigned long long* claims,
                      int* table, unsigned char* __restrict__ state) {
    // no row pending, or the packed path runs this build
    if (*live_claim < round + resolve) return;
    const long long m = *total;
    const unsigned long long tag = static_cast<unsigned long long>(round + 1)
                                   << 32;
    bool any = false;
    for (long long tile = blockIdx.x; tile * kTile < m; tile += gridDim.x) {
        const long long first = tile * kTile + threadIdx.x;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            const long long e = first + i * kThreads;
            if (e >= m || !state[e]) continue;
            any = true;
            const int2 entry = entries[e];
            const unsigned s = slot_of(
                hash_of(entry.x, hperm ? hperm[e] : 0, rule), round, rule);
            const unsigned long long word =
                tag | static_cast<unsigned>(entry.y);
            if (!resolve) {
                if (table[s] == 0) atomicMax(&claims[s], word);
            } else if (claims[s] == word) {
                table[s] = entry.x;
                state[e] = 0;
            }
        }
    }
    if (!resolve) mark_live(any, live_claim, round);
}

// pending[row] = true for every entry still pending (pending zeroed first).
__global__ void __launch_bounds__(kThreads)
claim_spill_kernel(const int2* __restrict__ entries,
                   const unsigned char* __restrict__ state,
                   const int* __restrict__ total,
                   const int* __restrict__ live_round,
                   const int* __restrict__ live_claim, int rounds,
                   bool* __restrict__ pending) {
    if (rounds > 0 && *live_round < rounds && *live_claim < rounds) {
        return;                                       // every row placed
    }
    const long long m = *total;
    const long long first =
        static_cast<long long>(blockIdx.x) * kTile + threadIdx.x;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const long long e = first + i * kThreads;
        if (e < m && state[e]) pending[entries[e].y] = true;
    }
}

int grid_of(long long items, long long per_block, long long cap) {
    const long long want = (items + per_block - 1) / per_block;
    return static_cast<int>(want < 1 ? 1 : want < cap ? want : cap);
}

long long words_of(long long bytes) { return (bytes + 7) / 8; }

// The scratch, in 8-byte words: W or C (size), the entries (n), the kAux
// ints, the handed-over hash values in run order (n ints, kind 0 only), the
// entries' state (n bytes).
long long scratch_words_for(long long n, long long size, int kind) {
    return size + n + words_of(4LL * kAux) + (kind ? 0 : words_of(4 * n)) +
           words_of(n);
}

}  // namespace

extern "C" long long htm_claim_insert_scratch_words(long long n,
                                                    long long size, int kind) {
    return scratch_words_for(n, size, kind);
}

// Runs a build's claim rounds on `stream` and returns the CUDA error code
// (0 on success; cudaErrorInvalidValue for sizes out of range or too small
// a scratch).  keys: n int32; hvec: n int32 hash values (kind 0) or null
// (kind 1 identity, 2 locality, computed here from mask); stride: 0 for
// open addressing, else the slots of a bucket; todo: n bools, the rows to
// place, or null for all; seed: null, or a table of `size` keys already
// placed (0 = empty), which no round displaces; scratch: scratch_words
// 8-byte words; table: the `size`-slot int32 output; pending: the n-bool
// output, the rows to place that did not.  size <= 2^31, n < 2^31; the
// packed path takes rounds + (seed != null) <= 4 and n <= 2^30, the claim
// path every other build.
extern "C" int htm_claim_insert(const int* keys, const int* hvec, int kind,
                                long long n, long long mask, int stride,
                                int rounds, const bool* todo, const int* seed,
                                long long size, unsigned long long* scratch,
                                long long scratch_words, int* table,
                                bool* pending, void* stream) {
    if (n < 0 || n >= (1LL << 31) || size <= 0 || size > (1LL << 31) ||
        scratch_words < scratch_words_for(n, size, kind)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const SlotRule rule{kind, static_cast<unsigned>(mask), stride};
    const long long head = size + n + words_of(4LL * kAux);
    unsigned long long* words = scratch;
    int2* entries = reinterpret_cast<int2*>(scratch + size);
    int* hist = reinterpret_cast<int*>(scratch + size + n);
    int* total = hist + kParts;
    int* live_round = total + 1;
    int* displaced = live_round + 1;
    int* two_step = displaced + (1 << kClassBits);
    int* live_claim = two_step + 1;
    int* hperm = kind ? nullptr : reinterpret_cast<int*>(scratch + head);
    unsigned char* state = reinterpret_cast<unsigned char*>(
        scratch + head + (kind ? 0 : words_of(4 * n)));
    // runs of 2^shift consecutive slots, at most kParts of them
    int shift = 0;
    while ((size - 1) >> shift >= kParts) ++shift;

    const int fill_blocks = grid_of(size, kThreads, 1 << 20);
    const int part_blocks = grid_of(n, kTileRows, 1LL << 30);
    // one tile a block: blocks start in ascending order, so the entries in
    // flight stay a narrow window (a block striding over tiles drifts)
    const int row_blocks = grid_of(n, kTile, 1LL << 30);
    // the call's numbers allow the packed path; a key 0 may still take the
    // claim path (*two_step, set on the device)
    const bool packed = rounds + (seed ? 1 : 0) <= (1 << kClassBits) &&
                        n <= (1LL << kRowBits);
    // the claim path's grid: one tile a block where the numbers choose it
    // (the window of in-flight slots stays narrow), else capped, so that
    // its launches cost little on the packed path, where they are idle
    const int two_step_blocks =
        packed ? grid_of(n, kTile, kTwoStepBlocks) : row_blocks;
    cudaError_t cerr = cudaMemsetAsync(hist, 0, 4 * kAux, st);
    if (cerr == cudaSuccess && !packed) {
        cerr = cudaMemsetAsync(two_step, 1, 4, st);   // nonzero
    }
    if (cerr == cudaSuccess) cerr = cudaMemsetAsync(pending, 0, n, st);
    if (cerr == cudaSuccess) cerr = cudaMemsetAsync(state, kPending, n, st);
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
    int err = 0;
    if (n > 0) {
        err = launch(partition_count_kernel, part_blocks, kPartThreads, 0,
                     stream, keys, hvec, rule, todo, n, shift, hist,
                     two_step);
        if (err == 0) {
            err = launch(partition_scan_kernel, 1, 1, 0, stream, hist, total,
                         static_cast<const int*>(two_step), live_round,
                         live_claim);
        }
        if (err == 0) {
            err = launch(partition_scatter_kernel, part_blocks, kPartThreads,
                         static_cast<int>(sizeof(TileSmem)), stream, keys,
                         hvec, rule, todo, n, shift, hist, entries, hperm);
        }
    }
    if (err == 0) {
        err = launch(claim_init_kernel, fill_blocks, kThreads, 0, stream, seed,
                     static_cast<unsigned long long>(rounds),
                     static_cast<const int*>(two_step), words, table, size);
    }
    for (int k = 0; packed && err == 0 && n > 0 && k <= rounds; ++k) {
        err = launch(claim_round_kernel, row_blocks, kThreads, 0, stream,
                     static_cast<const int2*>(entries),
                     static_cast<const int*>(hperm), rule,
                     static_cast<const int*>(total), live_round, displaced,
                     k, rounds, words, state);
    }
    if (packed && err == 0) {
        err = launch(claim_unpack_kernel, fill_blocks, kThreads, 0, stream,
                     static_cast<const unsigned long long*>(words),
                     static_cast<const int*>(two_step), table, size);
    }
    for (int j = 0; err == 0 && n > 0 && j < rounds; ++j) {
        for (int resolve = 0; err == 0 && resolve < 2; ++resolve) {
            err = launch(claim_two_step_kernel, two_step_blocks, kThreads, 0,
                         stream, static_cast<const int2*>(entries),
                         static_cast<const int*>(hperm), rule,
                         static_cast<const int*>(total), live_claim, j,
                         resolve, words, table, state);
        }
    }
    if (err == 0 && n > 0) {
        err = launch(claim_spill_kernel, row_blocks, kThreads, 0, stream,
                     static_cast<const int2*>(entries),
                     static_cast<const unsigned char*>(state),
                     static_cast<const int*>(total),
                     static_cast<const int*>(live_round),
                     static_cast<const int*>(live_claim), rounds, pending);
    }
    return err;
}
