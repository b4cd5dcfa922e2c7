"""The port's hash-table builds and the joins on them (nocc, atomic, htm's
scatter build, npo, npo_st) and sortmerge, against the JAX package on the
same numpy inputs.

Module tests: ``ops/hashing.py``, ``ops/insert.py`` and the new
``ops/probe.py`` functions against JAX's, at 2^12-2^14 keys, on unique,
duplicate and full-range keys.  The whole table, the pending and failed
masks and the per-chunk failure fractions (float32) are equal: the winner
of a slot is the highest row on both sides (JAX's CPU scatter keeps the
last row, the port picks it by ``amax``).  Hence also the occupancy mask,
the pending count, ``table_sum + masked_sum(pending)`` and the probe
counts.  The port's spill is JAX's, compacted.

Join tests: every line field that the configuration fixes is equal
(``EQUAL`` below, the key set, and the fields of the scatter builds), at
tolerance 0: integers, and float32 fractions computed the same way.  The
JAX side runs with ``backend="xla"`` where the port takes a scatter build
and with ``backend="pallas"`` (interpret mode) where it takes the engine.
``totalMatches`` must also equal an exact numpy count, except for nocc,
whose losses are its semantics: there outputSum <= inputSum and
totalMatches <= the exact count.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htm_hashjoin_tpu import config as jconfig
from htm_hashjoin_tpu.joins import DISPATCH as JDISPATCH
from htm_hashjoin_tpu.ops import hashing as jhashing
from htm_hashjoin_tpu.ops import insert as jinsert
from htm_hashjoin_tpu.ops import probe as jprobe
from htm_hashjoin_tpu.ops import sortops as jsortops
from htm_hashjoin_tpu.relation import Relation as JRelation
from htm_hashjoin_tpu_torch.config import Algo, Distribution, JoinConfig
from htm_hashjoin_tpu_torch.constants import MAXI32
from htm_hashjoin_tpu_torch.data.generators import build_relations
from htm_hashjoin_tpu_torch.joins import DISPATCH
from htm_hashjoin_tpu_torch.joins import common
from htm_hashjoin_tpu_torch.joins.banded_backend import banded_join_pipelined
from htm_hashjoin_tpu_torch.ops import hashing, insert, probe, sortops
from htm_hashjoin_tpu_torch.relation import Relation, keys_from_numpy
from htm_hashjoin_tpu_torch.utils.metrics import PORT_ONLY_FIELDS
from htm_hashjoin_tpu_torch.utils.timing import PhaseTimer
from htm_hashjoin_tpu_torch.utils.validate import reference_match_count

INT32_MIN = -(1 << 31)


def keys_of(kind, n, seed=0):
    """Seeded numpy keys: a permutation of 1..n, duplicates, or draws from
    the full positive int32 range (no 0: it marks an empty slot)."""
    rng = np.random.default_rng(seed)
    if kind == "unique":
        return (rng.permutation(n) + 1).astype(np.int32)
    if kind == "duplicates":
        return rng.integers(1, n // 4, n).astype(np.int32)
    if kind == "full_range":
        return rng.integers(1, MAXI32, n).astype(np.int32)
    raise KeyError(kind)


def both(a):
    """(torch tensor, jax array) of one numpy array."""
    return torch.from_numpy(np.array(a)), jnp.asarray(a)


def eq(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    return got.numpy().dtype == want.dtype and \
        np.array_equal(got.numpy(), want)


KINDS = ["unique", "duplicates", "full_range"]
# (kind, JAX's unique_keys): JAX's claim-free rounds need distinct keys;
# the port runs claim rounds always, which give the same table there
BUILDS = [("unique", True), ("unique", False), ("duplicates", False),
          ("full_range", False)]


# ---------------------------------------------------------------------------
# ops/hashing.py
# ---------------------------------------------------------------------------

EDGE_KEYS = np.array([0, 1, 2, 3, -1, -2, -3, INT32_MIN, INT32_MIN + 1,
                      MAXI32, MAXI32 - 1, 0x12345678, -0x12345678],
                     np.int32)


@pytest.mark.parametrize("kind", ["edges"] + KINDS)
def test_hashes_match_jax(kind):
    keys = EDGE_KEYS if kind == "edges" else keys_of(kind, 1 << 12)
    if kind == "full_range":
        keys = keys - np.int32(1 << 30)        # negatives too
    t, j = both(keys)
    assert eq(hashing.murmur32(t), jhashing.murmur32(j))
    for mask in (1, 1023, (1 << 28) - 1):
        assert eq(hashing.locality_hash(t, mask),
                  jhashing.locality_hash(j, mask))
        assert eq(hashing.identity_hash(t, mask),
                  jhashing.identity_hash(j, mask))
    for shift, bits in ((0, 7), (7, 7), (24, 7)):
        for hashed in (False, True):
            assert eq(hashing.radix_digit(t, shift, bits, hashed=hashed),
                      jhashing.radix_digit(j, shift, bits, hashed=hashed))


# ---------------------------------------------------------------------------
# ops/insert.py and ops/probe.py
# ---------------------------------------------------------------------------

def assert_build_equal(got, want, keys):
    """Table, occupancy, pending mask and count, and the conservation sum
    (table_sum + masked_sum(pending)) equal JAX's."""
    (table, pending), (jtable, jpending) = got, want
    assert eq(table, jtable)
    assert eq(table != insert.EMPTY, np.asarray(jtable) != 0)
    assert eq(pending, jpending)
    assert int(pending.sum()) == int(np.asarray(jpending).sum())
    t, j = both(keys)
    assert int(probe.table_sum(table) + probe.masked_sum(t, pending)) == \
        int(jprobe.table_sum(jtable) + jprobe.masked_sum(j, jpending))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1 << 12, 1 << 14])
def test_nocc_build_and_scatter_match_jax(kind, n):
    keys = keys_of(kind, n, seed=1)
    t, j = both(keys)
    for table_size, probe_length in ((2 * n, 4), (n // 2, 3), (8, 100)):
        got = insert.nocc_build(t, table_size, probe_length,
                                hashing.identity_hash)
        want = jinsert.nocc_build(j, table_size, probe_length,
                                  jhashing.identity_hash)
        assert_build_equal(got, want, keys)
        # the lost-update semantics: nothing pending is in the table twice
        assert int(probe.table_sum(got[0]) + probe.masked_sum(t, got[1])) \
            <= int(t.sum(dtype=torch.int64))
    # JAX's nocc_scatter is the one-round build
    assert eq(insert.nocc_build(t, 2 * n, 1, hashing.identity_hash)[0],
              jinsert.nocc_scatter(j, 2 * n, jhashing.identity_hash))


@pytest.mark.parametrize("kind", KINDS)
def test_claim_insert_round_matches_jax(kind):
    """One CAS round on a table half filled by an earlier round, with a
    claim table holding that round's claims; several pending keys share
    slots.  The port's tables carry the spare slot."""
    n, size = 1 << 12, 1 << 11
    keys = keys_of(kind, n, seed=2)
    t, j = both(keys)
    slot0 = (keys.astype(np.int64) * 7) % size
    slot1 = (slot0 + 1) % size
    idx_t, idx_j = both(np.arange(n, dtype=np.int32))
    pend_t, pend_j = both(np.ones(n, bool))
    table = insert._table(size, n, "cpu")
    claim = insert._claims(size, n, "cpu")
    jtable = jnp.zeros((size,), jnp.int32)
    jclaim = jnp.full((size,), -1, jnp.int32)
    for slot in (slot0, slot1):
        st, sj = both(slot)
        table, claim, pend_t = insert.claim_insert_round(
            table, claim, t, st, pend_t, idx_t)
        jtable, jclaim, pend_j = jinsert.claim_insert_round(
            jtable, jclaim, j, sj, pend_j, idx_j)
        assert eq(table[:size], jtable)
        assert eq(claim[:size], jclaim)
        assert eq(pend_t, pend_j)


@pytest.mark.parametrize("kind,unique", BUILDS)
def test_open_addressing_build_matches_jax(kind, unique):
    """On CPU tensors the torch claim rounds run (the claim kernel's plain
    version): no kernel build counted, n rows a round in ``CLAIM_ROWS``."""
    n = 1 << 13
    keys = keys_of(kind, n, seed=3)
    t, j = both(keys)
    for table_size, probe_length in ((2 * n, 4), (n, 2), (n // 2, 8)):
        launches, rows = insert.LAUNCHES, insert.CLAIM_ROWS
        got = insert.open_addressing_build(t, table_size, probe_length,
                                           hashing.identity_hash)
        assert insert.LAUNCHES == launches
        assert insert.CLAIM_ROWS - rows == probe_length * n
        want = jinsert.open_addressing_build(j, table_size, probe_length,
                                             jhashing.identity_hash,
                                             unique_keys=unique)
        assert_build_equal(got, want, keys)


@pytest.mark.parametrize("kind,unique", BUILDS)
@pytest.mark.parametrize("slots", [2, 3])
def test_bucket_build_matches_jax(kind, unique, slots):
    """npo's 2-slot buckets take keys k and k + num_buckets into one slot
    in one round: the highest row wins on both sides.  The second build,
    into a quarter of the buckets, overflows most keys.  The torch rounds
    run on CPU tensors: no kernel build, n rows a round in ``CLAIM_ROWS``."""
    n = 1 << 13
    keys = keys_of(kind, n, seed=4)
    t, j = both(keys)
    nb = n // 2
    launches, rows = insert.LAUNCHES, insert.CLAIM_ROWS
    got = insert.bucket_build(t, nb, slots, hashing.identity_hash)
    assert insert.LAUNCHES == launches
    assert insert.CLAIM_ROWS - rows == slots * n
    want = jinsert.bucket_build(j, nb, slots, jhashing.identity_hash,
                                unique_keys=unique)
    assert_build_equal(got, want, keys)
    got = insert.bucket_build(t, nb // 4, slots, hashing.locality_hash)
    want = jinsert.bucket_build(j, nb // 4, slots, jhashing.locality_hash,
                                unique_keys=unique)
    assert_build_equal(got, want, keys)
    assert int(got[1].sum()) > n // 2


@pytest.mark.parametrize("retry", [True, False])
@pytest.mark.parametrize("kind,unique", BUILDS + [("wrapped", True),
                                                  ("wrapped", False)])
def test_htm_optimistic_build_matches_jax(kind, unique, retry):
    """Table, pending and failed masks, and the per-chunk failure fractions
    (float32, exact), on dense keys, duplicates, full-range keys, and
    unique keys that wrap the buckets (k and k + 3 * num_buckets share a
    slot).  On CPU tensors the retry's torch rounds run: no kernel build;
    ``CLAIM_ROWS`` counts the scatter's n rows and n a retry round."""
    n = 1 << 13
    keys = (keys_of("unique", n, seed=5) * 3 if kind == "wrapped"
            else keys_of(kind, n, seed=5))
    t, j = both(keys)
    nb = common.htm_num_buckets(n)
    launches, rows = insert.LAUNCHES, insert.CLAIM_ROWS
    got = insert.htm_optimistic_build(t, nb, retry=retry)
    assert insert.LAUNCHES == launches
    assert insert.CLAIM_ROWS - rows == (4 if retry else 1) * n
    want = jinsert.htm_optimistic_build(j, nb, retry=retry,
                                        unique_keys=unique)
    assert eq(got.table, want.table)
    assert eq(got.pending, want.pending)
    assert eq(got.failed_optimistic, want.failed_optimistic)
    assert int(got.failed_optimistic.sum()) == \
        int(np.asarray(want.failed_optimistic).sum())
    if kind != "unique":
        assert int(got.failed_optimistic.sum()) > 0
    for chunk in (16384, 1000, 7):
        assert eq(insert.chunk_failure_fractions(got.failed_optimistic,
                                                 chunk),
                  jinsert.chunk_failure_fractions(want.failed_optimistic,
                                                  chunk))


@pytest.mark.parametrize("kind", KINDS)
def test_spill_is_the_jax_spill_compacted(kind):
    n = 1 << 12
    keys = keys_of(kind, n, seed=6)
    pending = np.random.default_rng(7).random(n) < 0.1
    spill, count = insert.spill_sorted(torch.from_numpy(keys),
                                       torch.from_numpy(pending))
    jspill, jcount = jinsert.spill_sorted(jnp.asarray(keys),
                                          jnp.asarray(pending))
    assert count == int(jcount) == int(pending.sum())
    assert eq(spill, np.asarray(jspill)[:count])
    assert (np.asarray(jspill)[count:] == MAXI32).all()


@pytest.mark.parametrize("kind", KINDS)
def test_probes_match_jax(kind):
    """The bucket and open-addressing probes count the same matches of the
    same tables, through the plain version on CPU tensors (no kernel
    launch); the sorted merge count equals JAX's and numpy's."""
    n = 1 << 13
    launches = probe.LAUNCHES
    keys = keys_of(kind, n, seed=8)
    probe_keys = np.concatenate([keys[::3], keys_of("unique", n, seed=9)])
    t, j = both(keys)
    st, sj = both(probe_keys)
    table, _ = insert.open_addressing_build(t, 2 * n, 4,
                                            hashing.identity_hash)
    jtable, _ = jinsert.open_addressing_build(j, 2 * n, 4,
                                              jhashing.identity_hash)
    for budget in (1, 4, 9):
        assert int(probe.probe_open_addressing(table, st, budget,
                                               hashing.identity_hash)) == \
            int(jprobe.probe_open_addressing(jtable, sj, budget,
                                             jhashing.identity_hash))
    for slots, hash_fn, jhash_fn in ((2, hashing.identity_hash,
                                      jhashing.identity_hash),
                                     (3, hashing.locality_hash,
                                      jhashing.locality_hash)):
        table, _ = insert.bucket_build(t, n // 2, slots, hash_fn)
        jtable, _ = jinsert.bucket_build(j, n // 2, slots, jhash_fn)
        assert int(probe.probe_buckets(table, st, slots, hash_fn)) == \
            int(jprobe.probe_buckets(jtable, sj, slots, jhash_fn))
    assert probe.LAUNCHES == launches
    got = int(sortops.merge_count(torch.sort(t).values,
                                  torch.sort(st).values))
    assert got == int(jsortops.merge_count(jnp.sort(j), jnp.sort(sj))) == \
        reference_match_count(keys, probe_keys)
    # the spill's probe: a sorted build side, the probe side as it comes
    assert int(sortops.merge_count(torch.sort(t).values, st)) == got


def murmur_hash(keys, mask):
    return hashing.murmur32(keys) & mask


def jmurmur_hash(keys, mask):
    return jhashing.murmur32(keys) & mask


HASHES = {"identity": (hashing.identity_hash, jhashing.identity_hash),
          "locality": (hashing.locality_hash, jhashing.locality_hash),
          "murmur": (murmur_hash, jmurmur_hash)}


@pytest.mark.parametrize("addressing,size,budget,hash_name", [
    ("open", 1 << 10, 1, "identity"), ("open", 1 << 10, 4, "identity"),
    ("open", 1 << 10, 6, "identity"), ("open", 16, 40, "identity"),
    ("open", 1, 4, "identity"), ("open", 2, 4, "identity"),
    ("open", 1 << 10, 4, "locality"), ("open", 1 << 10, 4, "murmur"),
    ("buckets", 1 << 10, 2, "identity"), ("buckets", 3 << 9, 3, "locality"),
    ("buckets", 1 << 10, 2, "murmur"), ("buckets", 3, 3, "locality")])
def test_probe_edge_keys_match_jax(addressing, size, budget, hash_name):
    """The table probe's plain version (the kernel's definition, on CPU
    tensors: no launch) against JAX's on the cases the card tests hold the
    kernel to: budgets 1, 4 and 6, one above the table size, tables of 1
    and 2 slots, buckets of 2 and 3 slots, each hash kind; tables with
    empty slots (0) probed by key 0, INT32_MIN, INT32_MAX and negatives."""
    rng = np.random.default_rng(size + budget)
    alphabet = np.concatenate([np.arange(-8, 9, dtype=np.int32),
                               [INT32_MIN, MAXI32]]).astype(np.int32)
    table_np = rng.choice(alphabet, size).astype(np.int32)
    table_np[rng.random(size) < 0.3] = 0
    s_np = rng.choice(alphabet, 999).astype(np.int32)
    (table, jtable), (st, sj) = both(table_np), both(s_np)
    hash_fn, jhash_fn = HASHES[hash_name]
    launches = probe.LAUNCHES
    if addressing == "open":
        got = probe.probe_open_addressing(table, st, budget, hash_fn)
        want = jprobe.probe_open_addressing(jtable, sj, budget, jhash_fn)
    else:
        got = probe.probe_buckets(table, st, budget, hash_fn)
        want = jprobe.probe_buckets(jtable, sj, budget, jhash_fn)
    assert probe.LAUNCHES == launches
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == int(want) > 0


def test_probe_takes_cpu_or_cuda_tensors():
    """The table probe runs the plain version on CPU tensors, the kernel
    on CUDA tensors, and raises on any other device: nothing falls back."""
    table = torch.zeros(8, dtype=torch.int32, device="meta")
    skeys = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        probe.probe_open_addressing(table, skeys, 4, hashing.identity_hash)
    with pytest.raises(ValueError, match="cpu or cuda"):
        probe.probe_buckets(table, skeys, 2, hashing.identity_hash)


def test_kernel_hash_kinds():
    """The identity and locality hashes are computed in the scatter-table
    kernels (kinds 1 and 2); any other hash is handed over as int32."""
    keys = torch.tensor([5, -7, 0, MAXI32], dtype=torch.int32)
    assert hashing.kernel_hash(keys, hashing.identity_hash, 7) == (1, None)
    assert hashing.kernel_hash(keys, hashing.locality_hash, 7) == (2, None)
    kind, h = hashing.kernel_hash(keys, murmur_hash, 7)
    assert kind == 0 and h.dtype == torch.int32 and h.is_contiguous()
    assert torch.equal(h, murmur_hash(keys, 7))


def test_spill_probe_counts_int32_max_exactly():
    """Reference fault 8: JAX's spill is R-sized, padded with INT32_MAX, so
    an S key equal to INT32_MAX matches every tuple that did not spill.
    The port's compacted spill counts it exactly."""
    n = 1 << 12
    keys = keys_of("duplicates", n, seed=10)
    skeys = np.concatenate([np.arange(1, n + 1, dtype=np.int32),
                            np.full(3, MAXI32, np.int32)])
    t, j = both(keys)
    st, sj = both(skeys)
    _, pending = insert.open_addressing_build(t, 2 * n, 4,
                                              hashing.identity_hash)
    count = int(pending.sum())
    assert 0 < count < n
    spill = common.SpillState(t, pending, PhaseTimer())
    assert spill.count == count
    assert spill.probe_count(st, PhaseTimer()) == \
        reference_match_count(keys[pending.numpy()], skeys)
    jspill, _ = jinsert.spill_sorted(j, jnp.asarray(pending.numpy()))
    assert int(jprobe.probe_sorted(jspill, sj)) == \
        spill.probe_count(st, PhaseTimer()) + 3 * (n - count)


# ---------------------------------------------------------------------------
# The joins
# ---------------------------------------------------------------------------

N = 1 << 13

EQUAL = ("totalMatches", "inputSum", "outputSum", "backend", "conflicts",
         "conflictCount", "failedTransactions", "totalOverflows",
         "chunkFailureFractions", "maxChunkFailureFraction",
         "failureCauseDisplacement", "failureCauseDuplicateAlias",
         "failureCauseBandOverflow", "adaptiveTransactionSizeFinal",
         "failedTransactionPercentage", "totalFailedPercentage",
         "transactionSize", "probeLength", "algo", "rSize")

DISTS = {
    "sorted": dict(data_distr=Distribution.SORTED),
    "shuffle": dict(data_distr=Distribution.SHUFFLE),
    "local_shuffle": dict(data_distr=Distribution.LOCAL_SHUFFLE),
    "uniform": dict(data_distr=Distribution.UNIFORM, distinct_keys=N // 4),
    "zipf": dict(data_distr=Distribution.ZIPF, distinct_keys=N // 4),
    "random": dict(data_distr=Distribution.RANDOM),
    "pk_fk": dict(data_distr=Distribution.PK, s_distr=Distribution.FK,
                  s_size=2 * N),
}
# unique R under a skewed S of 2^18 keys: the port's engine flags R's one
# 8192-key tile (its band passes 16 chunks) where JAX's 65536-key tile
# flags none, so only the lines that do not report flagged tiles compare
SKEWED_S = {"pk_zipf": dict(data_distr=Distribution.PK,
                            s_distr=Distribution.ZIPF, zipf_param=1.0,
                            s_size=32 * N)}
ALL_DISTS = {**DISTS, **SKEWED_S}


def jax_cfg(cfg: JoinConfig, backend: str):
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(JoinConfig)}
    fields["algo"] = jconfig.Algo(cfg.algo.value)
    fields["data_distr"] = jconfig.Distribution(cfg.data_distr.value)
    if cfg.s_distr is not None:
        fields["s_distr"] = jconfig.Distribution(cfg.s_distr.value)
    fields["backend"] = backend
    return jconfig.JoinConfig(**fields)


@functools.lru_cache(maxsize=None)
def relations(dist: str, probing: bool):
    """Numpy keys of the port's seeded generators (one set per case)."""
    cfg = JoinConfig(r_size=N, seed=11, enable_probe=probing,
                     **ALL_DISTS[dist])
    r, s = build_relations(cfg)
    return r.to_numpy(), s.to_numpy(), s.assume_sorted


def engine_route(algo: str, cfg: JoinConfig, probing: bool) -> bool:
    """Whether the port's join takes the banded engine (else a scatter
    build, or sortmerge's plain route); JAX then runs with the same
    formulation."""
    s = Relation(torch.zeros(1, dtype=torch.int32)) if probing else None
    if algo in ("nocc", "atomic"):
        return common.route_unique_pallas(cfg, s)
    if algo == "htm":
        return common.use_pallas_engine(cfg, s) or (
            not probing and common.use_pallas_engine_build(cfg))
    if algo == "npo_st":
        return False
    return common.use_pallas_engine(cfg, s)


def run_join(algo, dist, probing, **changes):
    rk, sk, s_sorted = relations(dist, probing)
    cfg = JoinConfig(algo=Algo(algo), r_size=N, seed=11,
                     enable_probe=probing, **{**ALL_DISTS[dist], **changes})
    engine = engine_route(algo, cfg, probing)
    r = Relation(keys_from_numpy(rk))
    s = Relation(keys_from_numpy(sk), assume_sorted=s_sorted)
    jr = JRelation(jnp.asarray(rk))
    js = JRelation(jnp.asarray(sk), assume_sorted=s_sorted)
    got = DISPATCH[algo](r, s if probing else None, cfg).to_dict()
    want = JDISPATCH[algo](jr, js if probing else None,
                           jax_cfg(cfg, "pallas" if engine else "xla")
                           ).to_dict()
    return got, want, rk, sk, engine


def assert_join_line(algo, got, want, rk, sk, probing, engine):
    assert set(got) == set(want) | PORT_ONLY_FIELDS
    for key in EQUAL:
        assert got.get(key) == want.get(key), key
    assert (got.get("backend") == "pallas_banded") == engine
    in_sum = int(rk.astype(np.int64).sum())
    assert got["inputSum"] == in_sum
    exact = reference_match_count(rk, sk) if probing else None
    if algo == "nocc":
        assert got["outputSum"] <= in_sum
        if probing:
            assert got["totalMatches"] <= exact
    else:
        assert got["outputSum"] == in_sum
        assert got.get("totalMatches") == exact


JOIN_ALGOS = ["nocc", "atomic", "htm", "npo", "npo_st", "sortmerge"]


@pytest.mark.parametrize("dist", list(DISTS))
@pytest.mark.parametrize("algo", JOIN_ALGOS)
def test_join_matches_jax_probing(algo, dist):
    got, want, rk, sk, engine = run_join(algo, dist, True)
    assert_join_line(algo, got, want, rk, sk, True, engine)


@pytest.mark.parametrize("dist", ["shuffle", "uniform", "zipf", "random"])
@pytest.mark.parametrize("algo", JOIN_ALGOS)
def test_join_matches_jax_build_only(algo, dist):
    got, want, rk, sk, engine = run_join(algo, dist, False)
    assert_join_line(algo, got, want, rk, sk, False, engine)


@pytest.mark.parametrize("dist", ["sorted", "uniform", "random"])
@pytest.mark.parametrize("algo", ["nocc", "atomic", "htm", "npo",
                                  "sortmerge"])
def test_xla_backend_matches_jax(algo, dist):
    """``--backend xla``: every join takes its scatter build (sortmerge its
    plain route) on every distribution."""
    got, want, rk, sk, engine = run_join(algo, dist, True, backend="xla")
    assert not engine and "backend" not in got
    assert_join_line(algo, got, want, rk, sk, True, engine)


@pytest.mark.parametrize("fields", [
    dict(track=True, adaptive=True), dict(retry=False, track=True),
    dict(adaptive=True, transaction_size=1)], ids=str)
@pytest.mark.parametrize("dist", ["shuffle", "uniform", "random"])
def test_htm_scatter_track_and_dial_match_jax(dist, fields):
    """TM_TRACK's fractions and causes and HTM_ADAPT's replayed tSize on the
    scatter build, with and without TM_RETRY."""
    got, want, rk, sk, engine = run_join("htm", dist, True, backend="xla",
                                         **fields)
    assert_join_line("htm", got, want, rk, sk, True, engine)
    if fields.get("track"):
        assert got["failureCauseDuplicateAlias"] == got["failedTransactions"]
        assert len(got["chunkFailureFractions"]) == 1


@pytest.mark.parametrize("dist", ["uniform", "random"])
def test_nocc_loses_tuples_as_jax_does(dist):
    """On duplicates nocc loses tuples by design, and on full-range keys
    its races lose some too: the same ones as JAX's, by the same winner."""
    got, want, rk, sk, _ = run_join("nocc", dist, True)
    assert got["outputSum"] == want["outputSum"] < got["inputSum"]
    assert got["totalMatches"] == want["totalMatches"] < \
        reference_match_count(rk, sk)


@pytest.mark.parametrize("algo", ["atomic", "nocc"])
def test_unique_builds_spill_nothing_under_a_skewed_s(algo):
    """atomic and nocc on unique R take the banded engine; tiles that a
    skewed S flags in its count are no spill of their table: the line is
    JAX's, conflicts 0."""
    got, want, rk, sk, engine = run_join(algo, "pk_zipf", True)
    flagged = banded_join_pipelined(keys_from_numpy(rk), keys_from_numpy(sk),
                                    sort_s=True).overflow_tiles
    assert engine and flagged > 0
    assert got["conflicts"] == want["conflicts"] == 0
    assert_join_line(algo, got, want, rk, sk, True, engine)


def test_sortmerge_reports_sort_and_merge_apart():
    for dist in ("shuffle", "random"):
        got, _, _, _, engine = run_join("sortmerge", dist, True)
        assert got["sortTimeInMicroseconds"] > 0
        assert got["probeTimeInMicroseconds"] == \
            got["mergeTimeInMicroseconds"] > 0
        if engine:
            assert got["hashBuildTimeInMicroseconds"] == \
                got["sortTimeInMicroseconds"] + got["mergeTimeInMicroseconds"]
