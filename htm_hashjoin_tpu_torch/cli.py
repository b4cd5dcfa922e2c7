"""CLI driver: the main.cpp / mc/src/main.c equivalent, on PyTorch.

Counterpart of ``htm_hashjoin_tpu/cli.py``, flag for flag: reference
main.cpp:43-71 (defaults main.cpp:78-85) plus the mc getopt_long flags
(mc/src/main.c:492-608).  One JSON line per run on stdout, the reference's
schema (HTMHashBuild.hpp:417-449).  The relations are made on a CUDA
device; ``main(argv, device=torch.device("cpu"))`` runs the kernels' plain
versions instead (the tests do).

Not ported yet, and refused with ``NotImplementedError``: ``--meshShape``
(ROADMAP queue 1 item 10), ``--profile``, ``--counters`` and
``--throughput`` (item 9), and the algorithms other than htm, radix and
adaptive (item 7).

Usage:
    python -m htm_hashjoin_tpu_torch.cli --algo htm --rSize $((2**20)) --dataDistr local_shuffle
"""

from __future__ import annotations

import argparse
import sys

import torch

from .config import Algo, Distribution, JoinConfig
from .data.generators import build_relations
from .joins import DISPATCH


# mc driver algorithm names (mc/src/main.c:292-301; RJ/PRH/PRHO alias PRO
# in the reference fork) accepted alongside ours
MC_ALGO_ALIASES = {"PRO": "radix", "RJ": "radix", "PRH": "radix",
                   "PRHO": "radix", "NPO": "npo", "NPO_st": "npo_st"}


def parse_args(argv=None):
    """Returns (JoinConfig, (profile_dir, want_throughput, counters))."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--algo", default="htm",
                   choices=[a.value for a in Algo] + sorted(MC_ALGO_ALIASES),
                   type=lambda v: MC_ALGO_ALIASES.get(v, v))
    p.add_argument("--rSize", type=int, default=1 << 20)
    p.add_argument("--sSize", type=int, default=None)
    p.add_argument("--transactionSize", type=int, default=16)
    p.add_argument("--probeLength", type=int, default=4)  # NB: reference main.cpp:53-54 bug (wrote dataDistr) not replicated
    p.add_argument("--dataDistr", default="sorted",
                   choices=[d.value for d in Distribution])
    p.add_argument("--shuffleRange", type=int, default=16)
    p.add_argument("--scaleOutput", type=int, default=2)
    p.add_argument("--numPartitions", type=int, default=None)
    p.add_argument("--distinctKeys", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--zipfParam", type=float, default=0.75)
    p.add_argument("--radixBits", type=int, default=14)
    p.add_argument("--radixPasses", type=int, default=2)
    p.add_argument("--noProbe", action="store_true",
                   help="build-only (ENABLE_PROBE off)")
    p.add_argument("--noRetry", action="store_true",
                   help="skip failed-insert repair (noretry binary variant)")
    p.add_argument("--track", action="store_true",
                   help="per-chunk failure histograms (TM_TRACK)")
    p.add_argument("--adaptive", action="store_true",
                   help="adaptive chunk-size stats (HTM_ADAPTIVE)")
    p.add_argument("--switchSniff", action="store_true",
                   help="HTM_SWITCH locality pre-pass: sniff, report "
                        "firstRoundFailureFraction, switch htm→radix when "
                        "locality is absent (HTMHashBuild.hpp:100-154)")
    p.add_argument("--skewHandling", action="store_true")
    p.add_argument("--meshShape", type=str, default="",
                   help="comma-separated mesh, e.g. '8' for 8-way data parallel")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "xla", "pallas"],
                   help="kernel backend (auto = banded Pallas engine on TPU "
                        "when the plan qualifies)")
    # mc getopt_long compatibility surface (mc/src/main.c:492-608): the mc
    # driver's flags are accepted verbatim and mapped onto the unified config
    mc = p.add_argument_group("mc driver compatibility")
    mc.add_argument("-n", "--nthreads", type=int, default=None,
                    help="mc worker count → static partition count (the TPU "
                         "analog of per-thread ranges; XLA parallelizes "
                         "within the chip)")
    mc.add_argument("-r", "--r-size", dest="rSizeMc", type=int, default=None)
    mc.add_argument("-s", "--s-size", dest="sSizeMc", type=int, default=None)
    mc.add_argument("-x", "--r-seed", dest="rSeed", type=int, default=None)
    mc.add_argument("-y", "--s-seed", dest="sSeed", type=int, default=None)
    mc.add_argument("-z", "--skew", dest="zipfSkew", type=float, default=None,
                    help="zipf-distributed probe side with this theta "
                         "(mc/src/main.c:393-412)")
    mc.add_argument("--non-unique", action="store_true",
                    help="build side drawn with duplicates (generator.c:493)")
    mc.add_argument("--full-range", action="store_true",
                    help="build side drawn from the full int range "
                         "(mc/src/main.c:368-380)")
    mc.add_argument("-l", "--local-shuffle-range", dest="lShuffle", type=int,
                    default=None,
                    help="build side pk_lshuffle with this window "
                         "(generator.c:262-282)")
    mc.add_argument("--basic-numa", action="store_true",
                    help="accepted for parity; placement on TPU follows the "
                         "device-mapping file / mesh (SURVEY.md §2.4 P12)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler trace of the run (the PCM "
                        "dump analog, SURVEY.md §5)")
    p.add_argument("--counters", nargs="?", const="default", default=None,
                   metavar="CFG",
                   help="per-phase PCM-analog counter dumps in the JSON "
                        "line (--enable-perfcounters + pcm.cfg analog, "
                        "mc/src/no_partitioning_join.c:458-527): events "
                        "from a name=key config file, or the default "
                        "flops/bytes/intensity/bandwidth set")
    p.add_argument("--throughput", action="store_true",
                   help="also print the ns/tuple report (mc print_timing "
                        "analog, no_partitioning_join.c:313-333)")
    a = p.parse_args(argv)
    # fold the mc flags into the unified surface (mc semantics: R is pk
    # unless --non-unique/--full-range/-l say otherwise; -z makes S zipf)
    if a.rSizeMc is not None:
        a.rSize = a.rSizeMc
    if a.sSizeMc is not None:
        a.sSize = a.sSizeMc
    if a.rSeed is not None:
        a.seed = a.rSeed
    # mc semantics: -n sets the worker count EXACTLY (mc/src/main.c:512-515);
    # an explicit --numPartitions wins, the main.cpp default of 64 applies
    # only when neither flag is given (main.cpp:81)
    if a.numPartitions is None:
        a.numPartitions = a.nthreads if a.nthreads is not None else 64
    mc_used = any(x is not None for x in (a.rSizeMc, a.sSizeMc, a.rSeed,
                                          a.sSeed, a.zipfSkew, a.lShuffle,
                                          a.nthreads)) \
        or a.non_unique or a.full_range or a.basic_numa
    # R,S construction mirrors mc/src/main.c:368-412 exactly:
    #   fullrange : R = nonunique(r, INT_MAX),  S = fk_from_pk
    #   nonunique : R = nonunique(r, r),        S = nonunique(s, maxid=r)
    #   else      : R = pk / pk_lshuffle,       S = zipf if skew>0 else fk
    s_distr = None
    if a.full_range:
        a.dataDistr = "nonunique"
        a.distinctKeys = 2**31 - 2     # INT_MAX alphabet (main.c:369)
        s_distr = Distribution.FK
    elif a.non_unique:
        a.dataDistr = "nonunique"
        s_distr = Distribution.NONUNIQUE  # alphabet anchored to r_size
    elif a.lShuffle is not None:
        a.dataDistr, a.shuffleRange = "pk_lshuffle", a.lShuffle
    elif mc_used and a.dataDistr == "sorted":
        a.dataDistr = "pk"         # mc default R (mc/src/main.c:368-380)
    if s_distr is None and a.dataDistr in ("pk", "pk_lshuffle"):
        if a.zipfSkew is not None and a.zipfSkew > 0:
            a.zipfParam, s_distr = a.zipfSkew, Distribution.ZIPF
        elif mc_used:
            s_distr = Distribution.FK  # incl. -z 0 (main.c:403-411)
    cfg = JoinConfig(
        algo=Algo(a.algo), r_size=a.rSize, s_size=a.sSize,
        transaction_size=a.transactionSize, probe_length=a.probeLength,
        data_distr=Distribution(a.dataDistr), shuffle_range=a.shuffleRange,
        scale_output=a.scaleOutput, num_partitions=a.numPartitions,
        distinct_keys=a.distinctKeys, seed=a.seed, zipf_param=a.zipfParam,
        radix_bits=a.radixBits, radix_passes=a.radixPasses,
        s_seed=a.sSeed, s_distr=s_distr,
        enable_probe=not a.noProbe, retry=not a.noRetry, track=a.track,
        adaptive=a.adaptive, switch_sniff=a.switchSniff,
        skew_handling=a.skewHandling,
        mesh_shape=tuple(int(x) for x in a.meshShape.split(",") if x),
        backend=a.backend,
    )
    return cfg, (a.profile, a.throughput, a.counters)


def _device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("htm_hashjoin_tpu_torch.cli runs on a CUDA device "
                           "and none is available (pass device= to main() "
                           "to run the plain versions on the CPU)")
    return torch.device("cuda")


def main(argv=None, device=None) -> int:
    cfg, (profile_dir, want_throughput, counters) = parse_args(argv)
    if cfg.mesh_shape:
        raise NotImplementedError("--meshShape: the distributed join is not "
                                  "ported yet (ROADMAP queue 1 item 10)")
    for flag, used in (("--profile", profile_dir), ("--counters", counters),
                       ("--throughput", want_throughput)):
        if used:
            raise NotImplementedError(f"{flag}: the profiler is not ported "
                                      f"yet (ROADMAP queue 1 item 9)")
    r, s = build_relations(cfg, _device(device))
    r.fence(), s.fence()   # generation is not part of the timed join phases
    metrics = DISPATCH[cfg.algo.value](r, s, cfg)
    print(metrics.to_json_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
