"""JSON-line metrics with the reference's output schema.

Every reference run emits one JSON object on stdout
(HTMHashBuild.hpp:417-449, AtomicHashBuild.hpp:133-152, SortMerge.cpp:50-69;
sample: experiments/overflow_log1:1).  We reproduce the field names verbatim
so experiment grids diff cleanly against the reference logs.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class JoinMetrics:
    """One run's metrics; `to_json_line()` renders the reference schema."""

    algo: str
    rSize: int
    transactionSize: int = 0
    probeLength: int = 0
    hashBuildTimeInMicroseconds: float = 0.0
    probeTimeInMicroseconds: Optional[float] = None
    sortTimeInMicroseconds: Optional[float] = None
    mergeTimeInMicroseconds: Optional[float] = None
    partitionTimeInMicroseconds: Optional[float] = None
    firstRoundTime: Optional[float] = None
    firstRoundFailureFraction: Optional[float] = None
    conflictCount: int = 0
    failedTransactions: int = 0
    failedTransactionPercentage: float = 0.0
    totalFailedPercentage: float = 0.0
    totalMatches: Optional[int] = None
    totalOverflows: Optional[int] = None
    inputSum: int = 0
    outputSum: int = 0
    extra: Dict[str, Any] = field(default_factory=dict)

    # Fields the nocc/atomic reference binaries never print — their JSON is
    # just algo/rSize/probeLength/time/conflicts/[matches]/sums
    # (NoCCHashBuild.hpp:127-146, AtomicHashBuild.hpp:133-152); emitting the
    # HTM-only fields there would make the schema a superset.
    _HTM_ONLY_FIELDS = frozenset({
        "transactionSize", "failedTransactions",
        "failedTransactionPercentage", "totalFailedPercentage",
    })

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self.__dict__.items():
            if k == "extra" or v is None:
                continue
            if self.algo in ("nocc", "atomic") and k in self._HTM_ONLY_FIELDS:
                continue
            # atomic/nocc name their spill count "conflicts"
            # (AtomicHashBuild.hpp:143, NoCCHashBuild.hpp:137); htm says
            # "conflictCount" (HTMHashBuild.hpp:437)
            if k == "conflictCount" and self.algo in ("nocc", "atomic"):
                k = "conflicts"
            out[k] = v
        out.update(self.extra)
        return out

    def to_json_line(self) -> str:
        return json.dumps(self.to_dict())

    @property
    def conserved(self) -> bool:
        """The inputSum == outputSum invariant (HTMHashBuild.hpp:446-448)."""
        return self.inputSum == self.outputSum
