"""Programmatic conf-family generator — the reference's m4 template system.

Reference: mc/wisconsin-src/conf/gen/{gen.sh,template.m4,template.radix.m4,
template.radixsteal.m4} — a shell loop over threads x algorithm x bucket
exponent x radix passes that macro-expands conf files named
``<buckets:06d>_<algorithm>.conf``.  The derived quantities are the same
ones gen.sh computes: ``skipbits = 24 - e - 1`` and
``pagesize = 1 << (24 - e + 4)`` for bucket count ``1 << e`` over a 2^24-key
alphabet.

Here the templates are one Python function; ``generate_conf_grid`` writes
the same file-name grid, and every emitted file parses with
:func:`htm_hashjoin_tpu_torch.wisconsin.conf.parse_conf` and runs with
:func:`htm_hashjoin_tpu_torch.wisconsin.driver.run_multijoin`.  Copied from
``htm_hashjoin_tpu/wisconsin/confgen.py``: the conf files it writes are the
same, byte for byte.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional

LOG2_ALPHABET = 24  # gen.sh derives skipbits/pagesize from a 16M-key alphabet

_TEMPLATE = """\
# generated by htm_hashjoin_tpu.wisconsin.confgen (conf/gen/gen.sh analog)
path:	"{path}";
bucksize:	1048576;

partitioner:
{{
	build:
	{{
		algorithm:	"{build_algorithm}";
		pagesize:	{pagesize};
		attribute:	1;{build_passes_line}
	}};

	probe:
	{{
		algorithm:	"{algorithm}";
		pagesize:	{pagesize};
		attribute:	1;{passes_line}
	}};

	hash:
	{{
		fn:			"modulo";
		range:		[1, {alphabet}];
		buckets:	{buckets};
		skipbits:	{skipbits};
	}};
}};

build:
{{
	file:	"{build_file}";
	schema:	("long", "long");
	jattr:	1;
	select:	(2);
	generate:	{generate};
	relation-size:	{build_size};
	alphabet-size:	{build_size};
	zipf-param:	0.00;
	seed:	12345;
}};

probe:
{{
	file:	"{probe_file}";
	schema:	("long", "long");
	jattr:	1;
	select:	(2);
	generate:	{generate};
	relation-size:	{probe_size};
	alphabet-size:	{build_size};
	zipf-param:	0.00;
	seed:	54321;
}};

output:	"test.tbl";

hash:
{{
	fn:			"modulo";
	range:		[1, {alphabet}];
	buckets:	{table_buckets};
}};

algorithm:
{{
	copydata:		"yes";
	partitionbuild:	"{partitionbuild}";
	buildpagesize:	32;
	partitionprobe:	"{partitionprobe}";{steal_line}
}};

threads:	{threads};
"""


def render_conf(algorithm: str, buckets_exp: int, threads: int = 8, *,
                passes: Optional[int] = None, steal: bool = False,
                log2_alphabet: int = LOG2_ALPHABET,
                build_size: Optional[int] = None,
                probe_size: Optional[int] = None,
                generate: bool = True, path: str = ".") -> str:
    """Render one conf file with gen.sh's derived parameters.

    ``algorithm`` in {"no", "parallel", "independent", "radix"};
    ``buckets_exp`` is e for ``buckets = 1 << e``.
    """
    e = buckets_exp
    alphabet = 1 << log2_alphabet
    skipbits = max(0, log2_alphabet - e - 1)
    pagesize = 1 << (log2_alphabet - e + 4)
    partitioned = algorithm != "no"
    passes_line = f"\n\t\tpasses:\t\t{passes};" if passes else ""
    # steal = shared (unpartitioned) build + partitioned stolen probe
    # (template.radixsteal.m4: build algorithm "no", partitionbuild "no")
    return _TEMPLATE.format(
        path=path,
        algorithm=algorithm,
        build_algorithm="no" if steal else algorithm,
        pagesize=pagesize,
        passes_line=passes_line,
        build_passes_line="" if steal else passes_line,
        alphabet=alphabet,
        buckets=1 << e,
        skipbits=skipbits,
        build_file="016M_build.tbl",
        probe_file="256M_probe.tbl",
        generate="true" if generate else "false",
        build_size=build_size if build_size is not None else alphabet,
        probe_size=probe_size if probe_size is not None else 16 * alphabet,
        table_buckets=max(2, (build_size or alphabet) // 2),
        partitionbuild="yes" if (partitioned and not steal) else "no",
        partitionprobe="yes" if (partitioned or steal) else "no",
        steal_line=('\n\tsteal:\t\t\t"yes";' if steal else ""),
        threads=threads,
    )


def generate_conf_grid(out_dir: str, *,
                       threads: Iterable[int] = (8,),
                       exponents: Iterable[int] = (4, 6, 8, 9, 10, 11, 12, 13, 15, 17),
                       passes: Iterable[int] = (1, 2),
                       algorithms: Iterable[str] = ("parallel", "independent"),
                       **kw) -> List[str]:
    """Write the full gen.sh grid under ``out_dir/<threads:02d>/``; returns
    the written paths.  File names match the reference's
    ``<buckets:06d>_<algorithm>.conf`` convention."""
    written: List[str] = []
    for t in threads:
        tdir = os.path.join(out_dir, f"{t:02d}")
        os.makedirs(tdir, exist_ok=True)
        for e in exponents:
            for a in algorithms:
                p = os.path.join(tdir, f"{1 << e:06d}_{a}.conf")
                with open(p, "w") as f:
                    f.write(render_conf(a, e, t, **kw))
                written.append(p)
            for np_ in passes:
                p = os.path.join(tdir, f"{1 << e:06d}_radix{np_}.conf")
                with open(p, "w") as f:
                    f.write(render_conf("radix", e, t, passes=np_, **kw))
                written.append(p)
                p = os.path.join(tdir, f"{1 << e:06d}_radix{np_}steal.conf")
                with open(p, "w") as f:
                    f.write(render_conf("radix", e, t, passes=np_, steal=True,
                                        **kw))
                written.append(p)
    return written


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("outDir")
    p.add_argument("--threads", type=int, nargs="+", default=[8])
    p.add_argument("--exponents", type=int, nargs="+",
                   default=[4, 6, 8, 9, 10, 11, 12, 13, 15, 17])
    a = p.parse_args(argv)
    paths = generate_conf_grid(a.outDir, threads=a.threads,
                               exponents=a.exponents)
    print(f"wrote {len(paths)} conf files under {a.outDir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
