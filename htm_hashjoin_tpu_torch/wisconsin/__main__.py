"""CLI: ``python -m htm_hashjoin_tpu_torch.wisconsin <conf file>
[--write-output]`` — the multijoin binary equivalent
(mc/wisconsin-src/main.cpp:169), on the CUDA device; one JSON line, the
keys of the JAX package's line."""

import sys

from .driver import run_multijoin


def main(argv=None, device=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: python -m htm_hashjoin_tpu_torch.wisconsin <conf> "
              "[--write-output]", file=sys.stderr)
        return 2
    write = "--write-output" in argv
    res = run_multijoin(argv[0], write_output=write, device=device)
    print(res.to_json_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
