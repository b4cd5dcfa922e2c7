"""CLI: ``python -m htm_hashjoin_tpu_torch.benchmarks {testbed,simple}
[opts]``, on the card."""

import sys

from . import simple, testbed


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] not in ("testbed", "simple"):
        print("usage: python -m htm_hashjoin_tpu_torch.benchmarks "
              "{testbed,simple} [options]", file=sys.stderr)
        return 2
    mod = testbed if argv[0] == "testbed" else simple
    return mod.main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
