"""Primary keys: 1..N Knuth-shuffled (mc ``generator.c:240-260``,
``random_unique_gen``), the same draw as ``shuffle``."""

from .shuffle import keys  # noqa: F401

SORTED = False
