"""The distributed join of the port (counterpart of
``htm_hashjoin_tpu/parallel/``): a mesh of shards (``mesh``), collectives
over per-shard lists of tensors (``collectives``), the sharded repartition
join with its skew plan and repair round (``dist_join``), the scaling
harness (``scaling``) and the multi-device dry run (``dryrun``)."""
