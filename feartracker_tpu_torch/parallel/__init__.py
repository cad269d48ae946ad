"""Data parallelism and stream sharding, the counterpart of
``feartracker_tpu/parallel/``: one process a card joined by
``torch.distributed`` (:mod:`.multihost`), the device lists and batch shares
(:mod:`.mesh`), and ``ShardedScanTracker`` (:mod:`.inference`)."""
