"""Out-of-core streaming data plane: sharded sources, bounded
prefetch, and one-pass partitioning.

Port of ``repro.data.streaming``. Quickstart::

    from repro_torch.data import streaming

    src = streaming.SyntheticSource(n_rows=2_000_000, n_features=18,
                                    shard_rows=65536, seed=0)
    est = ODMEstimator(problem, route="dsvrg", cfg=cfg)
    model, report = est.fit(src)   # never materializes (M, d)

Each slab goes to the estimator's device (the card by default).
"""
from repro_torch.data.streaming.loader import (ByteAccountant,
                                               PrefetchLoader,
                                               SerialExecutor, Slab,
                                               iter_slabs)
from repro_torch.data.streaming.plan import (StreamingAssigner,
                                             StreamingPlan,
                                             assign_strata_values,
                                             reservoir_sample,
                                             sketch_landmarks,
                                             streaming_plan)
from repro_torch.data.streaming.sources import (ArraySource,
                                                NpyShardSource,
                                                RawBinarySource,
                                                ShardedSource,
                                                SyntheticSource, is_source,
                                                materialize)

__all__ = [
    "ShardedSource", "ArraySource", "NpyShardSource", "RawBinarySource",
    "SyntheticSource", "is_source", "materialize",
    "PrefetchLoader", "SerialExecutor", "ByteAccountant", "Slab",
    "iter_slabs",
    "reservoir_sample", "sketch_landmarks", "assign_strata_values",
    "StreamingAssigner", "StreamingPlan", "streaming_plan",
]
