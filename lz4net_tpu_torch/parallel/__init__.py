"""Data-parallel block codec work over ``torch.distributed``.

Port of ``lz4net_tpu/parallel/`` (``distributed.py``, ``mesh.py``,
``pipeline.py``).  Independent blocks shard over a 1-D ``blocks`` axis
of ranks, one process per card: each rank runs the sequencer decoder or
the strict encoder on its contiguous shard, a preset dictionary's window
goes from rank 0 to every rank by one broadcast, byte counts are summed
by an all-reduce, and outputs come back to every rank in block order by
an all-gather.  The group is NCCL on the card and gloo on the CPU.
"""
