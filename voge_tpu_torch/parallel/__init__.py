"""Chunked execution (counterpart of ``voge_tpu.parallel``):
:mod:`voge_tpu_torch.parallel.batchify`, the reference's ``Batchifier``
(``Utils.py:80-176``).  ``voge_tpu``'s multi-chip sharding (``shard.py``,
``DataParallelBatchifier``) is not ported."""

from voge_tpu_torch.parallel.batchify import Batchifier, batchify  # noqa: F401
