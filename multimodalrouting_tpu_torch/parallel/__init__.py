"""Parallel layouts (counterpart of multimodalrouting_tpu/parallel/): the
process mesh for data parallelism with the note chunks sharded over 'model'
(``distributed.py``, ``mesh.py``), ZeRO-1 (``zero.py``), and the
pipeline-parallel BERT layout on one card (``pp.py``)."""
