"""Parallel layouts (counterpart of multimodalrouting_tpu/parallel/): the
process mesh for data parallelism with the 'model' axis's three roles
(``distributed.py``, ``mesh.py``): the note chunks sharded over it, Megatron
tensor parallelism of the BERT layers (``tp.py``) or route parallelism of
the MulT cross streams (``ep.py``); ZeRO-1 (``zero.py``); and the
pipeline-parallel BERT layout on one card (``pp.py``)."""
