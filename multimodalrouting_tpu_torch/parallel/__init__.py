"""Parallel layouts (counterpart of multimodalrouting_tpu/parallel/): the
process mesh for data parallelism with the 'model' axis's four roles
(``distributed.py``, ``mesh.py``): the note chunks sharded over it, Megatron
tensor parallelism of the BERT layers (``tp.py``), route parallelism of the
MulT cross streams (``ep.py``) or the BERT layers as GPipe stages
(``pp.py``, whose stacked layout also runs on one card); ZeRO-1
(``zero.py``)."""
