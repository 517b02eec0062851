"""Parallel layouts (counterpart of multimodalrouting_tpu/parallel/): so far
the pipeline-parallel BERT layout on one card (``pp.py``)."""
