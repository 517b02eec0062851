"""Data contract and synthetic cohorts of the PyTorch port."""
