"""Routing heads of the PyTorch port."""
