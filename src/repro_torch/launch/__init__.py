"""Launchers of the port: ``train.py``, the training driver."""
