"""Distributed training pieces of the port; so far only the remat
policies (``remat.py``) that the train step wraps each repeat in."""
