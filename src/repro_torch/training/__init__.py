"""Training-side modules of the port; so far only the KV wire codec that
cross-node page migration uses (``compression.py``)."""
