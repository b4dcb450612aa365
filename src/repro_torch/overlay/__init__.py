"""The overlay on the port: ``ModelNode`` (state sync, forwarding, signed
responses, the real-engine path), the ``Replicator`` (cross-node KV page
migration), the privacy side (``UserNode``: onion proxies and S-IDA
cloves; the ``Registry``; the ``VerificationNode``), ``build_overlay``,
which wires them all on a ``SimNet``, and the probe endpoints that drive
nodes directly."""
