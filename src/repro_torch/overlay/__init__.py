"""The overlay's serving path on the port: ``ModelNode`` (state sync,
forwarding, the real-engine path), the ``Replicator`` (cross-node KV page
migration) and the probe endpoints that drive nodes directly."""
