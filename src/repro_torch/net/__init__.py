"""The overlay's transport: the discrete-event ``SimNet`` and the wire
codec (``wire.packb`` / ``wire.unpackb``, byte-identical to msgpack)."""
