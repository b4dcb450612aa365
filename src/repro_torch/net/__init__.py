"""The overlay's transport: the discrete-event ``SimNet`` and its
``ChurnProcess``, the localhost ``TcpNet``, the message schema and framing
(``messages``), and the wire codec (``wire.packb`` / ``wire.unpackb``,
byte-identical to msgpack)."""
