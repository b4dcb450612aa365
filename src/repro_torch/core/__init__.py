"""Host-side core of the overlay (own copies of ``repro/core`` modules):
the HR-tree and its chunk hashing, the Sentry, the forwarding decision,
and the S-IDA dispersal (ChaCha20, Rabin IDA, Shamir) that carries every
response."""
