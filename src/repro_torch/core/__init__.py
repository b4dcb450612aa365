"""Host-side core of the overlay (own copies of ``repro/core`` modules):
the HR-tree and its chunk hashing, the Sentry, the forwarding decision;
the anonymity layer (S-IDA over ChaCha20, Rabin IDA and Shamir; onion
establishment; Ed25519 and X25519); the committee's reputation,
consensus and VRF; and the anonymity metric."""
