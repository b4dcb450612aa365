"""Host-side core of the overlay (own copies of ``repro/core`` modules):
the HR-tree and its chunk hashing, the Sentry, the forwarding decision;
the anonymity layer (S-IDA over ChaCha20, Rabin IDA and Shamir; onion
establishment; Ed25519 and X25519); the committee's reputation,
consensus and VRF; the log-prob verifier that scores model nodes'
responses (``verification``, on a port ``LM``); and the anonymity
metric."""
from repro_torch.core.verification import (EPS_PROB, VerifierModel,
                                           avg_credibility, credibility,
                                           credibility_batch,
                                           response_logprobs)

__all__ = ["EPS_PROB", "VerifierModel", "avg_credibility", "credibility",
           "credibility_batch", "response_logprobs"]
