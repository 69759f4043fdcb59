"""The federated logreg problems (`logreg`), the host-side RR sampler
(`reshuffle`, a copy of the reference's), the batch and cohort streams and
the epoch loop (`pipeline`) and the out-of-core client data (`paging`)."""
