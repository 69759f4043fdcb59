"""The federated logreg problems (`logreg`), the host-side RR sampler
(`reshuffle`, a copy of the reference's) and the epoch loop
(`pipeline`)."""
