"""The reference's four examples (`examples/*.py`) on the port, each run
as `python -m repro_torch.examples.<name>`: `quickstart`,
`federated_logreg`, `serve_decode` and `train_lm_diana_rr`. Each runs on
the card unless `--device cpu` names the host."""
