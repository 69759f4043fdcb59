"""Paper Figure 1 reproduction: all four proposed methods vs all baselines
on heterogeneous federated logistic regression, with the paper's tuning
protocol (theory stepsize x tuned multiplier) and honest uplink-bit
accounting (port of `examples/federated_logreg.py`).

    PYTHONPATH=src python -m repro_torch.examples.federated_logreg \\
        [--epochs 800] [--quick] [--device cpu]

Prints one CSV row per method: final suboptimality and bits uplinked, the
two axes of the paper's plots. Expected ordering (paper Sec. 3):
  exp1:  diana_rr << diana < qsgd ~ q_rr
  exp2:  diana_nastya << q_nastya ~ fedcom ~ fedpaq
"""
from __future__ import annotations

import argparse

from repro_torch.experiments import (
    communication_table,
    experiment1,
    experiment2,
)


def main(argv=None) -> list[tuple]:
    """Prints and returns the rows of experiments 1-2 and the bits table."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=800)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rows = []
    rows += experiment1(epochs=args.epochs, quick=args.quick,
                        device=args.device)
    rows += experiment2(epochs=args.epochs, quick=args.quick,
                        device=args.device)
    rows += communication_table(epochs=min(args.epochs, 400),
                                device=args.device)
    print("name,us_per_epoch_or_bits,final_suboptimality")
    for r in rows:
        print(",".join(str(x) for x in r))
    return rows


if __name__ == "__main__":
    main()
