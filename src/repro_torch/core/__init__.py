"""The simulator's core: state and tree helpers (`api`), the shift rules
(`rules`) and the fourteen federated methods (`algorithms`)."""
