"""The simulator's core: state and tree helpers (`api`), the shift rules
(`rules`), the fourteen federated methods (`algorithms`) and the RNG salt
registry (`salts`)."""
