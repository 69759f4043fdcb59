"""The model zoo: every family's assembly (`transformer`), its layers
(`layers`, `mixers`, `moe`, `linear_attention`) and the architecture config
(`config`)."""
