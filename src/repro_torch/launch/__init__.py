"""The train, prefill and serve steps (`steps`), their virtual client mesh
(`mesh`), the client ranks spread over processes (`distributed`, with
`sharding` saying which state is per rank) and the front ends: the
production trainer (`train`) and the server (`serve`)."""
