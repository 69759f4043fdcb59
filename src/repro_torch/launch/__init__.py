"""The train, prefill and serve steps (`steps`), their virtual client mesh
(`mesh`) and the front ends: the production trainer (`train`) and the
server (`serve`)."""
