"""Compression operators (`ops`) and the dispatch to the CUDA kernels or
their plain versions (`backend`)."""
