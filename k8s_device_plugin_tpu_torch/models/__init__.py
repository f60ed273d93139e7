"""The llm-serve workload in PyTorch: the decoder LM, its serving engine,
the continuous batcher and the HTTP daemon."""
