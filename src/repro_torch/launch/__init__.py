"""Step functions, the serving loop, the trainer and the smoke-batch helper
of the LM substrate."""
