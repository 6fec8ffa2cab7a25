"""Step functions, the serving loop and the smoke-batch helper of the LM
substrate."""
