"""Plain PyTorch references of the configurations' models: no kernel,
cache or batching, and nothing of the program."""
