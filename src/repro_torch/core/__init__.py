"""The PSO engine in PyTorch: config, state, RNG, objectives, rules."""
