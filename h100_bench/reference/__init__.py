"""The plain reference the benchmark holds the port's outputs against.

Plain PyTorch only: it imports nothing of the port, nor JAX, and takes
nothing the port derived (it quantizes the weights and the index itself
and tokenizes the requests' text itself)."""
