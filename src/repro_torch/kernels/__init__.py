"""Hand-written CUDA kernels of the port, their plain versions and the ops that dispatch between them by tensor device."""
