"""Array operations of the port: kernels with their plain versions, metrics."""
