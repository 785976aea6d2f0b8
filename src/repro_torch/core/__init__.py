"""Protocol core of the port: connectivity (numpy), the Algorithm-1
transitions over device tensors, eq.-4 aggregation and the schedulers."""
