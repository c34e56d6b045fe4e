"""The benchmark's harness: the traffic generator, the driver of the port,
the trace readings and the output check."""
