"""The benchmark harness of the port (``pangea_tpu_torch``): the
benchmark's specification, its worlds and traffic, the system under test,
the measured window, the profiler's window, the roofline count and the
check of the timed path's answers against ``reference``."""
