"""Host tools of the port: trace and benchmark post-processing, the experiment harness, scaling, drift and adapt-tick profiles."""
