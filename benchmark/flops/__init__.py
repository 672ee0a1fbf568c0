"""The benchmark's frozen operation and byte counts (``kernels``) and the
model step's operations (``model``)."""
