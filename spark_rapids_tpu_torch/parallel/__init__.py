"""Distributed execution over a mesh of logical devices (port of
``spark_rapids_tpu/parallel``): the mesh runtime (mesh.py) and its
all-to-all hash exchange (exchange.py). The host shuffle (shuffle/) covers
every exchange the mesh does not take."""
